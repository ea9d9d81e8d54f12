"""The block-Jacobi apply: the CUDA C++ kernel `csrc/block_jacobi.cu` and its
plain PyTorch twin.

Counterpart: the apply of ogl_tpu/precond/jacobi.py `block_jacobi` (an XLA
einsum over the (nb, bs, bs) inverses; no TPU kernel).  The port stores
each inverse transposed, inv_t[b, k, i] = inv[b, i, k], so the kernel's
loads coalesce; `block_jacobi_plain` adds the products in k order from 0,
each rounded, as the kernel does, so the two give the same bits.

`block_jacobi(inv_t, r)` launches the kernel for CUDA tensors and runs the
twin only for tensors on the CPU; on a CUDA tensor it never falls back.  The
kernel's body (`csrc/block_jacobi.cuh`) is also the two preconditioner
phases of the general-BiCGStab loop's block-Jacobi variants
(`csrc/bicgstab_gen_loop.cuh`, the plans' `bicgstab_gen_loop(..., inv_t=)`).
"""

from __future__ import annotations

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["block_jacobi", "block_jacobi_plain", "check_inverses", "MAX_BLOCK", "THREADS",
           "BLOCKS_PER_SM"]

MAX_BLOCK = 32  # the kernel stages a CUDA block's r in 256 floats: bs <= 32
THREADS = 256
BLOCKS_PER_SM = 16  # grid cap: one tile per block up to about 0.5M rows


def block_jacobi_plain(inv_t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y[b·bs + i] = Σ_k inv_t[b, k, i] · r[b·bs + k], in k order from 0,
    every product and sum rounded (r padded with zeros to nb·bs rows)."""
    nb, bs = inv_t.shape[0], inv_t.shape[1]
    n = r.shape[0]
    rp = torch.nn.functional.pad(r, (0, nb * bs - n)).view(nb, bs)
    y = torch.zeros((nb, bs), dtype=r.dtype, device=r.device)
    for k in range(bs):
        y = y + inv_t[:, k, :] * rp[:, k:k + 1]
    return y.reshape(-1)[:n]


def check_inverses(inv_t: torch.Tensor, r: torch.Tensor) -> None:
    """Raise unless inv_t is a contiguous float32 (ceil(n / bs), bs, bs) tensor,
    bs from 2 to MAX_BLOCK, for the contiguous float32 (n,) vector r on its
    device."""
    if inv_t.dim() != 3 or inv_t.shape[1] != inv_t.shape[2]:
        raise ValueError(f"inv_t has shape {tuple(inv_t.shape)}, expected (nb, bs, bs)")
    nb, bs = inv_t.shape[0], inv_t.shape[1]
    if not 2 <= bs <= MAX_BLOCK:
        raise ValueError(f"block size {bs}: the kernel takes 2 to {MAX_BLOCK}")
    n = r.shape[0]
    if r.dim() != 1 or nb != -(-n // bs):
        raise ValueError(f"r has shape {tuple(r.shape)}; {nb} blocks of {bs} need "
                         f"{(nb - 1) * bs + 1}..{nb * bs} rows")
    for name, t in (("inv_t", inv_t), ("r", r)):
        if t.device != inv_t.device:
            raise ValueError(f"{name} is on {t.device}, inv_t on {inv_t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def block_jacobi(inv_t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y = M⁻¹ r for the block-Jacobi inverses inv_t (nb, bs, bs), stored
    transposed within each block."""
    if on_cpu(inv_t, r):
        return block_jacobi_plain(inv_t, r)
    require_cuda("block_jacobi", r)
    check_inverses(inv_t, r)
    n, bs = r.shape[0], inv_t.shape[1]
    y = torch.empty_like(r)
    if n == 0:
        return y
    per = (THREADS // bs) * bs
    blocks = max(min(-(-inv_t.shape[0] * bs // per), BLOCKS_PER_SM * sm_count(r.device.index)),
                 1)
    lib = _build.library()
    _build.check(lib.ogl_block_jacobi(inv_t.data_ptr(), r.data_ptr(), y.data_ptr(), n, bs,
                                      blocks, stream_of(r)), "block_jacobi")
    kernels.launches["block_jacobi"] += 1
    return y
