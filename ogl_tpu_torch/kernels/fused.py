"""Merged-CG kernels for the Dia (stencil) path: K1 in CUDA C++
(`csrc/cg_k1.cu`), K2 and K2i in Triton (bodies below), each beside its
plain PyTorch twin.

Counterpart: ogl_tpu/kernels/fused.py (`CgKernels.k1`/`k2`/`k2i`/`apply`/
`pack_values`, kernels `_k1_kernel`, `_k2_kernel`, `_k2i_kernel`).  Two
kernels per CG iteration:

  K1   p' = z + β·p ;  q = A p' ;  δ = Σ p'·q
  K2   x' = x + α·p' ;  r' = r − α·q ;  z' = invd ⊙ r' ;  ρ' = Σ r'·z' ;
       s = Σ|r'|          (the residual 1-norm of the criterion comes free)
  K2i  K2 for identity preconditioning (z ≡ r): no z write, no invd read,
       ρ' = Σ r'·r'

Layout: flat (n,) float32 vectors and a contiguous (nd, n) Dia data
tensor.  The reference's halo-framed (Rp + 2T, 128) layout exists for the
TPU's (8, 128) tiling and static DMA windows; the port has no frame, so
`frame`/`unframe` are dropped and every kernel masks i + off to [0, n)
itself.  Cross-block sums are one float32 partial per block, summed with
torch.sum outside the kernel — deterministic, no float atomics.

α and β are 0-d float32 tensors on the device: the kernels read them
through a pointer, so a launch never waits for the host.  K2/K2i update
x, r (and z) IN PLACE: every element is read and written by the same
program, so there is no race; the plain versions do the same.

Dispatch, the same for every wrapper: tensors on the CPU run the plain
version; CUDA tensors launch the kernel or raise (wrong device, dtype,
shape, contiguity, or a refused launch) — there is no fallback.  Each
launch counts in `ogl_tpu_torch.kernels.launches`.

K2/K2i (Triton) replace ogl_tpu/kernels/fused.py `_k2_kernel` and
`_k2i_kernel`.  They are pure elementwise streams with two block sums, no
neighbour reads and no index tables — the case where Triton writes the
same kernel as CUDA C++ with less code.  Bound: device-memory bandwidth,
8 float32 streams per row for K2 (x, r, p, q, invd in; x, r, z out) and 6
for K2i, at a handful of flops each.  Design: one program per BLOCK rows,
masked coalesced loads/stores, tl.sum per program into a partials array.
"""

from __future__ import annotations

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import (THREADS, DiaPlan, check_operands,
                                            dia_spmv_plain, stream_of)

__all__ = ["CgKernels", "k1_plain", "k2_plain", "k2i_plain"]

K2_BLOCK = 1024  # rows per Triton program (power of two, tl.constexpr)
K2_WARPS = 4

# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def k1_plain(data, offsets, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p', δ = Σ p'·q."""
    pw = z + beta * p
    q = dia_spmv_plain(data, offsets, pw)
    return pw, q, torch.sum(pw * q)


def k2_plain(alpha, x, r, p, q, invd, z):
    """In place: x += α·p, r −= α·q, z = invd ⊙ r; returns (ρ, ‖r‖₁)."""
    x += alpha * p
    r -= alpha * q
    torch.mul(invd, r, out=z)
    return torch.sum(r * z), torch.sum(torch.abs(r))


def k2i_plain(alpha, x, r, p, q):
    """In place: x += α·p, r −= α·q; returns (ρ = Σ r·r, ‖r‖₁)."""
    x += alpha * p
    r -= alpha * q
    return torch.sum(r * r), torch.sum(torch.abs(r))


# ---- Triton bodies (compiled on the first CUDA launch) ------------------
# `tl` is bound to triton.language by _triton_kernels(), which imports
# triton only when a CUDA tensor reaches a wrapper: this module must import
# on hosts without triton.  The string annotations keep BLOCK a constexpr
# without evaluating `tl` at import.

tl = None
_TRITON: dict = {}


def _k2_body(alpha_ptr, x_ptr, r_ptr, p_ptr, q_ptr, invd_ptr, z_ptr,
             rho_ptr, absr_ptr, n, BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    alpha = tl.load(alpha_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    r = tl.load(r_ptr + offs, mask=mask, other=0.0)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    q = tl.load(q_ptr + offs, mask=mask, other=0.0)
    invd = tl.load(invd_ptr + offs, mask=mask, other=0.0)
    xo = x + alpha * p
    ro = r - alpha * q
    zo = invd * ro
    tl.store(x_ptr + offs, xo, mask=mask)
    tl.store(r_ptr + offs, ro, mask=mask)
    tl.store(z_ptr + offs, zo, mask=mask)
    tl.store(rho_ptr + pid, tl.sum(ro * zo, axis=0))
    tl.store(absr_ptr + pid, tl.sum(tl.abs(ro), axis=0))


def _k2i_body(alpha_ptr, x_ptr, r_ptr, p_ptr, q_ptr,
              rho_ptr, absr_ptr, n, BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    alpha = tl.load(alpha_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    r = tl.load(r_ptr + offs, mask=mask, other=0.0)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    q = tl.load(q_ptr + offs, mask=mask, other=0.0)
    xo = x + alpha * p
    ro = r - alpha * q
    tl.store(x_ptr + offs, xo, mask=mask)
    tl.store(r_ptr + offs, ro, mask=mask)
    tl.store(rho_ptr + pid, tl.sum(ro * ro, axis=0))
    tl.store(absr_ptr + pid, tl.sum(tl.abs(ro), axis=0))


def _triton_kernels() -> dict:
    global tl
    if not _TRITON:
        import triton
        import triton.language

        tl = triton.language
        _TRITON.update(k2=triton.jit(_k2_body), k2i=triton.jit(_k2i_body))
    return _TRITON


def _check_scalar(name: str, s, device: torch.device) -> None:
    if not (isinstance(s, torch.Tensor) and s.dim() == 0
            and s.dtype == torch.float32 and s.device == device):
        raise TypeError(f"{name} must be a 0-d float32 tensor on {device}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if isinstance(t, torch.Tensor))


def _require_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")


class CgKernels:
    """Merged-CG steps for one Dia sparsity on one device.

    Holds only static structure (the DiaPlan: n, offsets, device offsets),
    so one object serves every coefficient update; the values travel as
    the `data` argument.  Vectors are flat (n,) — the reference's
    `frame`/`unframe` are dropped."""

    def __init__(self, n: int, offsets, device: torch.device | str):
        self.plan = DiaPlan(n, offsets, device)
        self.n = self.plan.n
        self.offsets = self.plan.offsets
        self.device = self.plan.device
        self.dtype = torch.float32
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)

    def pack_values(self, mat) -> torch.Tensor:
        """The Dia data as the kernels take it: contiguous (nd, n) float32."""
        if tuple(mat.offsets) != self.offsets:
            raise ValueError("matrix offsets do not match this plan")
        return mat.data.to(self.dtype).contiguous()

    # ---- K1 (CUDA C++) -------------------------------------------------
    def k1(self, data, z, p, beta):
        """(p', q, δ) — p' and q in new buffers, δ a 0-d tensor."""
        if _on_cpu(data, z, p, beta):
            return k1_plain(data, self.offsets, z, p, beta)
        _require_cuda("k1", z)
        check_operands(self.plan, data, z, p)
        _check_scalar("beta", beta, self.device)
        lib = _build.library()
        pout = torch.empty_like(p)
        q = torch.empty_like(p)
        grid = -(-self.n // THREADS)
        partials = torch.empty(grid, dtype=torch.float32, device=self.device)
        _build.check(lib.ogl_cg_k1(
            data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            z.data_ptr(), p.data_ptr(), beta.data_ptr(), pout.data_ptr(),
            q.data_ptr(), partials.data_ptr(), self.n, THREADS, grid,
            stream_of(z)), "cg_k1")
        kernels.launches["cg_k1"] += 1
        return pout, q, torch.sum(partials)

    def apply(self, data, x):
        """Plain y = A x through K1 (z = p = x, β = 0)."""
        _, q, _ = self.k1(data, x, x, self._zero)
        return q

    # ---- K2 / K2i (Triton) ---------------------------------------------
    def k2(self, alpha, x, r, p, q, invd, z):
        """In place on x, r, z; returns (ρ, ‖r‖₁) as 0-d tensors."""
        if _on_cpu(alpha, x, r, p, q, invd, z):
            return k2_plain(alpha, x, r, p, q, invd, z)
        return self._launch_k2("k2", alpha, x, r, p, q, invd, z)

    def k2i(self, alpha, x, r, p, q):
        """K2 for identity preconditioning, in place on x and r; returns
        (ρ = Σ r·r, ‖r‖₁) as 0-d tensors."""
        if _on_cpu(alpha, x, r, p, q):
            return k2i_plain(alpha, x, r, p, q)
        return self._launch_k2("k2i", alpha, x, r, p, q)

    def _launch_k2(self, name, alpha, *vectors):
        _require_cuda(name, vectors[0])
        check_operands(self.plan, None, *vectors)
        _check_scalar("alpha", alpha, self.device)
        kern = _triton_kernels()[name]
        grid = -(-self.n // K2_BLOCK)
        rho = torch.empty(grid, dtype=torch.float32, device=self.device)
        absr = torch.empty(grid, dtype=torch.float32, device=self.device)
        kern[(grid,)](alpha, *vectors, rho, absr, self.n,
                      BLOCK=K2_BLOCK, num_warps=K2_WARPS)
        kernels.launches[f"cg_{name}"] += 1
        return torch.sum(rho), torch.sum(absr)
