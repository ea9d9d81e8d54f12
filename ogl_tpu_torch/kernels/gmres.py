"""The GMRES basis kernels: the CUDA C++ kernels of `csrc/gmres.cu` and
their plain PyTorch twins.

Counterpart: the blocked Arnoldi and the basis recombination of
ogl_tpu/solve/gmres.py (`mgs_pass`, `x_at`; XLA ops, no TPU kernel).  The
basis is a (mp, ld) tensor of float32 or bfloat16 rows (`new_basis`: ld a
multiple of 4 entries, so every row starts aligned for the kernels' quad
loads); every sum is taken in float32.

  gmres_arnoldi(V, w, j, h)  orthogonalises w = A M⁻¹ v_j against the live
      rows V[0..j] by blocked modified Gram–Schmidt (blocks of 8 rows, the
      reference's order, no re-orthogonalisation), writes h[0..j+1] into the
      device vector h and V[j+1] = w / max(‖w‖, tiny) in the basis type, and
      returns v_{j+1} in float32: the row itself with a float32 basis, else w
      overwritten with it.  One cooperative launch (`gmres_arnoldi` counter).
  gmres_combine(V, y, j)  Σ_{k<j} y_k V_k over the live rows (`gmres_combine`
      counter; j = 0 gives zeros and launches nothing).

On CPU tensors the wrappers run the twins; on a CUDA tensor they launch the
kernel or raise.  The combine kernel is bit-equal to its twin (each product
and sum rounded in k order).  The Arnoldi kernel sums its dots per CUDA
block and then in block order, and forms the subtraction in its own order:
against the twin, h within 1e-4 relative to ‖w‖ and v_{j+1} within 1e-5 of
max(1, max |v|) in float32 (a bfloat16 row within one bfloat16 ulp).
"""

from __future__ import annotations

import ctypes

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["BLOCK", "new_basis", "gmres_arnoldi", "gmres_arnoldi_plain", "gmres_combine",
           "gmres_combine_plain", "arnoldi_blocks", "ARNOLDI_THREADS", "ARNOLDI_BLOCKS_PER_SM"]

BLOCK = 8  # basis rows per block of the blocked MGS (the reference's _BLOCK)
ARNOLDI_THREADS = 256
# the Arnoldi grid: at most this many co-resident blocks per SM (four, its
# occupancy at 64 registers): the most loads in flight, which a bfloat16
# basis needs; float32 times about the same on fewer
ARNOLDI_BLOCKS_PER_SM = 4
COMBINE_THREADS = 256
COMBINE_BLOCKS_PER_SM = 16
TINY = 1e-12  # small_of(float32)², the reference's breakdown guard

_grids: dict = {}


def new_basis(m: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of shape (mp, ld): m + 1 rows padded to a multiple of BLOCK,
    rows of n entries padded to a multiple of 4."""
    mp = -(-(m + 1) // BLOCK) * BLOCK
    ld = -(-n // 4) * 4
    return torch.zeros((mp, ld), dtype=dtype, device=device)


def gmres_arnoldi_plain(V: torch.Tensor, w: torch.Tensor, j: int, h: torch.Tensor,
                        tiny: float = TINY) -> torch.Tensor:
    """The twin: per block of BLOCK live rows, hb = rows·w (torch.mv), then
    w = w − rowsᵀ hb (torch.addmv); then the norm, the stored row and
    h[j + 1]."""
    n = w.shape[0]
    for k0 in range(0, j + 1, BLOCK):
        rows = V[k0:min(k0 + BLOCK, j + 1), :n].float()
        hb = torch.mv(rows, w)
        w = torch.addmv(w, rows.t(), hb, alpha=-1.0)
        h[k0:k0 + rows.shape[0]] = hb
    wnorm = torch.sqrt(torch.sum(w * w))
    v = w / torch.clamp(wnorm, min=tiny)
    V[j + 1, :n] = v.to(V.dtype)
    h[j + 1] = wnorm
    return v


def gmres_combine_plain(V: torch.Tensor, y: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """acc = Σ_{k<j} y_k V_k, in k order from 0, each product and sum
    rounded in float32."""
    acc = torch.zeros(n, dtype=torch.float32, device=V.device)
    for k in range(j):
        acc = acc + y[k] * V[k, :n].float()
    return acc


def _check_basis(V: torch.Tensor, n: int, rows: int) -> None:
    if V.dim() != 2 or V.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"V must be a 2-d float32 or bfloat16 tensor, got {V.dtype} "
                        f"of shape {tuple(V.shape)}")
    if not V.is_contiguous() or V.shape[1] % 4 != 0 or V.shape[1] < n:
        raise ValueError(f"V of shape {tuple(V.shape)}: rows of at least {n} entries, a "
                         "multiple of 4, contiguous (new_basis)")
    if V.shape[0] < rows:
        raise ValueError(f"V holds {V.shape[0]} rows; this step needs {rows}")
    if V.data_ptr() % 16 != 0:
        raise ValueError("V is not 16-byte aligned")


def _check_vec(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (n,) \
            or not t.is_contiguous() or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({n},) float32 "
                         f"tensor on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def arnoldi_blocks(bf16: bool, device) -> int:
    """The Arnoldi launch's grid on `device`: its co-resident blocks
    (occupancy × SMs, queried once per basis type and device), at most
    ARNOLDI_BLOCKS_PER_SM per SM."""
    key = (bool(bf16), torch.device(device).index)
    if key not in _grids:
        blocks = ctypes.c_int64()
        with torch.cuda.device(device):
            _build.check(_build.library().ogl_gmres_arnoldi_grid(
                int(bf16), ARNOLDI_THREADS, ctypes.byref(blocks)),
                "gmres_arnoldi (occupancy query)")
        _grids[key] = min(blocks.value, ARNOLDI_BLOCKS_PER_SM * sm_count(key[1]))
    return _grids[key]


def gmres_arnoldi(V: torch.Tensor, w: torch.Tensor, j: int, h: torch.Tensor,
                  tiny: float = TINY) -> torch.Tensor:
    """One Arnoldi step's orthogonalisation; returns v_{j+1} in float32."""
    if on_cpu(V, w, h):
        return gmres_arnoldi_plain(V, w, j, h, tiny)
    require_cuda("gmres_arnoldi", w)
    n = w.shape[0]
    _check_basis(V, n, j + 2)
    _check_vec("w", w, n, V.device)
    if h.device != V.device or h.dtype != torch.float32 or h.dim() != 1 \
            or h.shape[0] < j + 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous float32 vector of at least {j + 2} "
                         f"entries on {V.device}")
    bf16 = V.dtype == torch.bfloat16
    blocks = arnoldi_blocks(bf16, V.device)
    partials = torch.empty(2 * BLOCK * blocks, dtype=torch.float32, device=V.device)
    vnext = V[j + 1]
    _build.check(_build.library().ogl_gmres_arnoldi(
        int(bf16), V.data_ptr(), V.shape[1], w.data_ptr(), vnext.data_ptr(), h.data_ptr(),
        partials.data_ptr(), n, j, float(tiny), blocks, stream_of(w)), "gmres_arnoldi")
    kernels.launches["gmres_arnoldi"] += 1
    return w if bf16 else vnext[:n]


def gmres_combine(V: torch.Tensor, y: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """Σ_{k<j} y_k V_k (n,) float32; y a float32 vector of at least j entries."""
    if on_cpu(V, y):
        return gmres_combine_plain(V, y, j, n)
    require_cuda("gmres_combine", V)
    _check_basis(V, n, j)
    if y.device != V.device or y.dtype != torch.float32 or y.dim() != 1 \
            or y.shape[0] < j or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous float32 vector of at least {j} entries "
                         f"on {V.device}")
    out = torch.empty(n, dtype=torch.float32, device=V.device)
    if j == 0:
        return out.zero_()
    quads = -(-n // 4)
    blocks = max(min(-(-quads // COMBINE_THREADS),
                     COMBINE_BLOCKS_PER_SM * sm_count(V.device.index)), 1)
    _build.check(_build.library().ogl_gmres_combine(
        int(V.dtype == torch.bfloat16), V.data_ptr(), V.shape[1], y.data_ptr(), j,
        out.data_ptr(), n, blocks, stream_of(V)), "gmres_combine")
    kernels.launches["gmres_combine"] += 1
    return out
