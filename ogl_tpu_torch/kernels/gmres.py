"""The GMRES basis kernels: the CUDA C++ kernels of `csrc/gmres.cu` and
their plain PyTorch twins.

Counterpart: the blocked Arnoldi and the basis recombination of
ogl_tpu/solve/gmres.py (`mgs_pass`, `x_at`; XLA ops, no TPU kernel).  The
basis is a (mp, ld) tensor of float32 or bfloat16 rows (`new_basis`: ld a
multiple of 8 entries, so every row starts 16-byte aligned in both types,
as the kernels' bulk copies and quad loads need); every sum is taken in
float32.

  gmres_arnoldi(V, w, j, h)  orthogonalises w = A M⁻¹ v_j against the live
      rows V[0..j] by blocked modified Gram–Schmidt (blocks of 8 rows, the
      reference's order, no re-orthogonalisation), writes h[0..j+1] into the
      device vector h and V[j+1] = w / max(‖w‖, tiny) in the basis type, and
      returns v_{j+1} in float32: the row itself with a float32 basis, else w
      overwritten with it.  One cooperative launch of one CTA per SM
      (`gmres_arnoldi` counter), its shared memory laid out by
      `arnoldi_plan(n, bf16, sms)`.
  gmres_combine(V, y, j)  Σ_{k<j} y_k V_k over the live rows (`gmres_combine`
      counter; j = 0 gives zeros and launches nothing): the body of
      `csrc/gmres_combine.cuh`, one column group of 4 entries per thread,
      its rows' loads issued in pairs, on a grid of the co-resident CTAs
      (`combine_grid`).

On CPU tensors the wrappers run the twins; on a CUDA tensor they launch the
kernel or raise.  The combine kernel is bit-equal to its twin (each product
and sum rounded in k order).  The Arnoldi kernel sums its dots per CUDA
block and then in block order, and forms the subtraction in its own order:
against the twin, h within 1e-4 relative to ‖w‖ and v_{j+1} within 1e-5 of
max(1, max |v|) in float32; a bfloat16 row is the kernel's own v_{j+1}
rounded to nearest even, within one bfloat16 ulp of the twin's row with a
floor of 1e-6 of max |v_{j+1}| (an entry near 0 carries the float32
rounding of the terms it is the difference of).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["BLOCK", "ArnoldiPlan", "arnoldi_plan", "launch_plan", "new_basis", "gmres_arnoldi",
           "gmres_arnoldi_plain", "gmres_combine", "gmres_combine_plain", "combine_grid",
           "ARNOLDI_THREADS"]

BLOCK = 8  # basis rows per block of the blocked MGS (the reference's _BLOCK)
# The Arnoldi launch (csrc/gmres_arnoldi.cuh; these mirror its constants)
ARNOLDI_THREADS = 544  # 16 consumer warps and one producer warp
PIECE_BYTES = 2048  # one basis row's share of a step: every bulk copy
MIN_STAGES, MAX_STAGES = 2, 8  # steps of copies in flight
# the plan holds rows at this depth of copies in flight; more held rows at
# fewer stages measured slower (float32 at 1M: 4 rows at 2 stages against 2
# rows at 4)
HOLD_STAGES = 4
SMEM_FIXED = 1280  # the barriers and the reduction scratch
SMEM_MAX = 232_448  # the dynamic shared memory one CTA can have on Hopper
# rows that are not held are read first with an L2 evict_last policy where
# all of them fit in this share of the 50 MB L2, so their re-read hits it
L2_HOLD_BYTES = 25 << 20
COMBINE_THREADS = 256  # csrc/gmres_combine.cuh kThreads
COMBINE_COLS = 4  # entries of a thread's column group (csrc/gmres_combine.cuh Cols)
TINY = 1e-12  # small_of(float32)², the reference's breakdown guard

_plans: dict = {}
_combine_grids: dict = {}  # (device index, bf16) -> co-resident CTAs of the combine


@dataclasses.dataclass(frozen=True)
class ArnoldiPlan:
    """The layout of one Arnoldi launch: `ctas` CTAs, CTA c owning entries
    [c·slice, (c+1)·slice) ∩ [0, n) and walking them `chunk` entries a step
    (`chunks` steps a pass); the first `resident` rows of each 8-row block
    held in shared memory across the grid barrier; `stages` steps of bulk
    copies in flight; w's slice held for the whole step (`w_resident`); the
    rows not held kept in L2 between their two reads (`hint`); `smem` bytes
    of dynamic shared memory."""
    ctas: int
    slice: int
    chunk: int
    chunks: int
    resident: int
    stages: int
    w_resident: bool
    hint: bool
    smem: int


def _smem(slice_, piece, chunks, resident, stages, w_resident) -> int:
    """csrc/gmres_arnoldi.cuh smem_bytes."""
    return (SMEM_FIXED + (4 * slice_ if w_resident else 0) + (chunks + stages) * resident * piece
            + stages * 2 * (BLOCK - resident) * piece)


def arnoldi_plan(n: int, bf16: bool, sms: int) -> ArnoldiPlan:
    """The Arnoldi launch's layout for n entries, the basis type and `sms`
    SMs: one CTA per SM, slices of ceil(n / sms) entries rounded up to 8 (a
    16-byte aligned start in both types).  w's slice is held if it fits
    beside the fewest stages; then the most rows of a block are held that
    fit at HOLD_STAGES — but only where w is held too: a slice too long for
    w leaves room for a row or two at most, and then walking the chunks
    backwards on odd passes (no row held) serves the re-read from L2 better;
    then the most stages that still fit, up to MAX_STAGES."""
    if n < 1 or sms < 1:
        raise ValueError(f"arnoldi_plan: n {n} and sms {sms} must be positive")
    elem = 2 if bf16 else 4
    piece = PIECE_BYTES
    chunk = piece // elem
    slice_ = -(-(-(-n // sms)) // 8) * 8
    chunks = -(-slice_ // chunk)

    def fits(resident, stages, w_res):
        return _smem(slice_, piece, chunks, resident, stages, w_res) <= SMEM_MAX

    w_res = fits(0, MIN_STAGES, True)
    resident = max((r for r in range(BLOCK + 1) if fits(r, HOLD_STAGES, w_res)), default=0) \
        if w_res else 0
    stages = max(s for s in range(MIN_STAGES, MAX_STAGES + 1) if fits(resident, s, w_res))
    hint = 0 < resident < BLOCK and (BLOCK - resident) * n * elem <= L2_HOLD_BYTES
    return ArnoldiPlan(ctas=sms, slice=slice_, chunk=chunk, chunks=chunks, resident=resident,
                       stages=stages, w_resident=w_res, hint=hint,
                       smem=_smem(slice_, piece, chunks, resident, stages, w_res))


def launch_plan(n: int, bf16: bool, device) -> ArnoldiPlan:
    """arnoldi_plan on `device`'s SMs, cached; checked once against the
    occupancy query with its shared memory (one CTA per SM must be
    co-resident, or the cooperative launch is refused)."""
    index = torch.device(device).index
    key = (n, bool(bf16), index)
    if key not in _plans:
        plan = arnoldi_plan(n, bf16, sm_count(index))
        blocks = ctypes.c_int64()
        with torch.cuda.device(device):
            _build.check(_build.library().ogl_gmres_arnoldi_grid(
                int(bf16), ARNOLDI_THREADS, plan.smem, ctypes.byref(blocks)),
                "gmres_arnoldi (occupancy query)")
        if blocks.value < plan.ctas:
            raise RuntimeError(f"gmres_arnoldi: {blocks.value} co-resident CTAs with "
                               f"{plan.smem} bytes of shared memory; the plan needs {plan.ctas}")
        _plans[key] = plan
    return _plans[key]


def new_basis(m: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of shape (mp, ld): m + 1 rows padded to a multiple of BLOCK,
    rows of n entries padded to a multiple of 8 (every row 16-byte aligned
    in float32 and bfloat16)."""
    mp = -(-(m + 1) // BLOCK) * BLOCK
    ld = -(-n // 8) * 8
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
    per = 16 // V.element_size()
    need = -(-n // 8) * 8  # the last slice's bulk copies run into the padding
    if not V.is_contiguous() or V.shape[1] % per != 0 or V.shape[1] < need:
        raise ValueError(f"V of shape {tuple(V.shape)}: rows of at least {need} entries (n "
                         f"rounded up to 8), a multiple of {per} (each row 16-byte aligned), "
                         "contiguous (new_basis)")
    if V.shape[0] < rows:
        raise ValueError(f"V holds {V.shape[0]} rows; this step needs {rows}")
    if V.data_ptr() % 16 != 0:
        raise ValueError("V is not 16-byte aligned")


def _check_vec(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (n,) \
            or not t.is_contiguous() or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({n},) float32 "
                         f"tensor on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


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
    plan = launch_plan(n, bf16, V.device)
    partials = torch.empty(2 * BLOCK * plan.ctas, dtype=torch.float32, device=V.device)
    vnext = V[j + 1]
    _build.check(_build.library().ogl_gmres_arnoldi(
        int(bf16), V.data_ptr(), V.shape[1], w.data_ptr(), vnext.data_ptr(), h.data_ptr(),
        partials.data_ptr(), n, j, float(tiny), plan.slice, plan.resident, plan.stages,
        int(plan.w_resident), int(plan.hint), plan.ctas, plan.smem, stream_of(w)),
        "gmres_arnoldi")
    kernels.launches["gmres_arnoldi"] += 1
    return w if bf16 else vnext[:n]


def combine_grid(bf16: bool, device) -> int:
    """The co-resident CTAs of the combine kernel (bf16: the basis type) on
    `device`, queried once per device and type: the grid the combine walks
    its column groups with."""
    key = (device.index, bool(bf16))
    if key not in _combine_grids:
        blocks = ctypes.c_int64()
        with torch.cuda.device(device):
            _build.check(_build.library().ogl_gmres_combine_grid(int(bf16), ctypes.byref(blocks)),
                         "gmres_combine (occupancy query)")
        _combine_grids[key] = blocks.value
    return _combine_grids[key]


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
    bf16 = V.dtype == torch.bfloat16
    groups = -(-n // COMBINE_COLS)
    blocks = max(min(-(-groups // COMBINE_THREADS), combine_grid(bf16, V.device)), 1)
    _build.check(_build.library().ogl_gmres_combine(
        int(bf16), V.data_ptr(), V.shape[1], y.data_ptr(), j, out.data_ptr(), n, blocks,
        stream_of(V)), "gmres_combine")
    kernels.launches["gmres_combine"] += 1
    return out
