"""The gather SpMVs of the reference-parity formats: Csr (and the device
Coo, a Csr by its storage), Ell, Sell and Hybrid — each a CUDA C++ kernel (`csrc/csr_spmv.cu`
over `csrc/csr_rows.cuh`, `csrc/ell_spmv.cu` over `csrc/ell_rows.cuh`,
`csrc/sell_spmv.cu`, `csrc/hybrid_spmv.cu`) and its plain PyTorch twin.

Counterpart: ogl_tpu/kernels/spmv.py `spmv_coo`, `spmv_csr`, `spmv_ell`,
`spmv_sell`, `spmv_hybrid` (:33-99).  There they are XLA ops, not Pallas
kernels; here each is a hand-written kernel, as every SpMV on the port's
path is.  torch's own sparse products never run here.

Each twin repeats its kernel's arithmetic step by step — the same products
and sums, each rounded on its own, in the kernel's order — so on the same
inputs the two give the same bits:
  Csr/Coo  lane l of a group of G lanes sums the row's entries l, l + G, ...
           in order; the G partial sums combine in a butterfly (d = G/2,
           ..., 1).  G (`csr_group`) is fixed per matrix from its mean row
           length (G = 1: one thread per row, no butterfly).
  Ell      one row's slots in order (padding included).
  Sell     one slot's lanes in order (padding included).
  Hybrid   the Ell slots in order, then the row's tail entries in order.
The twins add a step's terms with `index_add_`, one term per target per
call, so no sum depends on the order of the call's terms.

Dispatch, as for every wrapper of the port: CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`csr_spmv`, `ell_spmv`, `sell_spmv`,
`hybrid_spmv`).
"""

from __future__ import annotations

import math

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Csr, Ell, Hybrid, Sell, sell_table
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["CSR_GROUP_FROM", "csr_group", "spmv_csr", "spmv_ell", "spmv_sell", "spmv_hybrid",
           "csr_spmv", "ell_spmv", "sell_spmv", "hybrid_spmv", "THREADS", "BLOCKS_PER_SM",
           "SELL_MAX_BUCKETS"]

THREADS = 256  # threads per block of the four kernels
BLOCKS_PER_SM = 64  # grid cap of the grid-stride loops (as the Dia SpMV's)
SELL_MAX_BUCKETS = 64  # csrc/sell_spmv.cu kMaxBuckets: the staged bucket table


CSR_GROUP_FROM = 16  # the mean row length from which the CSR kernel takes G > 1


def csr_group(n: int, nnz: int) -> int:
    """Lanes per row of the CSR kernel: one below CSR_GROUP_FROM entries
    per row on mean (the 7-point stencil, the kNN-6 mesh at 8.1), else about
    four entries per lane, 2^floor(log2(mean row length / 4)) within 4..16.
    Measured on the H100 (chip_smoke.py phase 11 times every group size):
    on rows of 7 and 8.1 entries G = 1 is the fastest, on 16 G = 2..4, on
    64 and 256 G = 8..32."""
    mean = nnz / n if n else 0.0
    if mean < CSR_GROUP_FROM:
        return 1
    return 1 << min(math.floor(math.log2(mean / 4)), 4)


def _steps_of(offsets: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Each entry's position within its row (entries sorted by row)."""
    return torch.arange(rows.numel(), device=rows.device) - offsets[rows]


def _add_in_steps(out: torch.Tensor, target: torch.Tensor, step: torch.Tensor,
                  terms: torch.Tensor) -> torch.Tensor:
    """out[target[j]] += terms[j], step by step (step 0 first): within a
    step no two entries share a target, so each sum is one rounding, in
    the order of the steps."""
    for s in range(int(step.max()) + 1 if step.numel() else 0):
        on = step == s
        out.index_add_(0, target[on], terms[on])
    return out


def spmv_csr(m: Csr, x, group: int | None = None):
    """Plain y = A x for a Csr matrix (or a DeviceCoo), in the kernel's
    order at `group` lanes per row (None: csr_group)."""
    group = csr_group(m.shape[0], m.nnz) if group is None else group
    rp = m.row_ptr.long()
    n = rp.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), rp.diff())
    pos = _steps_of(rp, rows)
    prod = m.vals.to(x.dtype) * x[m.cols.long()]
    part = _add_in_steps(torch.zeros(n * group, dtype=x.dtype, device=x.device),
                         rows * group + pos % group, pos // group, prod).view(n, group)
    while part.shape[1] > 1:  # the butterfly, seen from lane 0
        half = part.shape[1] // 2
        part = part[:, :half] + part[:, half:]
    return part[:, 0]


def spmv_ell(m: Ell, x):
    """Plain y = Σ_k vals[k] ⊙ x[cols[k]] over the slot-major (K, n) storage."""
    y = torch.zeros(m.shape[0], dtype=x.dtype, device=x.device)
    for k in range(m.row_width):
        y = y + m.vals[k].to(x.dtype) * x[m.cols[k].long()]
    return y


def spmv_sell(m: Sell, x):
    """Plain y = A x for a Sell matrix: per bucket, each slot's lanes in order,
    stored to its row (pad slots to the dead row n)."""
    n, C = m.shape[0], m.slice_height
    y = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    for (first_slot, first_val, w), ns in zip(sell_table(m.widths, m.n_slices, C).tolist(),
                                              m.n_slices):
        slots = ns * C
        vb = m.vals[first_val:first_val + w * slots].view(w, slots).to(x.dtype)
        cb = m.cols[first_val:first_val + w * slots].view(w, slots).long()
        acc = torch.zeros(slots, dtype=x.dtype, device=x.device)
        for k in range(w):
            acc = acc + vb[k] * x[cb[k]]
        y[m.slot_rows[first_slot:first_slot + slots].long()] = acc
    return y[:n]


def spmv_hybrid(m: Hybrid, x):
    """Plain y = A x for a Hybrid matrix: the Ell slots, then each row's tail
    entries in order."""
    rp = m.tail.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(rp.numel() - 1, device=x.device), rp.diff())
    prod = m.tail.vals.to(x.dtype) * x[m.tail.cols.long()]
    return _add_in_steps(spmv_ell(m.ell, x), rows, _steps_of(rp, rows), prod)


# ---- wrappers -------------------------------------------------------------


def _check(what: str, x: torch.Tensor, n: int, tensors) -> None:
    """Raise unless x is a contiguous (n,) float32 tensor and every (name,
    tensor, shape, dtype) of `tensors` matches, all on x's device."""
    for name, t, shape, dtype in (("x", x, (n,), torch.float32), *tensors):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _blocks(items: int, x: torch.Tensor) -> int:
    return max(min(-(-items // THREADS), BLOCKS_PER_SM * sm_count(x.device.index)), 1)


def csr_spmv(m: Csr, x, group: int | None = None):
    """y = A x for a Csr matrix (or a DeviceCoo): `csrc/csr_spmv.cu`, `group`
    lanes per row (a power of two up to 32; None: csr_group)."""
    if on_cpu(m.row_ptr, m.cols, m.vals, x):
        return spmv_csr(m, x, group)
    require_cuda("csr_spmv", x)
    n, nnz = m.shape[0], m.nnz
    group = csr_group(n, nnz) if group is None else group
    _check("csr_spmv", x, n, (("row_ptr", m.row_ptr, (n + 1,), torch.int32),
                              ("cols", m.cols, (nnz,), torch.int32),
                              ("vals", m.vals, (nnz,), torch.float32)))
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_csr_spmv(m.row_ptr.data_ptr(), m.cols.data_ptr(), m.vals.data_ptr(),
                                  x.data_ptr(), y.data_ptr(), n, group,
                                  _blocks(n * group, x), stream_of(x)), "csr_spmv")
    kernels.launches["csr_spmv"] += 1
    return y


def _ell_operands(ell: Ell, n: int) -> tuple:
    k = ell.row_width
    return (("ell cols", ell.cols, (k, n), torch.int32),
            ("ell vals", ell.vals, (k, n), torch.float32))


def ell_spmv(m: Ell, x):
    """y = A x for an Ell matrix: `csrc/ell_spmv.cu`, one thread per row."""
    if on_cpu(m.cols, m.vals, x):
        return spmv_ell(m, x)
    require_cuda("ell_spmv", x)
    n = m.shape[0]
    _check("ell_spmv", x, n, _ell_operands(m, n))
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_ell_spmv(m.cols.data_ptr(), m.vals.data_ptr(), m.row_width,
                                  x.data_ptr(), y.data_ptr(), n, _blocks(n, x), stream_of(x)),
                 "ell_spmv")
    kernels.launches["ell_spmv"] += 1
    return y


def sell_spmv(m: Sell, x):
    """y = A x for a Sell matrix: `csrc/sell_spmv.cu`, one launch over the
    bucket table, one thread per slot."""
    if on_cpu(m.cols, m.vals, m.slot_rows, m.table, x):
        return spmv_sell(m, x)
    require_cuda("sell_spmv", x)
    n, nb, slots = m.shape[0], len(m.widths), int(m.slot_rows.shape[0])
    if nb > SELL_MAX_BUCKETS:
        raise ValueError(f"sell_spmv: {nb} buckets; the kernel stages at most "
                         f"{SELL_MAX_BUCKETS}")
    _check("sell_spmv", x, n, (("table", m.table, (nb, 3), torch.int64),
                               ("slot_rows", m.slot_rows, (slots,), torch.int32),
                               ("cols", m.cols, (m.stored,), torch.int32),
                               ("vals", m.vals, (m.stored,), torch.float32)))
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_sell_spmv(m.table.data_ptr(), nb, m.slot_rows.data_ptr(),
                                   m.cols.data_ptr(), m.vals.data_ptr(), x.data_ptr(),
                                   y.data_ptr(), n, slots, _blocks(slots, x), stream_of(x)),
                 "sell_spmv")
    kernels.launches["sell_spmv"] += 1
    return y


def hybrid_spmv(m: Hybrid, x):
    """y = A x for a Hybrid matrix: `csrc/hybrid_spmv.cu`, the Ell bulk and
    the row's tail in one pass, one thread per row."""
    tail = m.tail
    if on_cpu(m.ell.cols, m.ell.vals, tail.row_ptr, tail.cols, tail.vals, x):
        return spmv_hybrid(m, x)
    require_cuda("hybrid_spmv", x)
    n, t = m.shape[0], tail.nnz
    _check("hybrid_spmv", x, n, (*_ell_operands(m.ell, n),
                                 ("tail row_ptr", tail.row_ptr, (n + 1,), torch.int32),
                                 ("tail cols", tail.cols, (t,), torch.int32),
                                 ("tail vals", tail.vals, (t,), torch.float32)))
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_hybrid_spmv(m.ell.cols.data_ptr(), m.ell.vals.data_ptr(),
                                     m.ell.row_width, tail.row_ptr.data_ptr(),
                                     tail.cols.data_ptr(), tail.vals.data_ptr(), x.data_ptr(),
                                     y.data_ptr(), n, _blocks(n, x), stream_of(x)),
                 "hybrid_spmv")
    kernels.launches["hybrid_spmv"] += 1
    return y
