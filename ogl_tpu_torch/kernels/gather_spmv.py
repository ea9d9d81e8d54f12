"""The gather SpMVs of the reference-parity formats: Csr (and the device
Coo, a Csr by its storage), Ell, Sell and Hybrid — each a CUDA C++ kernel
(`csrc/csr_spmv.cu` over `csrc/csr_rows.cuh`, `csrc/ell_spmv.cu` over
`csrc/ell_rows.cuh`, `csrc/sell_spmv.cu` over `csrc/sell_rows.cuh`; Hybrid
through the Ell kernel, which adds each row's tail) and its plain PyTorch
twin.

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
  Ell      one row's slots in order, up to its 32-row group's longest row
           (`Ell.warp_slots`; the padding below it included).
  Sell     one slot's lanes in order, up to its slice's longest row
           (`Sell.slice_widths`; the padding below it included).
  Hybrid   the Ell slots as Ell, then the row's tail entries in order.
The twins add a step's terms with `index_add_`, one term per target per
call, so no sum depends on the order of the call's terms.

Dispatch, as for every wrapper of the port: CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`csr_spmv`, `ell_spmv`, `sell_spmv`,
`hybrid_spmv`).  A `CsrSpmv`, `EllSpmv` or `SellSpmv` checks a
container's operands once, when it is made (`spmv.matvec` makes one per
solve), and fixes its grid; each call then checks x and launches.
`csr_spmv`, `ell_spmv`, `sell_spmv` and `hybrid_spmv` make one per call.
"""

from __future__ import annotations

import math

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import ELL_GROUP, Csr, Ell, Hybrid, Sell, sell_table
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import require_cuda, sm_count, stream_of

__all__ = ["CSR_GROUP_FROM", "csr_group", "spmv_csr", "spmv_ell", "spmv_sell", "spmv_hybrid",
           "csr_spmv", "ell_spmv", "sell_spmv", "hybrid_spmv", "GatherSpmv", "CsrSpmv",
           "EllSpmv", "SellSpmv", "check_sell", "sell_operands", "THREADS", "BLOCKS_PER_SM",
           "SELL_MAX_BUCKETS"]

THREADS = 256  # threads per block of the four kernels
BLOCKS_PER_SM = 64  # grid cap of the grid-stride loops (as the Dia SpMV's)
SELL_MAX_BUCKETS = 64  # csrc/sell_rows.cuh kSellMaxBuckets: the staged bucket table


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
    """Plain y = Σ_k vals[k] ⊙ x[cols[k]] over the slot-major (K, n) storage,
    each row stopping at its 32-row group's longest row (`warp_slots`), as
    the kernel's warps do.  The slots past it hold padding only (0 · x[i]):
    for finite x the reference's sum over all K slots differs from this one
    at most in the sign of a zero sum."""
    n = m.shape[0]
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    slots = m.warp_slots.repeat_interleave(ELL_GROUP)[:n]
    for k in range(m.row_width):
        y = torch.where(slots > k, y + m.vals[k].to(x.dtype) * x[m.cols[k].long()], y)
    return y


def spmv_sell(m: Sell, x):
    """Plain y = A x for a Sell matrix: per bucket, each slot's lanes in
    order up to its slice's longest row (`slice_widths`), as the kernel's
    slices stop, stored to its row (pad slots to the dead row n).  The lanes
    past it hold padding only (0 · x[0]): for finite x the reference's sum
    over the bucket's width differs from this one at most in the sign of a
    zero sum."""
    n, C = m.shape[0], m.slice_height
    y = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    slot_widths = m.slice_widths.repeat_interleave(C)
    for (first_slot, first_val, w), ns in zip(sell_table(m.widths, m.n_slices, C).tolist(),
                                              m.n_slices):
        slots = ns * C
        vb = m.vals[first_val:first_val + w * slots].view(w, slots).to(x.dtype)
        cb = m.cols[first_val:first_val + w * slots].view(w, slots).long()
        sw = slot_widths[first_slot:first_slot + slots]
        acc = torch.zeros(slots, dtype=x.dtype, device=x.device)
        for k in range(w):
            acc = torch.where(sw > k, acc + vb[k] * x[cb[k]], acc)
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


def _check(what: str, device: torch.device, tensors) -> None:
    """Raise unless every (name, tensor, shape, dtype) of `tensors` matches,
    contiguous and on `device`."""
    for name, t, shape, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _blocks(items: int, device: torch.device) -> int:
    return max(min(-(-items // THREADS), BLOCKS_PER_SM * sm_count(device.index)), 1)


class GatherSpmv:
    """y = A x for one container of a gather format: its operands are
    checked once, when it is made (`spmv.matvec` makes one per solve), and
    the grid and the library entry fixed; each call then checks x and
    launches (one ctypes call and torch.empty_like), counting `name`.  A
    container on the CPU runs the twin.  Subclasses set `name`, `_twin` and,
    on the card, `_launch`, `_head` (the arguments before x and y) and
    `_tail` (those after them, before the stream)."""

    name: str

    def __init__(self, m):
        self.m = m
        self.n = m.shape[0]
        self.device = m.vals.device if hasattr(m, "vals") else m.ell.vals.device

    def _twin(self, x):
        raise NotImplementedError

    def __call__(self, x):
        if self.device.type == "cpu" and x.device.type == "cpu":
            return self._twin(x)
        require_cuda(self.name, x)
        if x.device != self.device:
            raise ValueError(f"{self.name}: x is on {x.device}, the matrix on {self.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{self.name}: x has dtype {x.dtype}; the kernel takes "
                            "torch.float32")
        if x.shape != (self.n,) or not x.is_contiguous():
            raise ValueError(f"{self.name}: x has shape {tuple(x.shape)} (contiguous "
                             f"{x.is_contiguous()}), expected a contiguous ({self.n},)")
        y = torch.empty_like(x)
        _build.check(self._launch(*self._head, x.data_ptr(), y.data_ptr(), *self._tail,
                                  stream_of(x)), self.name)
        kernels.launches[self.name] += 1
        return y


class CsrSpmv(GatherSpmv):
    """y = A x for one Csr matrix or DeviceCoo: `csrc/csr_spmv.cu` at `group`
    lanes per row (a power of two up to 32; None: csr_group)."""

    name = "csr_spmv"

    def __init__(self, m: Csr, group: int | None = None):
        super().__init__(m)
        n, nnz = self.n, m.nnz
        self.group = csr_group(n, nnz) if group is None else group
        if self.device.type == "cpu":
            return
        require_cuda(self.name, m.vals)
        _check(self.name, self.device, (("row_ptr", m.row_ptr, (n + 1,), torch.int32),
                                        ("cols", m.cols, (nnz,), torch.int32),
                                        ("vals", m.vals, (nnz,), torch.float32)))
        self._launch = _build.library().ogl_csr_spmv
        self._head = (m.row_ptr.data_ptr(), m.cols.data_ptr(), m.vals.data_ptr())
        self._tail = (n, self.group, _blocks(n * self.group, self.device))

    def _twin(self, x):
        return spmv_csr(self.m, x, self.group)


class EllSpmv(GatherSpmv):
    """y = A x for one Ell or Hybrid container: `csrc/ell_spmv.cu`, one
    thread per row, a Hybrid's tail in the same pass (none read when the tail
    is empty), counting `ell_spmv` or `hybrid_spmv`."""

    def __init__(self, m: Ell | Hybrid):
        super().__init__(m)
        hybrid = isinstance(m, Hybrid)
        ell, tail = (m.ell, m.tail) if hybrid else (m, None)
        self.name = "hybrid_spmv" if hybrid else "ell_spmv"
        n = self.n
        if self.device.type == "cpu":
            return
        require_cuda(self.name, ell.vals)
        k, groups = ell.row_width, -(-n // ELL_GROUP)
        operands = [("ell cols", ell.cols, (k, n), torch.int32),
                    ("ell vals", ell.vals, (k, n), torch.float32),
                    ("ell warp_slots", ell.warp_slots, (groups,), torch.int32)]
        if hybrid:
            t = tail.nnz
            operands += [("tail row_ptr", tail.row_ptr, (n + 1,), torch.int32),
                         ("tail cols", tail.cols, (t,), torch.int32),
                         ("tail vals", tail.vals, (t,), torch.float32)]
        _check(self.name, self.device, operands)
        if groups and int(ell.warp_slots.max()) > k:
            raise ValueError(f"{self.name}: a warp slot count exceeds the Ell width {k}")
        no_tail = not hybrid or tail.nnz == 0
        self._head = (ell.cols.data_ptr(), ell.vals.data_ptr(), ell.warp_slots.data_ptr(),
                      *((None,) * 3 if no_tail else
                        (tail.row_ptr.data_ptr(), tail.cols.data_ptr(), tail.vals.data_ptr())))
        self._tail = (n, _blocks(n, self.device))
        self._launch = _build.library().ogl_ell_spmv

    def _twin(self, x):
        return (spmv_hybrid if self.name == "hybrid_spmv" else spmv_ell)(self.m, x)


def check_sell(what: str, m: Sell, device: torch.device, vals: bool = True) -> None:
    """Raise unless the Sell container's index tensors (and, with `vals`, its
    values) are the layout its kernels take on `device`: at most
    SELL_MAX_BUCKETS buckets, whole slices, every slice's width within its
    bucket's."""
    nb, slots, C = len(m.widths), int(m.slot_rows.shape[0]), m.slice_height
    if nb > SELL_MAX_BUCKETS:
        raise ValueError(f"{what}: {nb} buckets; the kernel stages at most {SELL_MAX_BUCKETS}")
    if slots % C:
        raise ValueError(f"{what}: {slots} slots are not whole slices of {C}")
    slices = slots // C
    _check(what, device, (("table", m.table, (nb, 3), torch.int64),
                          ("slice_buckets", m.slice_buckets, (slices,), torch.uint8),
                          ("slice_widths", m.slice_widths, (slices,), torch.int32),
                          ("slot_rows", m.slot_rows, (slots,), torch.int32),
                          ("cols", m.cols, (m.stored,), torch.int32),
                          *((("vals", m.vals, (m.stored,), torch.float32),) if vals else ())))
    widths = torch.tensor(m.widths, dtype=torch.int32, device=device)
    if slices and bool((m.slice_widths > widths[m.slice_buckets.long()]).any()):
        raise ValueError(f"{what}: a slice width exceeds its bucket's width")


def sell_operands(m: Sell) -> tuple:
    """The Sell operands of a launch, bar the values: (table, n_buckets,
    slice_buckets, slice_widths, slot_rows, cols)."""
    return (m.table.data_ptr(), len(m.widths), m.slice_buckets.data_ptr(),
            m.slice_widths.data_ptr(), m.slot_rows.data_ptr(), m.cols.data_ptr())


class SellSpmv(GatherSpmv):
    """y = A x for one Sell matrix: `csrc/sell_spmv.cu`, one launch over
    every bucket, one thread per slot, each slice stopping at its longest
    row."""

    name = "sell_spmv"

    def __init__(self, m: Sell):
        super().__init__(m)
        if self.device.type == "cpu":
            return
        require_cuda(self.name, m.vals)
        check_sell(self.name, m, self.device)
        slots = int(m.slot_rows.shape[0])
        self._head = (*sell_operands(m), m.vals.data_ptr(), slots, m.slice_height)
        self._tail = (self.n, _blocks(slots, self.device))
        self._launch = _build.library().ogl_sell_spmv

    def _twin(self, x):
        return spmv_sell(self.m, x)


def csr_spmv(m: Csr, x, group: int | None = None):
    """y = A x for a Csr matrix (or a DeviceCoo): CsrSpmv at `group` lanes
    per row (None: csr_group)."""
    return CsrSpmv(m, group)(x)


def ell_spmv(m: Ell, x):
    """y = A x for an Ell matrix (EllSpmv)."""
    return EllSpmv(m)(x)


def sell_spmv(m: Sell, x):
    """y = A x for a Sell matrix (SellSpmv)."""
    return SellSpmv(m)(x)


def hybrid_spmv(m: Hybrid, x):
    """y = A x for a Hybrid matrix (EllSpmv): the Ell bulk and the row's
    tail in one pass."""
    return EllSpmv(m)(x)
