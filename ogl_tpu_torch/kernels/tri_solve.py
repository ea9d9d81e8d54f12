"""The triangular solves of the ILU family's apply (ILU, ILUT, IRILU, IC,
ICT): kernel 1, the Jacobi sweeps (`csrc/tri_sweep.cu` over
`csrc/tri_sweep.cuh`: one CTA per SM, a factor of which half fits brought
into shared memory once per triangle, else streamed), kernel 2, exact
substitution with no grid barrier (`csrc/tri_levels.cu` over
`csrc/tri_levels.cuh`: every row waits on ready words of its own sources),
and their plain PyTorch twins.

Counterpart: the apply of ogl_tpu/precond/ilu.py (`_sweep`,
`make_lu_apply`, `make_ic_apply`, :65-110; XLA ops over the factors'
fast-format SpMV there, no TPU kernel).  An apply takes two strict
triangular factors, each a `Triangle`: its Csr on the device (one lane per
row; the reference packs each factor with `pack_fast`), its scale d and its
sweep count k.  For each factor, b being r for the lower one and its
result z for the upper one,

    x_0 = b·d,  x ← (b − F x)·d   (k times; d None: no scaling)

which is ILU's z ← r − L z, x ← (z − U x)·u⁻¹ and IC's two sweeps scaled by
1/d with Lᵀ stored as a factor of its own.  Run to the factor's dependency
depth (`Triangle.depth`, the reference's `factor_depth`) the sweeps are
exact substitution, which kernel 2 computes in one pass.

Both twins fix the order of each row's sum — its entries in order from 0,
each product and sum rounded on its own, then (b − sum)·d — as the kernels'
rows add them, so each twin gives its kernel's bits, and
`tri_levels_plain` gives the bits of `tri_sweep_plain` run to the depth.

Dispatch, as for every wrapper of the port: CPU tensors run the twin; CUDA
tensors launch the kernel or raise (a refused cooperative launch and a
kernel that does not build included).  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`tri_sweep`, `tri_levels`).

On the card both kernels keep state beside a Triangle (`Triangle._tables`,
`Triangle.ready`): its tensors are checked once, and kernel 1's plans and
scratch and kernel 2's level layout and ready words are made at the first
apply and reused.  So the applies of one pair of factors run on one
stream, in order, and a Triangle's tensors are not replaced after its
first apply.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Csr
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["Triangle", "Ready", "LevelLayout", "triangle", "tri_sweep", "tri_levels",
           "tri_sweep_plain", "tri_levels_plain", "plan_rows", "sweep_plan", "level_layout",
           "sweep_grid", "sweep_blocks", "level_grid", "level_launch", "level_blocks",
           "SWEEP_THREADS", "SWEEP_HOLD_SHARE", "LEVEL_WIDE", "LEVEL_NARROW", "LEVEL_WIDE_ROWS",
           "LEVEL_BLOCKS", "LEVEL_LIMIT_NS", "EPOCH_MAX"]

SWEEP_THREADS = 1024  # threads per CTA of kernel 1 (one CTA per SM)
# kernel 1 holds a factor in shared memory when at least this share of its
# bytes fits; else it streams every row over the grid and, when neither
# factor is held, leaves the SMs' memory to L1
SWEEP_HOLD_SHARE = 0.5
PLAN_SLACK = 128  # bytes a CTA's held rows leave for the 16-byte rounding of each array
# kernel 2's launch, (threads per block, blocks per SM, longest nap in ns
# between polls), for factors whose levels hold on mean at least
# LEVEL_WIDE_ROWS rows (wide: every thread has rows to take) and for the
# others (narrow: few rows wait at once, so fewer threads poll L2); a thread
# loads the words of LEVEL_BLOCKS[0] entries of a row at once where no row
# has more (fewer registers, so more threads), else of LEVEL_BLOCKS[1]
LEVEL_WIDE = (256, 2, 0)
LEVEL_NARROW = (64, 1, 32)
LEVEL_WIDE_ROWS = 1024
LEVEL_BLOCKS = (4, 16)
LEVEL_LIMIT_NS = 10 * 10**9  # a wait on one word this long traps (no legal wait comes near)
EPOCH_MAX = 2**31 - 1  # past it the ready words are zeroed and the epochs start again at 1


@dataclasses.dataclass(eq=False)
class LevelLayout:
    """A factor in level order, as kernel 2 reads it (int32 but the float32
    values and scale): position p holds row rows[p] (the factor's `order`),
    its entries in the row's own order at [ptr[p], ptr[p + 1]), each source
    named by its position (src) with its value (vals); inv[i] is row i's
    position and d the scale by position (None: none); `longest` the most
    entries of a row."""

    ptr: torch.Tensor
    src: torch.Tensor
    vals: torch.Tensor
    rows: torch.Tensor
    inv: torch.Tensor
    d: torch.Tensor | None
    longest: int


@dataclasses.dataclass(eq=False)
class Ready:
    """A factor's ready words for kernel 2: one int64 per position on the
    card (the row's float32 value and the epoch of the apply that wrote it),
    zeroed when made, and the highest epoch an apply has given them.  Shared
    by the copies `dataclasses.replace` makes of a Triangle, so their applies
    never reuse an epoch."""

    words: torch.Tensor | None = None
    epoch: int = 0


@dataclasses.dataclass(eq=False)
class Triangle:
    """One strict triangular factor of an apply on one device: `mat` its
    Csr (float32 values, rows sorted, columns sorted within a row), `d` its
    float32 scale or None, `sweeps` its approximate sweep count; `depth` its
    dependency depth (at least 1), `order` its rows level after level (int32)
    and `level_ptr` the levels' offsets into it (int32, levels + 1 on the
    device, `level_sizes` their sizes on the host: the twin's and the
    report's; kernel 2 reads the factor in level order, `level_layout`);
    `ready` kernel 2's ready words.  Its tensors are not replaced after its
    first apply on the card, and its applies run on one stream (the
    module's docstring)."""

    mat: Csr
    d: torch.Tensor | None
    sweeps: int
    depth: int
    order: torch.Tensor
    level_ptr: torch.Tensor
    level_sizes: np.ndarray
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)
    ready: Ready = dataclasses.field(default_factory=Ready, repr=False)

    @property
    def n(self) -> int:
        return self.mat.shape[0]

    @property
    def levels(self) -> int:
        return len(self.level_sizes)

    @property
    def widest(self) -> int:
        return int(self.level_sizes.max())

    def table(self, levelled: bool):
        """The factor's rows padded to its longest, (cols (n, K) int64, vals
        (n, K)), in row order or (levelled) in `order`: what the twins sum,
        entry k of every row at once.  A padding slot has the value 0 and
        the source n, which the twins hold at 0.0: its term is +0.0, and a
        row's sum (from +0.0, never -0.0) is unchanged by it, to the bit."""
        if levelled not in self._tables:
            rp = self.mat.row_ptr.long()
            lens = rp.diff()
            rows = torch.repeat_interleave(torch.arange(self.n, device=rp.device), lens)
            pos = torch.arange(rows.numel(), device=rp.device) - rp[rows]
            width = int(lens.max()) if self.n and rows.numel() else 0
            cols = torch.full((self.n, width), self.n, dtype=torch.int64, device=rp.device)
            vals = torch.zeros((self.n, width), dtype=self.mat.vals.dtype, device=rp.device)
            cols[rows, pos] = self.mat.cols.long()
            vals[rows, pos] = self.mat.vals
            if levelled:
                o = self.order.long()
                cols, vals = cols[o], vals[o]
            self._tables[levelled] = (cols, vals)
        return self._tables[levelled]


def _row_major(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray | slice:
    """The order that sorts (rows, cols) row-major: none for triples already
    in that order (a factor as the factorisations return it), else the
    native counting sort's permutation (a transposed factor), else a full
    sort."""
    from ogl_tpu_torch import native

    if not np.any((rows[1:] < rows[:-1]) | ((rows[1:] == rows[:-1]) & (cols[1:] <= cols[:-1]))):
        return slice(None)
    nat = native.sort_coo(n, rows, cols)
    return np.lexsort((cols, rows)) if nat is None else nat[2]


def _level_order(levels: np.ndarray) -> np.ndarray:
    """The rows level after level, ascending within a level (a stable sort
    of the levels; 16-bit keys take numpy's radix sort)."""
    key = levels.astype(np.int16 if levels.max(initial=0) < 2**15 else np.int64)
    return np.argsort(key, kind="stable")


def triangle(rows, cols, vals, n: int, d, sweeps: int, levels: np.ndarray,
             device) -> Triangle:
    """A Triangle from host triples of a strict factor (any order), its
    scale (host array or None), its sweep count and the dependency level of
    every row (precond/ilu.py `factor_levels`), on `device`."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = _row_major(rows, cols, n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    mat = Csr(row_ptr=torch.tensor(row_ptr.astype(np.int32), device=device),
              cols=torch.tensor(cols[order].astype(np.int32), device=device),
              vals=torch.tensor(np.asarray(vals)[order].astype(np.float32), device=device),
              shape=(n, n))
    levels = np.asarray(levels, np.int64)
    sizes = np.bincount(levels, minlength=int(levels.max()) + 1 if n else 1)
    level_ptr = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=level_ptr[1:])
    return Triangle(
        mat=mat,
        d=None if d is None else torch.tensor(np.asarray(d).astype(np.float32), device=device),
        sweeps=int(sweeps), depth=max(int(levels.max()) if n else 0, 1),
        order=torch.tensor(_level_order(levels).astype(np.int32), device=device),
        level_ptr=torch.tensor(level_ptr.astype(np.int32), device=device), level_sizes=sizes)


# ---- the plain twins ---------------------------------------------------------


def _sums(cols, vals, x):
    """Σ_j F[i, j]·x[j] for the rows of a padded table (x holding the zero
    source at n): every row's products at once, then added in entry order
    from 0, each product and sum rounded."""
    prod = vals * x[cols]
    acc = torch.zeros(cols.shape[0], dtype=x.dtype, device=x.device)
    for k in range(cols.shape[1]):
        acc = acc + prod[:, k]
    return acc


def _scale(v, d):
    return v if d is None else v * d


def _with_zero(v):
    """v followed by the padding slots' source, 0.0."""
    return torch.cat([v, v.new_zeros(1)])


def _sweeps_plain(t: Triangle, b, k: int):
    x = _scale(b, t.d)
    cols, vals = t.table(False)
    for _ in range(k):
        x = _scale(b - _sums(cols, vals, _with_zero(x)), t.d)
    return x


def tri_sweep_plain(lower: Triangle, upper: Triangle, r):
    """lower.sweeps sweeps of the lower factor from r, then upper.sweeps of
    the upper one from their result: the plain twin of `tri_sweep`."""
    return _sweeps_plain(upper, _sweeps_plain(lower, r, lower.sweeps), upper.sweeps)


def _levels_plain(t: Triangle, b):
    x = b.new_zeros(t.n + 1)  # every row is written at its level; x[n] stays 0
    cols, vals = t.table(True)
    o = t.order.long()
    lp = np.concatenate([[0], np.cumsum(t.level_sizes)])
    bo = b[o]
    do = None if t.d is None else t.d[o]
    for lo, hi in zip(lp[:-1].tolist(), lp[1:].tolist()):
        v = bo[lo:hi] - _sums(cols[lo:hi], vals[lo:hi], x)
        x[o[lo:hi]] = v if do is None else v * do[lo:hi]
    return x[:t.n]


def tri_levels_plain(lower: Triangle, upper: Triangle, r):
    """Exact substitution, level by level, over the lower factor from r and
    the upper one from its result: the plain twin of `tri_levels`."""
    return _levels_plain(upper, _levels_plain(lower, r))


# ---- the kernels -------------------------------------------------------------


def _check(lower: Triangle, upper: Triangle, r: torch.Tensor) -> None:
    """r against the factors; each factor's own tensors once per device
    (a Triangle's tensors are not replaced after its first apply: its
    plans, layout and scratch are cached beside them)."""
    n = r.shape[0]
    if r.dim() != 1 or r.dtype != torch.float32 or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous float32 vector, not {r.dtype} "
                         f"{tuple(r.shape)}")
    for name, t in (("lower", lower), ("upper", upper)):
        if t.n != n:
            raise ValueError(f"the {name} factor has {t.n} rows, r {n}")
        if ("checked", r.device) in t._tables:
            continue
        m = t.mat
        for what, a, dt in (("row_ptr", m.row_ptr, torch.int32), ("cols", m.cols, torch.int32),
                            ("vals", m.vals, torch.float32), ("d", t.d, torch.float32),
                            ("order", t.order, torch.int32)):
            if a is None:
                continue
            if a.device != r.device or a.dtype != dt or not a.is_contiguous():
                raise ValueError(f"the {name} factor's {what} must be a contiguous {dt} "
                                 f"tensor on {r.device}, not {a.dtype} on {a.device}")
        for what, a in (("row_ptr", m.row_ptr), ("cols", m.cols), ("vals", m.vals)):
            if a.data_ptr() % 16:
                raise ValueError(f"the {name} factor's {what} must start 16-byte aligned "
                                 "(kernel 1 brings it into shared memory by bulk copies)")
        t._tables[("checked", r.device)] = True


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sweep_grid(index) -> tuple[int, int]:
    """Kernel 1 on device `index` (queried once): its co-resident CTAs of
    SWEEP_THREADS with all the shared memory a CTA can take (one per SM),
    and that capacity in bytes."""
    with torch.cuda.device(index):
        blocks, capacity = ctypes.c_int64(0), ctypes.c_int64(0)
        _build.check(_build.library().ogl_tri_sweep_grid(ctypes.byref(blocks),
                                                          ctypes.byref(capacity)),
                     "ogl_tri_sweep_grid")
    return int(blocks.value), int(capacity.value)


@functools.lru_cache(maxsize=None)
def level_grid(index, threads: int, block: int) -> int:
    """Kernel 2's co-resident blocks of `threads` on device `index`, its
    rows' words loaded `block` entries at once."""
    with torch.cuda.device(index):
        blocks = ctypes.c_int64(0)
        _build.check(_build.library().ogl_tri_levels_grid(block, threads,
                                                          ctypes.byref(blocks)),
                     "ogl_tri_levels_grid")
    return int(blocks.value)


def sweep_blocks(n: int, device: torch.device) -> int:
    """Kernel 1's grid: one CTA per SM (the co-resident ones), fewer when
    the rows run out."""
    return max(min(-(-n // SWEEP_THREADS), sweep_grid(device.index)[0]), 1)


def level_launch(lower: Triangle, upper: Triangle) -> tuple[int, int, int, int]:
    """Kernel 2's launch for the two factors, (entries whose words a thread
    loads at once, threads per block, blocks per SM, longest nap in ns):
    LEVEL_WIDE or LEVEL_NARROW by their mean rows per level, the block by
    their longest row."""
    longest = max(level_layout(lower).longest, level_layout(upper).longest)
    block = LEVEL_BLOCKS[0] if longest <= LEVEL_BLOCKS[0] else LEVEL_BLOCKS[1]
    width = (lower.n + upper.n) / (lower.levels + upper.levels)
    return (block, *(LEVEL_WIDE if width >= LEVEL_WIDE_ROWS else LEVEL_NARROW))


def level_blocks(cfg: tuple[int, int, int, int], device: torch.device) -> int:
    """Kernel 2's grid for the launch `cfg` (`level_launch`'s tuple): its
    blocks per SM on every SM, at most the co-resident ones."""
    block, threads, per_sm, _ = cfg
    return max(min(per_sm * sm_count(device.index), level_grid(device.index, threads, block)),
               1)


def plan_rows(row_ptr: np.ndarray, ctas: int, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Kernel 1's split of a factor's rows (host `row_ptr`, n + 1 offsets)
    over `ctas` CTAs: CTA c owns rows [bounds[c], bounds[c + 1]), balanced
    by entries (a row weighs its entries and one), and holds in shared memory
    its first rows up to held[c] (their offsets and entries within
    `capacity` bytes, PLAN_SLACK of it kept for each array's rounding to 16
    bytes)."""
    rp = np.asarray(row_ptr, np.int64)
    n = len(rp) - 1
    rows = np.arange(n + 1, dtype=np.int64)
    cost = rp + rows  # the weight of the rows before each row
    bounds = np.searchsorted(cost, np.arange(ctas + 1, dtype=np.int64) * cost[-1] // ctas)
    bounds[0], bounds[-1] = 0, n
    key = 4 * rows + 8 * rp  # the bytes of the rows before each row, unrounded
    held = np.searchsorted(key, key[bounds[:-1]] + (capacity - PLAN_SLACK), side="right") - 1
    held = np.clip(held, bounds[:-1], bounds[1:])
    return bounds.astype(np.int32), held.astype(np.int32)


def sweep_plan(t: Triangle, ctas: int, capacity: int, share: float):
    """`plan_rows` of t on its device, (bounds, held) as int32 tensors, or
    None where less than `share` of the factor's bytes would be held (the
    factor streamed); made once per grid, capacity and share."""
    key = ("sweep_plan", ctas, capacity, share)
    if key not in t._tables:
        rp = t.mat.row_ptr.cpu().numpy()
        bounds, held = plan_rows(rp, ctas, capacity)
        rp = rp.astype(np.int64)
        kept = 4 * (held - bounds[:-1]).sum() + 8 * (rp[held] - rp[bounds[:-1]]).sum()
        if t.sweeps == 0 or kept < share * (4 * t.n + 8 * t.mat.nnz):
            t._tables[key] = None
        else:
            dev = t.mat.row_ptr.device
            t._tables[key] = (torch.from_numpy(bounds).to(dev), torch.from_numpy(held).to(dev))
    return t._tables[key]


def level_layout(t: Triangle) -> LevelLayout:
    """t in level order (`LevelLayout`) on its device, made once: the rows
    of `order`, each row's entries kept in their order, so a row sums its
    sources in the order kernel 1 and the twins do."""
    if "level_layout" not in t._tables:
        rp = t.mat.row_ptr.long()
        o = t.order.long()
        n, dev = t.n, rp.device
        lens = (rp[1:] - rp[:-1])[o]
        ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=ptr[1:])
        pos = torch.repeat_interleave(torch.arange(n, device=dev), lens)
        entry = rp[o][pos] + torch.arange(pos.numel(), device=dev) - ptr[pos]
        inv = torch.empty(n, dtype=torch.int64, device=dev)
        inv[o] = torch.arange(n, device=dev)
        t._tables["level_layout"] = LevelLayout(
            ptr=ptr.int(), src=inv[t.mat.cols.long()[entry]].int(), vals=t.mat.vals[entry],
            rows=t.order, inv=inv.int(), d=None if t.d is None else t.d[o],
            longest=int(lens.max()) if n else 0)
    return t._tables["level_layout"]


def tri_sweep(lower: Triangle, upper: Triangle, r: torch.Tensor) -> torch.Tensor:
    """The approximate apply: lower.sweeps sweeps of the lower factor from
    r, then upper.sweeps of the upper one, as one launch of kernel 1.

    The two ping-pong vectors are made at the first apply and kept beside
    the lower factor, so the applies of one pair of factors run on one
    stream, in order."""
    if on_cpu(r, lower.mat.vals, upper.mat.vals):
        return tri_sweep_plain(lower, upper, r)
    require_cuda("tri_sweep", r)
    return _launch_sweeps(lower, upper, r, SWEEP_HOLD_SHARE)


def _launch_sweeps(lower: Triangle, upper: Triangle, r: torch.Tensor,
                   share: float) -> torch.Tensor:
    """One launch of kernel 1 on CUDA tensors, a factor held where at least
    `share` of it fits (`sweep_plan`; math.inf: both streamed): `tri_sweep`'s
    share, or another that ogl_tpu_torch/tri_tune.py times."""
    _check(lower, upper, r)
    n = r.shape[0]
    blocks = sweep_blocks(n, r.device)
    capacity = sweep_grid(r.device.index)[1]
    lp, up = (sweep_plan(t, blocks, capacity, share) for t in (lower, upper))
    (lb, lh), (ub, uh) = (p if p is not None else (None, None) for p in (lp, up))
    if lp is None and up is None:
        capacity = 0
    scratch = ("scratch", r.device)
    if scratch not in lower._tables:  # the two ping-pong vectors, kept for every apply
        lower._tables[scratch] = torch.empty((2, n), dtype=r.dtype, device=r.device)
    t0, t1 = lower._tables[scratch]
    out = torch.empty_like(r)
    lib = _build.library()
    lm, um = lower.mat, upper.mat
    _build.check(lib.ogl_tri_sweep(
        lm.row_ptr.data_ptr(), lm.cols.data_ptr(), lm.vals.data_ptr(), _ptr(lower.d),
        lower.sweeps, _ptr(lb), _ptr(lh), um.row_ptr.data_ptr(), um.cols.data_ptr(),
        um.vals.data_ptr(), _ptr(upper.d), upper.sweeps, _ptr(ub), _ptr(uh), r.data_ptr(),
        t0.data_ptr(), t1.data_ptr(), out.data_ptr(), n, blocks, capacity, stream_of(r)),
        "tri_sweep")
    kernels.launches["tri_sweep"] += 1
    return out


def _epoch(lower: Triangle, upper: Triangle, device: torch.device) -> int:
    """The epoch of the next apply of the two factors: above every epoch
    either factor's ready words hold.  Words are made zeroed at the first
    apply, and zeroed again (on the current stream, before the launch) when
    the epoch would pass EPOCH_MAX."""
    if lower.ready is upper.ready:
        raise ValueError("tri_levels: the two factors share their ready words")
    for t in (lower, upper):
        w = t.ready.words
        if w is None or w.device != device or w.numel() != t.n:
            t.ready.words = torch.zeros(t.n, dtype=torch.int64, device=device)
    epoch = max(lower.ready.epoch, upper.ready.epoch) + 1
    if epoch > EPOCH_MAX:
        for t in (lower, upper):
            t.ready.words.zero_()
        epoch = 1
    lower.ready.epoch = upper.ready.epoch = epoch
    return epoch


def tri_levels(lower: Triangle, upper: Triangle, r: torch.Tensor) -> torch.Tensor:
    """The exact apply: forward substitution over the lower factor from r,
    then backward over the upper one, as one launch of kernel 2 over the
    factors in level order (`level_layout`, made at the first apply).

    Each apply takes a new epoch for the factors' ready words (`Ready`), so
    the applies of one pair of factors run on one stream, in order, and are
    never captured in a CUDA graph (a replay would repeat the epoch of its
    capture; the capture raises)."""
    if on_cpu(r, lower.mat.vals, upper.mat.vals):
        return tri_levels_plain(lower, upper, r)
    require_cuda("tri_levels", r)
    return _launch_levels(lower, upper, r)


def _launch_levels(lower: Triangle, upper: Triangle, r: torch.Tensor,
                   cfg: tuple[int, int, int, int] | None = None) -> torch.Tensor:
    """One launch of kernel 2 on CUDA tensors with the launch settings
    `cfg` (`level_launch`'s tuple; None: `level_launch`'s own, as
    `tri_levels` launches): another is one that ogl_tpu_torch/tri_tune.py
    times."""
    _check(lower, upper, r)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("tri_levels: an apply cannot be captured in a CUDA graph (its "
                           "epoch is fixed at the capture)")
    n = r.shape[0]
    lo, up = level_layout(lower), level_layout(upper)
    cfg = level_launch(lower, upper) if cfg is None else cfg
    block, threads, _, sleep_ns = cfg
    epoch = _epoch(lower, upper, r.device)
    out = torch.empty_like(r)
    _build.check(_build.library().ogl_tri_levels(
        *(_ptr(a) for a in (lo.ptr, lo.src, lo.vals, lo.rows, lo.inv, lo.d, up.ptr, up.src,
                            up.vals, up.rows, up.inv, up.d)),
        r.data_ptr(), out.data_ptr(), lower.ready.words.data_ptr(),
        upper.ready.words.data_ptr(), epoch, sleep_ns, LEVEL_LIMIT_NS, block, n, threads,
        level_blocks(cfg, r.device), stream_of(r)), "tri_levels")
    kernels.launches["tri_levels"] += 1
    return out
