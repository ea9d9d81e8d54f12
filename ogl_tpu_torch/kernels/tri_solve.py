"""The triangular solves of the ILU family's apply (ILU, ILUT, IRILU, IC,
ICT): kernel 1, the Jacobi sweeps (`csrc/tri_sweep.cu` over
`csrc/tri_sweep.cuh`), kernel 2, exact substitution level by level
(`csrc/tri_levels.cu` over `csrc/tri_levels.cuh`), and their plain PyTorch
twins.

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
exact substitution, which kernel 2 computes in one pass per level.

Both twins fix the order of each row's sum — its entries in order from 0,
each product and sum rounded on its own, then (b − sum)·d — as the kernels'
`row_value` adds them, so each twin gives its kernel's bits, and
`tri_levels_plain` gives the bits of `tri_sweep_plain` run to the depth.

Dispatch, as for every wrapper of the port: CPU tensors run the twin; CUDA
tensors launch the kernel or raise (a refused cooperative launch and a
kernel that does not build included).  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`tri_sweep`, `tri_levels`).
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

__all__ = ["Triangle", "triangle", "tri_sweep", "tri_levels", "tri_sweep_plain",
           "tri_levels_plain", "THREADS", "SWEEP_BLOCKS_PER_SM", "sweep_blocks",
           "level_blocks"]

THREADS = 256  # threads per block of both kernels
SWEEP_BLOCKS_PER_SM = 4  # the sweep kernel's grid cap (its __launch_bounds__)


@dataclasses.dataclass(eq=False)
class Triangle:
    """One strict triangular factor of an apply on one device: `mat` its
    Csr (float32 values, rows sorted, columns sorted within a row), `d` its
    float32 scale or None, `sweeps` its approximate sweep count; `depth` its
    dependency depth (at least 1), `order` its rows level after level (int32)
    and `level_ptr` the levels' offsets into it (int32, levels + 1 on the
    device, `level_sizes` their sizes on the host)."""

    mat: Csr
    d: torch.Tensor | None
    sweeps: int
    depth: int
    order: torch.Tensor
    level_ptr: torch.Tensor
    level_sizes: np.ndarray
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

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
    n = r.shape[0]
    if r.dim() != 1 or r.dtype != torch.float32 or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous float32 vector, not {r.dtype} "
                         f"{tuple(r.shape)}")
    for name, t in (("lower", lower), ("upper", upper)):
        if t.n != n:
            raise ValueError(f"the {name} factor has {t.n} rows, r {n}")
        m = t.mat
        for what, a, dt in (("row_ptr", m.row_ptr, torch.int32), ("cols", m.cols, torch.int32),
                            ("vals", m.vals, torch.float32), ("d", t.d, torch.float32),
                            ("order", t.order, torch.int32),
                            ("level_ptr", t.level_ptr, torch.int32)):
            if a is None:
                continue
            if a.device != r.device or a.dtype != dt or not a.is_contiguous():
                raise ValueError(f"the {name} factor's {what} must be a contiguous {dt} "
                                 f"tensor on {r.device}, not {a.dtype} on {a.device}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _coop_blocks(entry: str, index) -> int:
    """The co-resident blocks of a kernel on device `index` (queried once)."""
    with torch.cuda.device(index):
        blocks = ctypes.c_int64(0)
        _build.check(getattr(_build.library(), entry)(ctypes.byref(blocks)), entry)
    return int(blocks.value)


def sweep_blocks(n: int, device: torch.device) -> int:
    """The sweep kernel's grid: the co-resident blocks, at most
    SWEEP_BLOCKS_PER_SM per SM, fewer when the rows run out."""
    cap = min(_coop_blocks("ogl_tri_sweep_grid", device.index),
              SWEEP_BLOCKS_PER_SM * sm_count(device.index))
    return max(min(-(-n // THREADS), cap), 1)


def level_blocks(lower: Triangle, upper: Triangle, device: torch.device) -> int:
    """The level kernel's grid: enough blocks for the widest level, at most
    the co-resident ones."""
    need = -(-max(lower.widest, upper.widest) // THREADS)
    return max(min(need, _coop_blocks("ogl_tri_levels_grid", device.index)), 1)


def tri_sweep(lower: Triangle, upper: Triangle, r: torch.Tensor) -> torch.Tensor:
    """The approximate apply: lower.sweeps sweeps of the lower factor from
    r, then upper.sweeps of the upper one, as one launch of kernel 1."""
    if on_cpu(r, lower.mat.vals, upper.mat.vals):
        return tri_sweep_plain(lower, upper, r)
    require_cuda("tri_sweep", r)
    _check(lower, upper, r)
    n = r.shape[0]
    t0, t1, out = (torch.empty_like(r) for _ in range(3))
    lib = _build.library()
    lm, um = lower.mat, upper.mat
    _build.check(lib.ogl_tri_sweep(
        lm.row_ptr.data_ptr(), lm.cols.data_ptr(), lm.vals.data_ptr(), _ptr(lower.d),
        lower.sweeps, um.row_ptr.data_ptr(), um.cols.data_ptr(), um.vals.data_ptr(),
        _ptr(upper.d), upper.sweeps, r.data_ptr(), t0.data_ptr(), t1.data_ptr(),
        out.data_ptr(), n, sweep_blocks(n, r.device), stream_of(r)), "tri_sweep")
    kernels.launches["tri_sweep"] += 1
    return out


def tri_levels(lower: Triangle, upper: Triangle, r: torch.Tensor) -> torch.Tensor:
    """The exact apply: forward substitution over the lower factor from r,
    then backward over the upper one, level by level, as one launch of
    kernel 2."""
    if on_cpu(r, lower.mat.vals, upper.mat.vals):
        return tri_levels_plain(lower, upper, r)
    require_cuda("tri_levels", r)
    _check(lower, upper, r)
    n = r.shape[0]
    z, out = torch.empty_like(r), torch.empty_like(r)
    lib = _build.library()
    lm, um = lower.mat, upper.mat
    _build.check(lib.ogl_tri_levels(
        lm.row_ptr.data_ptr(), lm.cols.data_ptr(), lm.vals.data_ptr(), _ptr(lower.d),
        lower.order.data_ptr(), lower.level_ptr.data_ptr(), lower.levels,
        um.row_ptr.data_ptr(), um.cols.data_ptr(), um.vals.data_ptr(), _ptr(upper.d),
        upper.order.data_ptr(), upper.level_ptr.data_ptr(), upper.levels, r.data_ptr(),
        z.data_ptr(), out.data_ptr(), n, level_blocks(lower, upper, r.device),
        stream_of(r)), "tri_levels")
    kernels.launches["tri_levels"] += 1
    return out
