"""Algebraic multigrid: the "Multigrid" preconditioner and the cycle that
GKOMultigrid iterates.

Counterpart: ogl_tpu/precond/amg.py (`pgm_aggregate`, `natural_aggregate`,
`grid_dims_of`, `grid_aggregate`, `build_hierarchy`, `_ell_of`, the
transfers, `_smooth`, `_coarse_solve`, `cg_fixed_iters`, `amg`).

Setup runs on the host, as in the reference: aggregation (2×-per-axis
geometric blocks for a box-grid stencil — `auto`/`grid` —, consecutive
runs — `natural` —, or greedy pairwise matching — `pgm`, through the
native runtime, native/src/ogl_host.cpp, as the reference calls its own;
`pgm_aggregate_plain` is the pure-Python loop), Galerkin coarse operators
by index-mapped duplicate sums in SciPy, and a dense inverse of the
coarsest operator.  The numpy and SciPy steps are the reference's, step for
step, so both packages build the same hierarchy from the same COO.  Each
level operator takes the reference's format (`_ell_of`): Dia (at most 64
distinct offsets), else Gdia (at most GDIA_MAX_PLANES planes), else the
port's slot-major Ell.  Each level is then uploaded once: its operator
(float32), 1/diag, and — on every level but the coarsest — the
coefficients the smoother reads, packed in `smoother_dtype` in the
format's own layout.

The cycle (v, w or f; one cycle from a zero guess per application) runs
every Jacobi sweep and residual through the level format's smoother
kernels — Dia: `CgKernels.ksweep`/`kresid` (csrc/amg_smooth.cu); Gdia and
Ell: kernels/amg_level.py `GdiaSmoother`/`EllSmoother` (csrc/
amg_gdia_smooth.cu, amg_ell_smooth.cu) —, CUDA C++ on the card, plain twins
on the CPU; the transfers as plain reshapes and sums (`grid`/`natural`) or
the pgm transfer kernels (kernels/amg_level.py `PgmTransfer`, csrc/
amg_transfer.cu: each coarse row sums its members in order, no float
atomics) — XLA ops in the reference, not Pallas kernels —, and the coarsest
solve as one `torch.mv` against the dense inverse (or, for `coarseSolver
cg`, fixed-iteration CG on the coarsest level's own SpMV kernel).
`cycle_op` returns an `AmgOp`, which records the settings the cycle runs
at: a hierarchy that kernels/amg_loop.py `qualifies` (cycle v, Dia levels,
grid or natural transfers, a dense coarse inverse) runs its whole solve
with the cycle on the device on the card instead (kernels/csrc/
amg_loop.cu), over a level table built once per hierarchy and kept on the
op; any other hierarchy — a Gdia or Ell level, pgm transfers — keeps this
host-launched cycle.

Deliberate differences from the reference:
  * smoother coefficients are packed in `smoother_dtype` (bfloat16 by
    default) on every smoothing level, of any format, and on either
    device.  The reference packs bfloat16 only for its fused TPU Dia levels
    of at least 32k rows (amg.py:301-324) and stays float32 on the CPU; the
    float32 packing is `smoother_dtype=torch.float32` (fvSolution: the
    preconditioner's `precision float32`).
  * the reference keeps a second, halo-framed copy of the cycle
    (`framed_fn`, `fine_plan`) so that its merged CG shares the fine
    level's frame; the port's vectors are flat, so the merged CG calls
    `apply_fn` itself.
  * the pgm restriction sums each aggregate's fine rows in ascending order
    (the reference's `segment_sum` leaves the order to XLA).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ogl_tpu_torch import native
from ogl_tpu_torch.core.formats import Coo, Dia, Ell, coo_to_dia, coo_to_ell
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.amg_level import EllSmoother, GdiaSmoother, PgmTransfer
from ogl_tpu_torch.kernels.dia_spmv import MAX_DIAGS
from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.kernels.gdia import Gdia, gdia_from_coo
from ogl_tpu_torch.precond import PrecondOp

__all__ = ["Level", "AmgOp", "make_level", "amg", "cycle_op", "build_hierarchy",
           "pgm_aggregate", "pgm_aggregate_plain", "natural_aggregate", "grid_dims_of",
           "grid_aggregate", "grid_restrict", "grid_prolong", "cg_fixed_iters"]

LANES = 128  # the reference's Gdia row width (kernels/gdia.py)
GDIA_MAX_PLANES = 48  # the plane budget of its Gdia level operators (amg.py:394)
DENSE_COARSE_MAX = 4096  # largest coarsest level solved by a dense inverse


def pgm_aggregate(a_csr) -> np.ndarray:
    """Greedy deterministic pairwise matching on strength |a_ij| (Ginkgo
    amgx_pgm with deterministic matching): each unaggregated vertex pairs
    with its strongest unaggregated neighbour; leftovers join their
    strongest neighbour's aggregate; isolated vertices become singletons.
    Returns agg[i] = coarse index.  Through the native runtime
    (`native.pgm_aggregate`, one pass of compiled C++), as the reference
    calls its own; `pgm_aggregate_plain` where the runtime is unavailable."""
    n = a_csr.shape[0]
    nat = native.pgm_aggregate(n, a_csr.indptr.astype(np.int64), a_csr.indices,
                               np.abs(a_csr.data))
    if nat is not None:
        return nat[0].astype(np.int64)
    return pgm_aggregate_plain(a_csr)


def pgm_aggregate_plain(a_csr) -> np.ndarray:
    """`pgm_aggregate` as a pure-Python loop: O(nnz) interpreted steps, the
    plain version the native call is held to."""
    n = a_csr.shape[0]
    indptr, indices, data = a_csr.indptr, a_csr.indices, np.abs(a_csr.data)
    agg = np.full(n, -1, np.int64)
    nc = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        best, best_w = -1, 0.0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j != i and agg[j] < 0 and data[p] > best_w:
                best, best_w = j, data[p]
        if best >= 0:
            agg[i] = agg[best] = nc
            nc += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        best, best_w = -1, 0.0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j != i and agg[j] >= 0 and data[p] > best_w:
                best, best_w = j, data[p]
        if best >= 0:
            agg[i] = agg[best]
        else:
            agg[i] = nc
            nc += 1
    return agg


def natural_aggregate(n: int, width: int = 2) -> np.ndarray:
    """Group `width` consecutive rows: aggregate c = {w·c, …, w·c+w−1}."""
    return np.arange(n, dtype=np.int64) // width


def grid_dims_of(offsets, n: int):
    """(nz, ny, nx) of a lexicographic box-grid stencil operator from its
    diagonal offsets ({0, ±1, ±nx, ±nx·ny}, or the 2-D / 1-D subsets), or
    None when the offsets are not of that form or n does not factor."""
    pos = sorted(o for o in offsets if o > 0)
    neg = sorted(-o for o in offsets if o < 0)
    if pos != neg or len(pos) > 3 or 0 not in offsets:
        return None
    if not pos:
        return None
    if pos[0] != 1:
        return None
    if len(pos) == 1:
        return (1, 1, n)
    nx = pos[1]
    if len(pos) == 2:
        if n % nx:
            return None
        return (1, n // nx, nx)
    s2 = pos[2]
    if s2 % nx or n % s2:
        return None
    return (n // s2, s2 // nx, nx)


def grid_aggregate(dims):
    """2×-per-axis block aggregation of a (nz, ny, nx) lexicographic grid
    (rate 8 in 3-D, 4 in 2-D); odd axes get a trailing partial block.
    Returns (agg ids, coarse dims)."""
    nz, ny, nx = dims
    n = nz * ny * nx
    i = np.arange(n, dtype=np.int64)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    nxc = (nx + 1) // 2 if nx > 1 else 1
    nyc = (ny + 1) // 2 if ny > 1 else 1
    nzc = (nz + 1) // 2 if nz > 1 else 1
    cx = np.minimum(ix // 2, nxc - 1) if nx > 1 else ix * 0
    cy = np.minimum(iy // 2, nyc - 1) if ny > 1 else iy * 0
    cz = np.minimum(iz // 2, nzc - 1) if nz > 1 else iz * 0
    agg = (cz * nyc + cy) * nxc + cx
    return agg, (nzc, nyc, nxc)


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the hierarchy, on the device.  `transfer` (and with it
    `agg`) is set for pgm aggregation only (natural and grid transfers are
    reshapes); `data_s` (the smoother's coefficients, in the format's own
    layout) on every level but the coarsest; `coarse_inv` on the coarsest
    when the direct solve applies, else `matvec`, its SpMV kernel, for the
    coarse CG."""

    n: int
    nc: int  # coarse rows; 0 on the coarsest level
    mat: Dia | Gdia | Ell  # float32 level operator
    inv_diag: torch.Tensor  # (n,) float32
    # the level's smoother plan: Dia the CgKernels plan (ksweep/kresid),
    # Gdia and Ell their kernels/amg_level.py smoother (sweep/resid)
    kern: CgKernels | GdiaSmoother | EllSmoother
    transfer: PgmTransfer | None = None  # the pgm transfer kernels and their table
    natural: bool = False
    grid: tuple | None = None  # (nz, ny, nx, nzc, nyc, nxc)
    width: int = 2  # natural aggregate size
    data_s: torch.Tensor | None = None  # smoother coefficients (Dia (nd, n))
    coarse_inv: torch.Tensor | None = None  # (n, n) float32
    matvec: object = None  # the coarsest level's SpMV without a dense inverse

    @property
    def agg(self) -> torch.Tensor | None:
        """(n,) int32 coarse ids of a pgm level, else None."""
        return None if self.transfer is None else self.transfer.agg


def smoother_plan(mat) -> CgKernels | GdiaSmoother | EllSmoother:
    """The smoother plan of a level operator's format."""
    if isinstance(mat, Dia):
        return CgKernels(mat.shape[0], mat.offsets, mat.data.device)
    if isinstance(mat, Gdia):
        return GdiaSmoother(mat)
    if isinstance(mat, Ell):
        return EllSmoother(mat)
    raise TypeError(f"no AMG smoother for a {type(mat).__name__} level operator")


def make_level(mat, inv_diag, nc: int, *, agg=None, natural=False, grid=None,
               width=2, coarse_inv=None, smoother_dtype=torch.bfloat16) -> Level:
    """A Level from its operator (Dia, Gdia or Ell) and host (numpy) arrays,
    copied to the operator's device; packs the smoother coefficients when
    nc > 0 and, for pgm aggregates, builds the transfers' table."""
    kern = smoother_plan(mat)
    device = kern.device
    last = nc == 0
    return Level(
        n=mat.shape[0], nc=nc, mat=mat, kern=kern,
        inv_diag=torch.tensor(np.asarray(inv_diag), device=device),
        transfer=None if agg is None else PgmTransfer(agg, nc, device),
        natural=natural, grid=None if grid is None else tuple(int(g) for g in grid),
        width=width,
        data_s=None if last else kern.pack_values(mat, dtype=smoother_dtype),
        coarse_inv=None if coarse_inv is None else torch.tensor(
            np.asarray(coarse_inv), device=device),
        matvec=spmv.matvec(mat) if last and coarse_inv is None else None)


def _gdia_planes(rows: np.ndarray, cols: np.ndarray) -> int:
    """Planes of the reference's Gdia packing (kernels/gdia.py gdia_layout):
    summed over the 128-row block offsets q, the most entries one row has
    at q.  The entries come row-major with ascending columns, so each
    row's entries at one q form a run: one pass, no sort."""
    if not len(rows):
        return 0
    q = cols // LANES - rows // LANES
    starts = np.flatnonzero(np.r_[True, (np.diff(rows) != 0) | (np.diff(q) != 0)])
    runs = np.diff(np.r_[starts, len(q)])
    qs = q[starts] - q.min()
    most = np.zeros(int(qs.max()) + 1, np.int64)
    np.maximum.at(most, qs, runs)
    return int(most.sum())


def _ell_of(a_csr, dtype, device) -> Dia | Gdia | Ell:
    """The level operator in the reference's format (its `_ell_of`): Dia
    when it has at most 64 distinct offsets, else Gdia when it packs in at
    most GDIA_MAX_PLANES planes (counted first, without the packing), else
    the port's slot-major Ell."""
    a_csr.sort_indices()
    a = a_csr.tocoo()
    coo = Coo(rows=a.row.astype(np.int32, copy=False),
              cols=a.col.astype(np.int32, copy=False),
              vals=a.data.astype(dtype, copy=False), shape=a.shape)
    n = a.shape[0]
    diffs = np.subtract(coo.cols, coo.rows, dtype=np.int64)
    present = np.zeros(2 * n - 1, np.bool_)
    present[diffs + (n - 1)] = True
    if int(present.sum()) <= MAX_DIAGS:
        return coo_to_dia(coo, device)
    if _gdia_planes(coo.rows.astype(np.int64), coo.cols.astype(np.int64)) <= GDIA_MAX_PLANES:
        return gdia_from_coo(coo, max_planes=GDIA_MAX_PLANES, device=device)
    return coo_to_ell(coo, device=device)


def build_hierarchy(coo: Coo, max_levels: int, min_coarse_rows: int,
                    aggregation: str = "natural", width: int = 2,
                    coarse_solver: str = "direct",
                    device: torch.device | str = "cpu",
                    smoother_dtype: torch.dtype = torch.bfloat16) -> list[Level]:
    """The level list, finest first, on `device` (reference
    build_hierarchy, amg.py:187-298)."""
    import scipy.sparse as sp

    rows = np.asarray(coo.rows)
    cols = np.asarray(coo.cols)
    vals = np.asarray(coo.vals)
    dtype = vals.dtype
    a = sp.csr_matrix((vals, (rows, cols)), shape=coo.shape)
    natural = aggregation == "natural"
    grid_dims = None
    if aggregation in ("auto", "grid"):
        diffs = np.unique(np.subtract(cols, rows, dtype=np.int64))
        grid_dims = grid_dims_of([int(d) for d in diffs], a.shape[0])
        natural = grid_dims is None

    # a direct coarse solve ends the coarsening as soon as the dense block
    # is small enough (min_coarse_rows stays a lower bound)
    stop_rows = min_coarse_rows
    if coarse_solver == "direct":
        n0 = a.shape[0]
        stop_rows = max(min_coarse_rows, min(DENSE_COARSE_MAX // 2, n0 // 16))

    levels: list[Level] = []
    for _ in range(max_levels):
        n = a.shape[0]
        if n <= stop_rows:
            break
        gtuple = None
        if grid_dims is not None:
            agg, coarse_dims = grid_aggregate(grid_dims)
            gtuple = tuple(grid_dims) + tuple(coarse_dims)
        elif natural:
            agg = natural_aggregate(n, width)
        else:
            agg = pgm_aggregate(a)
        nc = int(agg.max()) + 1
        if nc >= n:  # no coarsening progress
            break
        d = a.diagonal()
        d = np.where(np.abs(d) > 1e-300, d, 1.0)
        levels.append(make_level(
            _ell_of(a, dtype, device), (1.0 / d).astype(dtype), nc,
            agg=None if (natural or gtuple is not None) else agg,
            natural=natural, grid=gtuple, width=width, smoother_dtype=smoother_dtype))
        if grid_dims is not None:
            grid_dims = coarse_dims
        # Galerkin product with a one-hot P: A_c[agg[r], agg[c]] += A[r, c]
        ac = a.tocoo()
        a = sp.csr_matrix((ac.data, (agg[ac.row], agg[ac.col])), shape=(nc, nc))
        a.sum_duplicates()
    d = a.diagonal()
    d = np.where(np.abs(d) > 1e-300, d, 1.0)
    n_c = a.shape[0]
    coarse_inv = None
    if coarse_solver == "direct" and n_c <= DENSE_COARSE_MAX:
        dense = a.toarray().astype(np.float64)
        # pure-Neumann pressure systems are singular up to the constant
        # vector: fall back to the pseudo-inverse
        try:
            inv = np.linalg.inv(dense)
            if not np.all(np.isfinite(inv)):
                raise np.linalg.LinAlgError
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(dense, rcond=1e-12)
        coarse_inv = inv.astype(dtype)
    levels.append(make_level(_ell_of(a, dtype, device), (1.0 / d).astype(dtype), 0,
                             coarse_inv=coarse_inv))
    return levels


# ---- transfers (piecewise-constant P; restrict is its transpose) --------


def _block_shape(g):
    nz, ny, nx, nzc, nyc, nxc = g
    return (2 if nz > 1 else 1), (2 if ny > 1 else 1), (2 if nx > 1 else 1)


def grid_restrict(g, r: torch.Tensor) -> torch.Tensor:
    """Block sums over the 2× blocks of a grid level (odd axes zero-padded)."""
    nz, ny, nx, nzc, nyc, nxc = g
    bz, by, bx = _block_shape(g)
    r3 = r.reshape(nz, ny, nx)
    pad = (0, bx * nxc - nx, 0, by * nyc - ny, 0, bz * nzc - nz)
    if any(pad):
        r3 = torch.nn.functional.pad(r3, pad)
    return r3.reshape(nzc, bz, nyc, by, nxc, bx).sum(dim=(1, 3, 5)).reshape(-1)


def grid_prolong(g, ec: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant injection, the transpose of grid_restrict."""
    nz, ny, nx, nzc, nyc, nxc = g
    bz, by, bx = _block_shape(g)
    e = ec.reshape(nzc, 1, nyc, 1, nxc, 1).expand(nzc, bz, nyc, by, nxc, bx)
    return e.reshape(nzc * bz, nyc * by, nxc * bx)[:nz, :ny, :nx].reshape(-1)


def _restrict(lv: Level, r: torch.Tensor) -> torch.Tensor:
    if lv.grid is not None:
        return grid_restrict(lv.grid, r)
    if lv.natural:
        pad = lv.width * lv.nc - lv.n
        rp = torch.nn.functional.pad(r, (0, pad)) if pad else r
        return rp.reshape(lv.nc, lv.width).sum(dim=1)
    return lv.transfer.restrict(r)


def _prolong(lv: Level, ec: torch.Tensor) -> torch.Tensor:
    """P e_c (the cycle adds it to x through `_prolong_add`)."""
    if lv.grid is not None:
        return grid_prolong(lv.grid, ec)
    if lv.natural:
        return ec[:, None].expand(lv.nc, lv.width).reshape(-1)[: lv.n]
    return ec.index_select(0, lv.agg)


def _prolong_add(lv: Level, x: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
    """x + P e_c: the pgm transfer kernel's gather and add on a pgm level."""
    if lv.transfer is not None:
        return lv.transfer.prolong_add(x, ec)
    return x + _prolong(lv, ec)


# ---- smoother passes -------------------------------------------------------


def _sweep(lv: Level, x: torch.Tensor, b: torch.Tensor, relax: float) -> torch.Tensor:
    """x + relax·invd ⊙ (b − A x) through the level format's smoother."""
    if isinstance(lv.kern, CgKernels):
        return lv.kern.ksweep(lv.data_s, x, b, lv.inv_diag, relax)
    return lv.kern.sweep(lv.data_s, x, b, lv.inv_diag, relax)


def _resid(lv: Level, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b − A x through the level format's smoother."""
    if isinstance(lv.kern, CgKernels):
        return lv.kern.kresid(lv.data_s, x, b)
    return lv.kern.resid(lv.data_s, x, b)


# ---- coarse solve and cycle ---------------------------------------------


def cg_fixed_iters(apply_fn, b: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` CG steps from a zero guess, breakdown-guarded; no host read."""
    tiny = 1e-30
    x = torch.zeros_like(b)
    r, p = b, b
    rho = torch.sum(b * b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        q = apply_fn(p)
        pq = torch.sum(p * q)
        ok = torch.abs(pq) > tiny
        alpha = torch.where(ok, rho / torch.where(ok, pq, one), 0.0)
        x = x + alpha * p
        r = r - alpha * q
        rho_new = torch.sum(r * r)
        ok = rho > tiny
        beta = torch.where(ok, rho_new / torch.where(ok, rho, one), 0.0)
        p = r + beta * p
        rho = rho_new
    return x


def _coarse_solve(lv: Level, b: torch.Tensor, iters: int) -> torch.Tensor:
    if lv.coarse_inv is not None:
        return torch.mv(lv.coarse_inv, b)
    return cg_fixed_iters(lv.matvec, b, iters)


class AmgOp(PrecondOp):
    """The AMG cycle as a PrecondOp (state: the levels), with the settings
    it runs at — `cycle`, `relax`, `smooth_iters`, `coarse_solver_iters` —
    so that the device V-cycle reads the values the host cycle uses, and
    `loop_table`, the device loop's level table (kernels/amg_loop.py
    `table_of`), built at its first use: it belongs to this hierarchy and
    goes with it when a changed operator rebuilds the hierarchy."""

    def __init__(self, apply_fn, levels, cycle: str, relax: float, smooth_iters: int,
                 coarse_solver_iters: int):
        super().__init__(apply_fn, tuple(levels))
        self.cycle = cycle
        self.relax = float(relax)
        self.smooth_iters = int(smooth_iters)
        self.coarse_solver_iters = int(coarse_solver_iters)
        self.loop_table = None


def cycle_op(levels, cycle: str = "v", relax: float = 0.9, smooth_iters: int = 2,
             coarse_solver_iters: int = 4) -> AmgOp:
    """The preconditioner: one `cycle` from a zero guess over `levels`."""
    n_levels = len(levels)

    def sweeps(lv: Level, x, b, k: int):
        for _ in range(k):
            x = _sweep(lv, x, b, relax)
        return x

    def run_level(lvls, li: int, b, w_mode: bool):
        lv = lvls[li]
        if li == n_levels - 1:
            return _coarse_solve(lv, b, coarse_solver_iters)
        recurse = 2 if (w_mode and li < n_levels - 2) else 1
        # pre-smooth from the zero guess: the first sweep needs no A x
        if smooth_iters > 0:
            x = sweeps(lv, relax * lv.inv_diag * b, b, smooth_iters - 1)
        else:
            x = torch.zeros_like(b)
        for cyc in range(recurse):
            r = _resid(lv, x, b)
            ec = run_level(lvls, li + 1, _restrict(lv, r),
                           w_mode or (cycle == "f" and cyc == 0))
            x = sweeps(lv, _prolong_add(lv, x, ec), b, smooth_iters)
        return x

    def apply(lvls, r):
        return run_level(lvls, 0, r, cycle == "w")

    return AmgOp(apply, levels, cycle, relax, smooth_iters, coarse_solver_iters)


def amg(coo: Coo, device: torch.device | str = "cpu", max_levels: int = 9,
        min_coarse_rows: int = 10, cycle: str = "v", coarse_solver_iters: int = 4,
        relax: float = 0.9, smooth_iters: int = 2, aggregation: str = "natural",
        width: int = 8, coarse_solver: str = "direct",
        smoother_dtype: torch.dtype = torch.bfloat16):
    """Build the hierarchy of `coo` on `device` and return its cycle as an
    AmgOp (state: the levels)."""
    levels = build_hierarchy(coo, max_levels, min_coarse_rows, aggregation,
                             width=width, coarse_solver=coarse_solver, device=device,
                             smoother_dtype=smoother_dtype)
    return cycle_op(levels, cycle, relax, smooth_iters, coarse_solver_iters)
