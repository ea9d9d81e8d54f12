"""Incomplete-factorisation preconditioners: ILU(0), ILUT, IC(0), ICT (and
IRILU, ILU(0) with 5 sweeps) — reference Preconditioner.H:106-225, Ginkgo
factorization::{Ilu,ParIlut,Ic,ParIct} + preconditioner::{Ilu,Ic}.

Counterpart: ogl_tpu/precond/ilu.py.  The factorisations are one-time host
set-up, the reference's code over the port's native runtime
(ogl_tpu_torch/native: `ilu0_csr`, `ic0_csr`, `ilut_triples`,
`ict_triples`, bit-equal to the reference's library), with the
reference's NumPy, SciPy and pure-Python fallbacks.  The apply is
kernels/tri_solve.py: kernel 1 (`tri_sweep`) runs `sweeps` Jacobi sweeps of
each factor,

  ILU:  z ← r − L z  (z₀ = r),         x ← (z − U x)·u⁻¹  (x₀ = z·u⁻¹)
  IC:   z ← (r − L z)·d⁻¹ (z₀ = r·d⁻¹),  x ← (z − Lᵀ x)·d⁻¹ (x₀ = z·d⁻¹)

and under `triSolve exact` kernel 2 (`tri_levels`) computes exact forward
and backward substitution level by level — the function the reference
computes by running the same sweep to each factor's dependency depth
(`factor_depth`, :17-28 there).

Deliberate differences (ROADMAP.md §C):
  * the factors live on the device as Csr, one lane per row (the reference
    packs each with `pack_fast`, :233-239): one body for every mesh, and no
    Xell packing of a factor on the host;
  * exact mode walks the levels (one pass over each factor, a grid barrier
    per level) instead of depth-many sweeps; the values are the sweep's to
    the bit (tests/test_torch_ilu.py);
  * `factor_depth` takes one pass over the rows (the native `tri_levels`),
    where the reference's fixpoint costs O(depth·nnz); the value is the
    reference's, and the same pass gives the level of every row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ogl_tpu_torch.core.formats import Coo
from ogl_tpu_torch.kernels.tri_solve import Triangle, tri_levels, tri_sweep, triangle

__all__ = ["ilu0", "ilut", "ic0", "ict", "ilu0_factors", "ic0_factor", "ilut_factors",
           "ict_factor", "factor_depth", "factor_levels", "state_from_factors", "IluState",
           "apply"]


def factor_levels(rows, cols, n: int) -> np.ndarray:
    """The dependency level of every row of a strict triangular factor
    (int64 (n,)): 0 for a row without entries, else 1 + the largest level
    of its sources.  One pass (the native `tri_levels`); without the native
    runtime, or for entries on both sides of the diagonal, the reference's
    fixpoint."""
    from ogl_tpu_torch import native

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    try:
        nat = native.tri_levels(rows, cols, n)
    except ValueError:
        nat = None
    if nat is not None:
        return nat.astype(np.int64)
    level = np.zeros(n, np.int64)
    if not len(rows):
        return level
    for _ in range(n):
        new = level.copy()
        np.maximum.at(new, rows, level[cols] + 1)
        if np.array_equal(new, level):
            break
        level = new
    return level


def factor_depth(rows, cols, n: int) -> int:
    """Dependency depth of a strict triangular factor: the sweep count at
    which the Jacobi apply equals exact substitution (the reference's
    value: at least 1)."""
    if not len(rows):
        return 1
    return max(int(factor_levels(rows, cols, n).max()), 1)


def _host_csr(coo: Coo):
    """Host CSR with duplicate (row, col) entries SUMMED, as every other
    consumer of the COO sums them (a row-major sorted COO without
    duplicates, as the foam layer's, skips the sort)."""
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols).astype(np.int64)
    vals = np.asarray(coo.vals).astype(np.float64)
    n = coo.shape[0]
    keys = rows * n + cols
    if np.any(keys[1:] <= keys[:-1]):  # unsorted or duplicated: sort, sum
        order = np.argsort(keys, kind="stable")
        uk, starts = np.unique(keys[order], return_index=True)
        vals = np.add.reduceat(vals[order], starts)
        rows = (uk // n).astype(np.int64)
        cols = (uk % n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return n, indptr, cols, vals


def ilu0_factors(coo: Coo):
    """IKJ-ordered ILU(0) on the host (native C++ when available); returns
    (L_strict, U_strict, u_diag) as (rows, cols, vals) triples / vector."""
    from ogl_tpu_torch import native

    n, indptr, cols, vals = _host_csr(coo)
    a = native.ilu0_csr(n, indptr, cols, vals)
    if a is None:
        a = vals.copy()
        col_pos = [dict(zip(cols[indptr[i]:indptr[i + 1]], range(indptr[i], indptr[i + 1])))
                   for i in range(n)]
        for i in range(n):
            s, e = indptr[i], indptr[i + 1]
            for kk in range(s, e):
                k = cols[kk]
                if k >= i:
                    break
                dk = col_pos[k].get(k)
                a[kk] = a[kk] / a[dk]
                lik = a[kk]
                for jj in range(col_pos[k][k] + 1, indptr[k + 1]):
                    tgt = col_pos[i].get(cols[jj])
                    if tgt is not None:
                        a[tgt] -= lik * a[jj]
    rows_full = np.repeat(np.arange(n), np.diff(indptr))
    lower = rows_full > cols
    upper = rows_full < cols
    diag = rows_full == cols
    udiag = np.zeros(n)
    udiag[rows_full[diag]] = a[diag]
    return ((rows_full[lower], cols[lower], a[lower]),
            (rows_full[upper], cols[upper], a[upper]), udiag)


def ic0_factor(coo: Coo):
    """IC(0): A ≈ L Lᵀ on the lower-triangular pattern of A (native C++
    when available); returns ((rows, cols, vals) of strict L, diag(L))."""
    from ogl_tpu_torch import native

    n, indptr, cols, vals = _host_csr(coo)
    if native.available():
        rows_full = np.repeat(np.arange(n), np.diff(indptr))
        low = cols <= rows_full
        lcols = cols[low].astype(np.int32)
        lptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows_full[low], minlength=n), out=lptr[1:])
        lv = native.ic0_csr(n, lptr, lcols, vals[low])
        lr2 = np.repeat(np.arange(n), np.diff(lptr))
        dm = lr2 == lcols
        ldiag = np.zeros(n)
        ldiag[lr2[dm]] = lv[dm]
        strict = ~dm
        return (lr2[strict], lcols[strict].astype(np.int64), lv[strict]), ldiag

    lrow: list[dict[int, float]] = [dict() for _ in range(n)]
    ldiag = np.zeros(n)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = cols[p]
            if j > i:
                break
            s = 0.0
            li, lj = lrow[i], lrow[j]
            if len(li) < len(lj):
                for kk, v in li.items():
                    if kk < j:
                        w = lj.get(kk)
                        if w is not None:
                            s += v * w
            else:
                for kk, w in lj.items():
                    if kk < j:
                        v = li.get(kk)
                        if v is not None:
                            s += v * w
            if j < i:
                lrow[i][j] = (vals[p] - s) / ldiag[j]
            else:
                d = vals[p] - sum(v * v for v in lrow[i].values())
                ldiag[i] = np.sqrt(max(d, 1e-300))
    return _triples(lrow), ldiag


def _triples(lrow):
    rws, cls, vls = [], [], []
    for i, row in enumerate(lrow):
        for j, v in row.items():
            rws.append(i)
            cls.append(j)
            vls.append(v)
    return np.array(rws, np.int64), np.array(cls, np.int64), np.array(vls)


def ilut_factors(coo: Coo, drop_tol: float = 1e-3, fill_factor: float = 2.0):
    """Threshold ILU factors ((L_strict), (U_strict), udiag): native C++
    when available (row-wise IKJ with dual dropping, the ParIlut role),
    SuperLU ILUTP (pivoting disabled) otherwise; ILU(0) as last resort."""
    from ogl_tpu_torch import native

    n, indptr, cols, vals = _host_csr(coo)
    try:
        nat = native.ilut_triples(n, indptr, cols, vals, drop_tol=drop_tol,
                                  fill_factor=fill_factor)
    except RuntimeError:
        nat = None
    if nat is not None:
        (tr, tc, tv), ud = nat
        lm = tr > tc
        um = tr < tc
        return ((tr[lm].astype(np.int64), tc[lm].astype(np.int64), tv[lm]),
                (tr[um].astype(np.int64), tc[um].astype(np.int64), tv[um]), ud)

    import scipy.sparse as sp
    from scipy.sparse.linalg import spilu

    a = sp.csr_matrix((vals, cols, indptr), shape=coo.shape).tocsc()
    try:
        f = spilu(a, drop_tol=drop_tol, fill_factor=fill_factor, permc_spec="NATURAL",
                  diag_pivot_thresh=0.0, options={"ILU_MILU": "SILU"})
        if not (np.array_equal(f.perm_r, np.arange(n))
                and np.array_equal(f.perm_c, np.arange(n))):
            raise RuntimeError("spilu produced a nontrivial permutation")
        L, U = f.L.tocoo(), f.U.tocoo()
    except Exception:
        return ilu0_factors(coo)
    lm = L.row > L.col
    um = U.row < U.col
    dm = U.row == U.col
    ud = np.zeros(n)
    ud[U.row[dm]] = U.data[dm]
    return ((L.row[lm].astype(np.int64), L.col[lm].astype(np.int64), L.data[lm]),
            (U.row[um].astype(np.int64), U.col[um].astype(np.int64), U.data[um]), ud)


def ict_factor(coo: Coo, drop_tol: float = 1e-3):
    """Threshold IC factor (ParIct equivalent): left-looking row Cholesky
    with fill-in, dropping computed entries with |l_ij| ≤ drop_tol·√(a_ii·a_jj)
    unless (i, j) is in A's pattern.  Returns ((rows, cols, vals), ldiag).
    Native C++ when available; the reference's pure-Python path otherwise."""
    import heapq

    from ogl_tpu_torch import native

    n, indptr, cols, vals = _host_csr(coo)
    try:
        nat = native.ict_triples(n, indptr, cols, vals, drop_tol=drop_tol)
    except RuntimeError:
        nat = None
    if nat is not None:
        (tr, tc, tv), ld = nat
        return (tr.astype(np.int64), tc.astype(np.int64), tv), ld
    rows_full = np.repeat(np.arange(n), np.diff(indptr))
    diag = np.zeros(n)
    dm = rows_full == cols
    diag[rows_full[dm]] = vals[dm]
    scale = np.sqrt(np.maximum(np.abs(diag), 1e-300))
    ldiag = np.zeros(n)
    l_cols: list[list[int]] = [[] for _ in range(n)]  # column k -> rows j (asc)
    l_colv: list[list[float]] = [[] for _ in range(n)]
    lrow: list[dict[int, float]] = [dict() for _ in range(n)]
    arow_lower: list[dict[int, float]] = [dict() for _ in range(n)]
    for p in range(len(vals)):
        if cols[p] <= rows_full[p]:
            arow_lower[rows_full[p]][cols[p]] = vals[p]
    for i in range(n):
        w = dict(arow_lower[i])  # working row over columns <= i (may fill)
        heap = [k for k in w if k < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            k = heapq.heappop(heap)
            lik = w[k] / ldiag[k]
            if (k in arow_lower[i]) or abs(lik) > drop_tol * scale[i] * scale[k]:
                lrow[i][k] = lik
                for j, ljk in zip(l_cols[k], l_colv[k]):
                    if k < j < i:
                        if j in w:
                            w[j] -= lik * ljk
                        else:
                            w[j] = -lik * ljk
                            if j not in seen:
                                heapq.heappush(heap, j)
                                seen.add(j)
        d = arow_lower[i].get(i, 0.0) - sum(v * v for v in lrow[i].values())
        ldiag[i] = np.sqrt(max(d, 1e-300))
        for k, v in lrow[i].items():
            l_cols[k].append(i)
            l_colv[k].append(v)
    return _triples(lrow), ldiag


# ---- the device state and its apply -----------------------------------------


@dataclasses.dataclass(eq=False)
class IluState:
    """The apply's state: the lower and upper Triangles (kernels/tri_solve.py)
    on one device, `exact` (the level route), and the count of applies made
    through `apply` (what a solve's launches are held to)."""

    lower: Triangle
    upper: Triangle
    exact: bool
    applies: int = 0


def apply(state: IluState, r: torch.Tensor) -> torch.Tensor:
    """M⁻¹ r: one launch of kernel 2 (exact) or kernel 1 on a CUDA r, their
    twins on a CPU r."""
    state.applies += 1
    if state.exact:
        return tri_levels(state.lower, state.upper, r)
    return tri_sweep(state.lower, state.upper, r)


def state_from_factors(lower, upper, diag, kind: str, device, sweeps: int = 8,
                       exact: bool = False) -> IluState:
    """The apply state from host factors: `lower` and `upper` (rows, cols,
    vals) triples of the strict factors (IC: `upper` None, Lᵀ built from
    `lower`), `diag` diag(U) for kind "lu" or diag(L) for "ic", as the
    reference's factorisations return them; the scales are 1/diag computed
    in float64 and stored float32, as the reference stores them."""
    if kind not in ("lu", "ic"):
        raise ValueError(f"kind {kind!r}: 'lu' or 'ic'")
    lr, lc, lv = (np.asarray(a) for a in lower)
    n = len(diag)
    inv = 1.0 / np.asarray(diag, np.float64)
    if kind == "ic":
        ur, uc, uv = lc, lr, lv  # strict upper = Lᵀ strict
    else:
        ur, uc, uv = (np.asarray(a) for a in upper)
    lo = triangle(lr, lc, lv, n, inv if kind == "ic" else None, sweeps,
                  factor_levels(lr, lc, n), device)
    up = triangle(ur, uc, uv, n, inv, sweeps, factor_levels(ur, uc, n), device)
    return IluState(lower=lo, upper=up, exact=exact)


def _op(state: IluState):
    from ogl_tpu_torch.precond import PrecondOp

    return PrecondOp(apply, state)


def ilu0(coo: Coo, device, sweeps: int = 8, exact: bool = False):
    """ILU(0) (and IRILU: sweeps 5, never exact)."""
    lower, upper, ud = ilu0_factors(coo)
    return _op(state_from_factors(lower, upper, ud, "lu", device, sweeps, exact))


def ilut(coo: Coo, device, sweeps: int = 8, drop_tol: float = 1e-3,
         fill_factor: float = 2.0, exact: bool = False):
    """Threshold ILU (the reference's drop_tol 1e-3, fill_factor 2.0)."""
    lower, upper, ud = ilut_factors(coo, drop_tol, fill_factor)
    return _op(state_from_factors(lower, upper, ud, "lu", device, sweeps, exact))


def ic0(coo: Coo, device, sweeps: int = 8, exact: bool = False):
    lower, ld = ic0_factor(coo)
    return _op(state_from_factors(lower, None, ld, "ic", device, sweeps, exact))


def ict(coo: Coo, device, sweeps: int = 8, drop_tol: float = 1e-3, exact: bool = False):
    """Threshold IC (the reference's drop_tol 1e-3)."""
    lower, ld = ict_factor(coo, drop_tol)
    return _op(state_from_factors(lower, None, ld, "ic", device, sweeps, exact))
