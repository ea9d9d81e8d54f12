"""ISAI — incomplete sparse approximate inverse ("ISAI"/"GISAI", reference
Preconditioner.H:226-259, Ginkgo gko::preconditioner::Isai).

Counterpart: ogl_tpu/precond/isai.py.  For each row i, M is supported on
the sparsity J_i of A^p (p = sparsityPower) and chosen so that
(M A)|_{J_i} = e_i|_{J_i}:

    M[i, J_i] · A[J_i, J_i] = e_i[J_i]   ⇒   A[J_i, J_i]ᵀ m = e_i

Set-up on the host: the native runtime (ogl_tpu_torch/native,
`isai_build`) solves the n small k x k systems one row at a time in
float64; without it the reference's NumPy path runs (an (n, k, k) batch,
its zero-diagonal identity guard, LAPACK).  M is packed like a matrix by
kernels/spmv.py `pack_fast` (Dia → Gdia → Xell → Ell) and applied through
`spmv.matvec`, so the apply runs on the port's hand-written SpMVs.  The spd
variant (`ISAI`) applies ½(M r + Mᵀ r), Mᵀ packed the same way, so CG sees
a symmetric operator.
"""

from __future__ import annotations

import warnings

import numpy as np

from ogl_tpu_torch.core.formats import Coo

__all__ = ["isai", "isai_triples", "WIDE_PATTERN"]

# the widest pattern row (k) above which the set-up names its host memory
WIDE_PATTERN = 32


def _pattern_power(rows, cols, n, p: int):
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    s = a.copy()
    for _ in range(p - 1):
        s = (s @ a).tocsr()
        s.data[:] = 1
    s = (s + sp.identity(n, np.int8, format="csr")).tocsr()
    s.data[:] = 1
    s.sort_indices()
    return s


def _warn_wide(n: int, k: int, p: int, native_path: bool) -> None:
    """At k > WIDE_PATTERN the set-up's host memory is named, not swapped into."""
    if k <= WIDE_PATTERN:
        return
    if native_path:
        need = n * k * (4 + 1 + 4)  # J, valid, M
        what = "J, valid and M of (n, k)"
    else:
        need = n * k * k * (4 + 8 + 8) + n * k * 16  # G, keys, lookups; e, J
        what = "the NumPy path's (n, k, k) batch and its int64 key arrays"
    warnings.warn(
        f"ISAI sparsityPower {p}: the widest pattern row holds k = {k} entries (above "
        f"{WIDE_PATTERN}); the set-up will hold about {need / 2**30:.2f} GiB of host memory "
        f"for {what}", RuntimeWarning, stacklevel=3)


def isai_triples(coo: Coo, sparsity_power: int = 1):
    """The approximate inverse M as host COO triples (rows, cols, vals)."""
    from ogl_tpu_torch import native

    import scipy.sparse as sp

    n = coo.shape[0]
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols).astype(np.int64)
    vals = np.asarray(coo.vals)

    s = _pattern_power(rows, cols, n, sparsity_power)
    counts = np.diff(s.indptr)
    k = int(counts.max())
    _warn_wide(n, k, sparsity_power, native.available())

    # float32 end to end, as the reference extracts (Ginkgo extracts in the
    # value type)
    a = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, n))
    a.sort_indices()
    nat = native.isai_build(n, a.indptr.astype(np.int64), a.indices, a.data,
                            s.indptr.astype(np.int64), s.indices, k)
    if nat is not None:
        # the native path solved the k x k systems in place: assemble directly
        J, valid, m_rows = nat
        m_rows = m_rows.astype(vals.dtype, copy=False)
        mrows_all = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
        vmask = valid.reshape(-1)
        return (mrows_all.reshape(-1)[vmask], J.reshape(-1)[vmask],
                m_rows.reshape(-1)[vmask])

    # padded per-row column sets J_i (pad with the row itself; padded
    # positions get identity rows/cols in G so they solve to 0 coupling)
    J = np.repeat(np.arange(n)[:, None], k, axis=1)
    slot = np.arange(len(s.indices)) - np.repeat(s.indptr[:-1], counts)
    row_of = np.repeat(np.arange(n), counts)
    J[row_of, slot] = s.indices
    valid = np.zeros((n, k), bool)
    valid[row_of, slot] = True

    # G[i] = A[J_i, J_i] via a sorted (row*n+col) -> val lookup; duplicate
    # (row, col) entries sum, as every other consumer of the COO sums them
    keys = rows * n + cols
    order_k = np.argsort(keys)
    keys_sorted, starts = np.unique(keys[order_k], return_index=True)
    vals_sorted = np.add.reduceat(vals[order_k], starts)
    q = (J[:, :, None].astype(np.int64) * n + J[:, None, :]).reshape(-1)
    idx = np.searchsorted(keys_sorted, q)
    idx = np.clip(idx, 0, len(keys_sorted) - 1)
    hit = keys_sorted[idx] == q
    G = np.where(hit, vals_sorted[idx], 0.0).reshape(n, k, k).astype(np.float32)
    pad = ~valid
    eye = np.eye(k, dtype=bool)[None]
    G = np.where((pad[:, :, None] | pad[:, None, :]) & ~eye, 0.0, G)
    G = np.where(pad[:, :, None] & eye, 1.0, G)
    e = np.zeros((n, k), np.float32)
    pos = np.argmax(J == np.arange(n)[:, None], axis=1)
    e[np.arange(n), pos] = 1.0

    # rows whose own diagonal is zero (empty rows, structurally zero
    # diagonals) would make G singular: they get the identity action M[i] = e_i
    bad = (G[np.arange(n), pos, pos] == 0.0) | ~np.any(e != 0.0, axis=1)
    if bad.any():
        G[bad] = np.eye(k, dtype=G.dtype)
        e[bad] = 0.0
        e[bad, pos[bad]] = 1.0
        valid = valid.copy()
        valid[bad] = False
        valid[bad, pos[bad]] = True
    try:
        m_rows = np.linalg.solve(G.transpose(0, 2, 1), e[..., None]).squeeze(-1)
    except np.linalg.LinAlgError:
        # singular local blocks beyond the diagonal guard: least squares
        m_rows = np.einsum("nij,nj->ni", np.linalg.pinv(G.transpose(0, 2, 1)), e)
    m_rows = np.where(valid, m_rows, 0.0).astype(vals.dtype)

    mrows_all = np.repeat(np.arange(n)[:, None], k, axis=1)
    vmask = valid.reshape(-1)
    return (mrows_all.reshape(-1)[vmask], J.reshape(-1)[vmask], m_rows.reshape(-1)[vmask])


def isai(coo: Coo, device, sparsity_power: int = 1, spd: bool = False):
    """The ISAI PrecondOp: state (M,) or, spd, (M, Mᵀ), each a matrix of the
    format `pack_fast` picks, on `device`."""
    from ogl_tpu_torch.kernels import spmv
    from ogl_tpu_torch.precond import PrecondOp

    n = coo.shape[0]
    mr, mc, mv = isai_triples(coo, sparsity_power=sparsity_power)
    M = spmv.pack_fast(mr, mc, mv, n, device=device)
    apply_m = spmv.matvec(M)
    if not spd:
        return PrecondOp(lambda s, r: apply_m(r), (M,))
    Mt = spmv.pack_fast(mc, mr, mv, n, device=device)
    apply_mt = spmv.matvec(Mt)
    return PrecondOp(lambda s, r: 0.5 * (apply_m(r) + apply_mt(r)), (M, Mt))
