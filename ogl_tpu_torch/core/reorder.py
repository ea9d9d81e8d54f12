"""Bandwidth-reducing renumbering (reverse Cuthill-McKee, SciPy).

Counterpart: ogl_tpu/core/reorder.py (`rcm_permutation`, `permute_coo`,
`bandwidth`), carried over on host numpy arrays.  OpenFOAM ships
renumberMesh for the same purpose; here it brings an unstructured mesh
into the band that the Gdia planes and the Xell window cover.
"""

from __future__ import annotations

import numpy as np

from ogl_tpu_torch.core.formats import Coo

__all__ = ["rcm_permutation", "permute_coo", "bandwidth"]


def rcm_permutation(coo: Coo) -> np.ndarray:
    """perm such that A[perm][:, perm] has reduced bandwidth; perm[k] is the
    original index of new row k."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = coo.shape[0]
    rows = np.asarray(coo.rows)
    cols = np.asarray(coo.cols)
    a = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))


def permute_coo(coo: Coo, perm: np.ndarray) -> Coo:
    """P A Pᵀ as row-major COO (x_new = x_old[perm])."""
    n = coo.shape[0]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    rows = inv[np.asarray(coo.rows)]
    cols = inv[np.asarray(coo.cols)]
    vals = np.asarray(coo.vals)
    order = np.lexsort((cols, rows))
    return Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
               vals=vals[order], shape=coo.shape)


def bandwidth(coo: Coo) -> int:
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols).astype(np.int64)
    return int(np.abs(rows - cols).max()) if len(rows) else 0
