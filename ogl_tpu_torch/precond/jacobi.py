"""Scalar Jacobi ("BJ" with maxBlockSize 1, reference Preconditioner.H:
91-105, Ginkgo gko::preconditioner::Jacobi).

Counterpart: ogl_tpu/precond/jacobi.py (`diagonal_of`, and the bs == 1
branch of `block_jacobi`).  invd = 1/diag is computed on the host from the
host COO values and uploaded once per build; the apply is invd ⊙ r (the
merged CG reads invd directly in K2).  Blocked Jacobi (maxBlockSize > 1)
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core.formats import Coo

__all__ = ["block_jacobi", "diagonal_of"]


def diagonal_of(coo: Coo) -> np.ndarray:
    """Host-side diagonal extraction."""
    rows, cols, vals = (np.asarray(a) for a in (coo.rows, coo.cols, coo.vals))
    d = np.zeros(coo.shape[0], vals.dtype)
    on_diag = rows == cols
    np.add.at(d, rows[on_diag], vals[on_diag])
    return d


def block_jacobi(coo: Coo, block_size: int, device):
    from ogl_tpu_torch.precond import PrecondOp

    if int(block_size) != 1:
        raise NotImplementedError(
            f"BJ maxBlockSize {block_size}: only scalar Jacobi (maxBlockSize 1) "
            "is ported (ROADMAP.md A10)")
    inv_d = torch.tensor(1.0 / diagonal_of(coo), device=device)
    return PrecondOp(lambda s, r: s.to(r.dtype) * r, inv_d)
