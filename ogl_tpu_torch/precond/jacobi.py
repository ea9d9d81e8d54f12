"""Block Jacobi ("BJ", reference Preconditioner.H:91-105, Ginkgo
gko::preconditioner::Jacobi).

Counterpart: ogl_tpu/precond/jacobi.py (`diagonal_of`, `block_jacobi`).
maxBlockSize 1 is scalar Jacobi: invd = 1/diag, computed on the host from
the host COO values and uploaded once per build; the apply is invd ⊙ r (the
loop kernels read invd directly).  maxBlockSize bs > 1 takes uniform
contiguous blocks of bs rows, the last one padded with identity rows, as
the reference does: the blocks are assembled on the host (one bincount over
the in-block entries, duplicates summed, in float64), inverted once per
build in float64 and uploaded as float32, each block transposed (state
inv_t[b, k, i] = inv[b, i, k]); the apply is the hand-written kernel
kernels/block_jacobi.py `block_jacobi` (csrc/block_jacobi.cu).  The
reference assembles with np.add.at and inverts in the value type.
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core.formats import Coo

__all__ = ["block_jacobi", "block_inverses", "diagonal_of"]


def diagonal_of(coo: Coo) -> np.ndarray:
    """Host-side diagonal extraction."""
    rows, cols, vals = (np.asarray(a) for a in (coo.rows, coo.cols, coo.vals))
    d = np.zeros(coo.shape[0], vals.dtype)
    on_diag = rows == cols
    np.add.at(d, rows[on_diag], vals[on_diag])
    return d


def block_inverses(coo: Coo, bs: int) -> np.ndarray:
    """The (nb, bs, bs) float32 inverses of the diagonal blocks, each stored
    transposed (inv_t[b, k, i] = inv[b, i, k])."""
    n = coo.shape[0]
    nb = -(-n // bs)
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals, np.float64)
    same = rows // bs == cols // bs
    r, c = rows[same], cols[same]
    flat = (r // bs) * (bs * bs) + (r % bs) * bs + c % bs
    blocks = np.bincount(flat, weights=vals[same], minlength=nb * bs * bs).reshape(nb, bs, bs)
    # pad rows beyond n with identity so the batched inverse is well posed
    for i in range(nb * bs - n):
        blocks[nb - 1, bs - 1 - i, bs - 1 - i] = 1.0
    inv = np.linalg.inv(blocks)
    return np.ascontiguousarray(inv.transpose(0, 2, 1), np.float32)


def block_jacobi(coo: Coo, block_size: int, device):
    from ogl_tpu_torch.kernels.block_jacobi import MAX_BLOCK
    from ogl_tpu_torch.kernels.block_jacobi import block_jacobi as apply
    from ogl_tpu_torch.precond import PrecondOp

    bs = max(1, int(block_size))
    if bs == 1:
        inv_d = torch.tensor(1.0 / diagonal_of(coo), device=device)
        return PrecondOp(lambda s, r: s.to(r.dtype) * r, inv_d)
    if bs > MAX_BLOCK:
        raise NotImplementedError(
            f"BJ maxBlockSize {bs}: the block-Jacobi kernel takes blocks of 2 to "
            f"{MAX_BLOCK} rows (ROADMAP.md A10)")
    inv_t = torch.tensor(block_inverses(coo, bs), device=device)
    return PrecondOp(lambda s, r: apply(s, r), inv_t)
