"""Sparse matrix-vector products and the format test of auto-routing.

Counterpart: ogl_tpu/kernels/spmv.py (`spmv_coo`, `spmv_dia`, `matvec`,
and the Dia test of `pack_fast`).  Only Coo and Dia exist in the port so
far.  `matvec(m)` for a Dia matrix returns the Dia SpMV wrapper, which
launches the CUDA kernel for CUDA tensors (the reference's route to its
Pallas kernel, spmv.py:233-237) and runs the plain version on the CPU.
The reference's TPU-only gates (`pallas_usable`, the x64/Mosaic checks)
have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core.formats import Coo, Dia
from ogl_tpu_torch.kernels.dia_spmv import MAX_DIAGS, DiaPlan, dia_spmv, dia_spmv_plain

__all__ = ["spmv", "matvec", "spmv_coo", "spmv_dia", "fits_dia"]


def spmv_coo(m: Coo, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A x for a Coo matrix (gather + index_add)."""
    rows = torch.as_tensor(np.asarray(m.rows, np.int64), device=x.device)
    cols = torch.as_tensor(np.asarray(m.cols, np.int64), device=x.device)
    vals = torch.as_tensor(np.asarray(m.vals), device=x.device).to(x.dtype)
    prod = vals * torch.index_select(x, 0, cols)
    return torch.zeros(m.shape[0], dtype=x.dtype, device=x.device).index_add_(0, rows, prod)


def spmv_dia(m: Dia, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A x for a Dia matrix (static shifted products)."""
    return dia_spmv_plain(m.data, m.offsets, x)


def spmv(m, x):
    """Plain y = A x for any port format."""
    if isinstance(m, Dia):
        return spmv_dia(m, x)
    if isinstance(m, Coo):
        return spmv_coo(m, x)
    raise TypeError(f"unknown matrix format {type(m).__name__}")


def matvec(m):
    """`x -> A @ x` for matrix `m`: the Dia SpMV kernel for a Dia matrix
    (plain version when its data lies on the CPU), plain otherwise."""
    if isinstance(m, Dia):
        plan = DiaPlan.of(m)
        data = m.data
        return lambda x: dia_spmv(plan, data, x)
    return lambda x: spmv(m, x)


def fits_dia(rows, cols, n: int, max_offsets: int = MAX_DIAGS) -> bool:
    """The Dia test of the reference's `pack_fast` (spmv.py:145-152): at
    most `max_offsets` distinct diagonal offsets — a strided sample first,
    then a presence-table count with no nnz sort."""
    diffs = np.asarray(cols, np.int64) - np.asarray(rows, np.int64)
    sample = np.unique(diffs[:: max(1, len(diffs) // 65536)])
    if len(sample) > max_offsets:
        return False
    present = np.zeros(2 * n - 1, np.bool_) if n else np.zeros(1, np.bool_)
    present[diffs + (n - 1)] = True
    return int(present.sum()) <= max_offsets
