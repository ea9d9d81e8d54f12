"""Sparse matrix-vector products and the format ladder of auto-routing.

Counterpart: ogl_tpu/kernels/spmv.py (`spmv_coo`, `spmv_csr`, `spmv_ell`,
`spmv_sell`, `spmv_dia`, `spmv_hybrid`, `spmv`, `matvec`, `pack_fast`).
`matvec(m)` returns the format's kernel wrapper — the Dia, Gdia or Xell
SpMV (the reference's route to its Pallas kernels, spmv.py:226-247), or
the CSR (also for a DeviceCoo), Ell, Sell or Hybrid SpMV of
kernels/gather_spmv.py, where the reference runs XLA ops — which launches
the CUDA kernel for CUDA tensors and runs the plain version on the CPU.
`pack_fast` is the reference's ladder Dia → Gdia → Xell → Ell.  The
reference's TPU-only gates (`pallas_usable`, the x64/Mosaic checks) have
no counterpart here.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ogl_tpu_torch.core.formats import (Coo, Csr, DeviceCoo, Dia, Ell, Hybrid, Sell, coo_to_dia,
                                        coo_to_ell)
from ogl_tpu_torch.kernels import gather_spmv
from ogl_tpu_torch.kernels.dia_spmv import MAX_DIAGS, DiaPlan, dia_spmv, dia_spmv_plain
from ogl_tpu_torch.kernels.gdia import Gdia, gdia_from_coo, gdia_matvec, spmv_gdia
from ogl_tpu_torch.kernels.xell import Xell, spmv_xell, xell_from_coo, xell_matvec

__all__ = ["spmv", "matvec", "spmv_coo", "spmv_csr", "spmv_ell", "spmv_sell", "spmv_dia",
           "spmv_hybrid", "fits_dia", "pack_fast", "XELL_MIN_ROWS"]

XELL_MIN_ROWS = 1 << 15  # the reference's gate of the Xell rung (spmv.py:159)


def spmv_coo(m: Coo, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A x for a host Coo matrix (gather + index_add)."""
    rows = torch.as_tensor(np.asarray(m.rows, np.int64), device=x.device)
    cols = torch.as_tensor(np.asarray(m.cols, np.int64), device=x.device)
    vals = torch.as_tensor(np.asarray(m.vals), device=x.device).to(x.dtype)
    prod = vals * torch.index_select(x, 0, cols)
    return torch.zeros(m.shape[0], dtype=x.dtype, device=x.device).index_add_(0, rows, prod)


def spmv_dia(m: Dia, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A x for a Dia matrix (static shifted products)."""
    return dia_spmv_plain(m.data, m.offsets, x)


spmv_csr = gather_spmv.spmv_csr
spmv_ell = gather_spmv.spmv_ell
spmv_sell = gather_spmv.spmv_sell
spmv_hybrid = gather_spmv.spmv_hybrid

_PLAIN = {Dia: spmv_dia, Coo: spmv_coo, Csr: spmv_csr, DeviceCoo: spmv_csr, Ell: spmv_ell,
          Sell: spmv_sell, Hybrid: spmv_hybrid, Gdia: spmv_gdia, Xell: spmv_xell}
# the gather formats' SpMV wrappers, each made once per container
_KERNEL = {Csr: gather_spmv.CsrSpmv, DeviceCoo: gather_spmv.CsrSpmv,
           Sell: gather_spmv.SellSpmv, Ell: gather_spmv.EllSpmv, Hybrid: gather_spmv.EllSpmv}


def spmv(m, x):
    """Plain y = A x for any port format."""
    f = _PLAIN.get(type(m))
    if f is None:
        raise TypeError(f"unknown matrix format {type(m).__name__}")
    return f(m, x)


def matvec(m):
    """`x -> A @ x` for matrix `m`: the format's SpMV kernel wrapper (the
    plain version when the data lies on the CPU); a host Coo takes the
    plain gather + index_add.  A Csr (DeviceCoo), Ell, Hybrid or Sell
    matrix's operands are checked once, here (gather_spmv.CsrSpmv,
    EllSpmv, SellSpmv)."""
    if type(m) in _KERNEL:
        return _KERNEL[type(m)](m)
    if isinstance(m, Dia):
        plan = DiaPlan.of(m)
        data = m.data
        return lambda x: dia_spmv(plan, data, x)
    if isinstance(m, Gdia):
        return gdia_matvec(m)
    if isinstance(m, Xell):
        return xell_matvec(m)
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


def pack_fast(rows, cols, vals, n: int, max_planes: int = 48,
              presorted: bool = False, device: torch.device | str = "cpu"):
    """Pack host COO triplets into the first format of the reference's
    ladder that takes them, uploaded to `device`: Dia (at most 64 distinct
    offsets) → Gdia (at most `max_planes` block-row planes) → Xell (n ≥
    XELL_MIN_ROWS, window within its chunk budget) → Ell, which takes any
    sparsity.  When Xell was tried and failed, the reference's
    RuntimeWarning names why.  presorted=True skips the row-major sort
    (the LDU sparsity emits row-major order already)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if not presorted:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    coo = Coo(rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals,
              shape=(n, n))
    if fits_dia(rows, cols, n):
        return coo_to_dia(coo, device)
    try:
        return gdia_from_coo(coo, max_planes=max_planes, device=device)
    except ValueError:
        pass
    if n >= XELL_MIN_ROWS:
        try:
            return xell_from_coo(coo, device=device)
        except ValueError as e:
            warnings.warn(
                f"pack_fast: {n}-row matrix fell to the gather Ell tier (Xell packing "
                f"failed: {e}); renumber the matrix (reorder='rcm') or raise the Xell "
                "window budget", RuntimeWarning, stacklevel=2)
    return coo_to_ell(coo, device=device)
