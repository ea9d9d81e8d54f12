"""Sparse matrix-vector products and the format ladder of auto-routing.

Counterpart: ogl_tpu/kernels/spmv.py (`spmv_coo`, `spmv_dia`, `spmv`,
`matvec`, `pack_fast`).  Coo, Dia, Gdia and Xell exist in the port.
`matvec(m)` returns the format's kernel wrapper (Dia, Gdia or Xell SpMV),
which launches the CUDA kernel for CUDA tensors (the reference's route to
its Pallas kernels, spmv.py:226-247) and runs the plain version on the
CPU.  `pack_fast` is the reference's ladder Dia → Gdia → Xell → Ell; the
port has no Ell, so the last rung raises.  The reference's TPU-only gates
(`pallas_usable`, the x64/Mosaic checks) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core.formats import Coo, Dia, coo_to_dia
from ogl_tpu_torch.kernels.dia_spmv import MAX_DIAGS, DiaPlan, dia_spmv, dia_spmv_plain
from ogl_tpu_torch.kernels.gdia import Gdia, gdia_from_coo, gdia_matvec, spmv_gdia
from ogl_tpu_torch.kernels.xell import Xell, spmv_xell, xell_from_coo, xell_matvec

__all__ = ["spmv", "matvec", "spmv_coo", "spmv_dia", "fits_dia", "pack_fast",
           "XELL_MIN_ROWS"]

XELL_MIN_ROWS = 1 << 15  # the reference's gate of the Xell rung (spmv.py:159)


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


_PLAIN = {Dia: spmv_dia, Coo: spmv_coo, Gdia: spmv_gdia, Xell: spmv_xell}


def spmv(m, x):
    """Plain y = A x for any port format."""
    f = _PLAIN.get(type(m))
    if f is None:
        raise TypeError(f"unknown matrix format {type(m).__name__}")
    return f(m, x)


def matvec(m):
    """`x -> A @ x` for matrix `m`: the format's SpMV kernel wrapper for
    Dia, Gdia and Xell (plain version when the data lies on the CPU),
    plain otherwise."""
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
    XELL_MIN_ROWS, window within its chunk budget) → Ell.  The port has no
    Ell: that landing raises NotImplementedError (ROADMAP.md A2), with why
    Xell refused the matrix when it was tried.  presorted=True skips the
    row-major sort (the LDU sparsity emits row-major order already)."""
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
    why = f"{n} rows < {XELL_MIN_ROWS}, so Xell is not tried"
    if n >= XELL_MIN_ROWS:
        try:
            return xell_from_coo(coo, device=device)
        except ValueError as e:
            why = f"Xell packing failed: {e}"
    raise NotImplementedError(
        f"pack_fast: the {n}-row matrix lands on the Ell format ({why}), which "
        "is not ported to ogl_tpu_torch yet (ROADMAP.md A2)")
