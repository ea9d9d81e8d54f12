"""Sparse matrix containers for the port: Coo (host exchange format) and
Dia (the device format of the structured-mesh path), and the steady-state
value update of Dia, Gdia and Xell (kernels/gdia.py, kernels/xell.py).

Counterpart: ogl_tpu/core/formats.py (`Coo`, `Dia`, `dia_layout`,
`coo_to_dia`, `with_values`, and the Dia, Gdia and Xell cases of
`ValueMap`/`value_map`).  The layout functions are the reference's numpy
branches carried over unchanged; the containers hold torch tensors instead
of JAX pytrees.  Csr/Ell/Sell/Hybrid are not ported yet.

  Coo — row/col/val triplets, row-major sorted (numpy on the host).
  Dia — data[d, i] = A[i, i + offsets[d]], 0 where i + offsets[d] falls
        outside [0, n).  `data` is a contiguous (n_diags, n) float32
        tensor on the solver's device; `offsets` is a host tuple.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Coo", "Dia", "dia_layout", "coo_to_dia", "with_values", "ValueMap",
           "value_map"]


@dataclasses.dataclass(frozen=True)
class Coo:
    """Row-major sorted COO. rows/cols are int32, vals any float dtype."""

    rows: Any
    cols: Any
    vals: Any
    shape: tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Dia:
    """Diagonal (DIA) storage.  data[d, i] = A[i, i + offsets[d]]."""

    data: torch.Tensor  # (n_diags, n_rows)
    offsets: tuple[int, ...]
    shape: tuple[int, int]


def dia_layout(rows: np.ndarray, cols: np.ndarray, n: int):
    """Entry→slot layout for DIA packing: returns (offsets, dest) where
    dest[i] is the flat index of entry i into the (n_diags, n) data array.

    Offset ranks come from a boolean presence table + short cumsum
    (O(nnz + n)) instead of np.unique's O(nnz log nnz) sort."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) == 0 or n == 0:
        return (), np.zeros(0, np.int64)
    shifted = np.subtract(cols, rows, dtype=np.int64)
    shifted += n - 1  # in [0, 2n-2]
    present = np.zeros(2 * n - 1, np.bool_)
    present[shifted] = True
    offs = np.flatnonzero(present)
    rank = np.cumsum(present, dtype=np.int64)
    rank -= 1  # rank[s] = index of offset s among the present ones
    dest = rank[shifted]
    dest *= n
    dest += rows
    return tuple(int(o) - (n - 1) for o in offs), dest


def coo_to_dia(m: Coo, device: torch.device | str = "cpu") -> Dia:
    """Host COO -> Dia with its data uploaded to `device` (duplicates sum,
    as in the reference's bincount pass)."""
    rows, cols, vals = (np.asarray(a) for a in (m.rows, m.cols, m.vals))
    n = m.shape[0]
    offs, dest = dia_layout(rows, cols, n)
    data = np.bincount(dest, weights=vals.astype(np.float64),
                       minlength=len(offs) * n).astype(vals.dtype)
    return Dia(data=torch.tensor(data.reshape(len(offs), n), device=device),
               offsets=offs, shape=m.shape)


def with_values(m, vals: torch.Tensor):
    """The same-sparsity container with new values (the steady-state
    coefficient-update path): Dia takes its (nd, n) data, Gdia its
    (n_planes, R, 128) values, Xell the flat [vals.flat ++ spill.vals]
    storage — the spill's per-row index tables stay, so the new spill
    values flow through their gather index."""
    if isinstance(m, Dia):
        return dataclasses.replace(m, data=vals)
    kind = type(m).__name__
    if kind == "Gdia":
        return dataclasses.replace(m, vals=vals.view(m.vals.shape))
    if kind == "Xell":
        msize = m.vals.numel()
        return dataclasses.replace(
            m, vals=vals[:msize].view(m.vals.shape),
            spill=dataclasses.replace(m.spill, vals=vals[msize:]))
    raise TypeError(f"no value update for format {kind} in the port yet")


@dataclasses.dataclass(frozen=True)
class ValueMap:
    """Static entry→slot map making the steady-state coefficient update one
    scatter on the device (the reference's in-place device value
    overwrite, CsrMatrixWrapper.H:74-136).

    `dest[i]` is the flat index of COO entry i in the container's value
    storage (int64, on the matrix's device).  `unique` means no two entries
    share a slot, so the scatter is a set; otherwise duplicates accumulate
    (matching the converters' bincount)."""

    dest: torch.Tensor
    out_shape: tuple
    unique: bool

    def update(self, m, coo_vals: torch.Tensor):
        """New container with the same sparsity, values from the row-major
        COO entry array (already on the matrix's device)."""
        size = int(np.prod(self.out_shape))
        flat = torch.zeros(size, dtype=coo_vals.dtype, device=coo_vals.device)
        if self.unique:
            flat[self.dest] = coo_vals
        else:
            flat.index_add_(0, self.dest, coo_vals)
        return with_values(m, flat.view(self.out_shape))


def value_map(m, rows, cols) -> ValueMap:
    """Build the ValueMap for container `m` from the host COO structure
    (row-major sorted, the order ldu.assemble_from_blocks emits values in).
    One-time setup; the returned map's `update` is the per-step path.  A
    Gdia or Xell container that still carries the host layout of its
    conversion reuses it (the reference recomputes `gdia_layout` or
    `xell_layout`, a second or more at 1M)."""
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    n = m.shape[0]
    kind = type(m).__name__
    if isinstance(m, Dia):
        offs, dest = dia_layout(rows, cols, n)
        if offs != m.offsets:
            raise ValueError("sparsity changed: DIA offsets do not match container")
        shape = (len(offs), n)
        device = m.data.device
    elif kind == "Gdia":
        from ogl_tpu_torch.kernels.gdia import gdia_layout

        if m.layout is not None and len(m.layout) == len(rows):
            dest = m.layout
        else:
            plane_offsets, _, dest, _ = gdia_layout(
                rows, cols, n, max_planes=max(64, len(m.plane_offsets)))
            if plane_offsets != m.plane_offsets:
                raise ValueError("sparsity changed: Gdia planes do not match container")
        shape = tuple(int(s) for s in m.vals.shape)
        device = m.vals.device
    elif kind == "Xell":
        from ogl_tpu_torch.kernels.xell import xell_layout

        lay = m.layout
        if lay is None or len(lay.dest) != len(rows):
            lay = xell_layout(rows, cols, n)
        n_spill = int(m.spill.vals.shape[0])
        if (lay.n_slots != m.n_slots or lay.c_chunks != m.c_chunks
                or int(lay.spill_sel.sum()) != n_spill):
            raise ValueError("sparsity changed: Xell packing does not match container")
        dest = lay.dest
        shape = (int(m.vals.numel()) + n_spill,)
        device = m.vals.device
    else:
        raise TypeError(f"no value map for format {kind} in the port yet")
    seen = np.zeros(int(np.prod(shape)), np.bool_)
    seen[dest] = True
    unique = int(seen.sum()) == len(dest)
    return ValueMap(dest=torch.tensor(dest, device=device), out_shape=shape,
                    unique=unique)
