"""Build the port's objects from the JAX package's data, handed over as
numpy arrays.

Counterpart: none — this is the bridge the parity tests use.  It imports
neither package's jax side: callers convert the reference's arrays with
numpy first (np.asarray on a jax array), and this module only reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core.formats import (Coo, Csr, DeviceCoo, Dia, Ell, Hybrid, Sell,
                                        coo_to_csr, coo_to_device, ell_warp_slots,
                                        sell_slices, sell_table)
from ogl_tpu_torch.core.ldu import LduMatrix, LocalInterface
from ogl_tpu_torch.kernels.gdia import Gdia
from ogl_tpu_torch.kernels.xell import Xell, spill_csr
from ogl_tpu_torch.precond.amg import Level, make_level

__all__ = ["dia_from_arrays", "ldu_from_arrays", "unframe_reference",
           "amg_levels_from_reference", "gdia_from_reference", "xell_from_reference",
           "coo_from_reference", "csr_from_reference", "ell_from_reference",
           "sell_from_reference", "hybrid_from_reference"]


def dia_from_arrays(data, offsets, shape, device: torch.device | str = "cpu") -> Dia:
    """A port Dia from (nd, n) data, its offsets and the matrix shape."""
    arr = np.ascontiguousarray(np.asarray(data))
    return Dia(data=torch.tensor(arr, device=device),
               offsets=tuple(int(o) for o in offsets),
               shape=tuple(int(s) for s in shape))


def ldu_from_arrays(n, lower_addr, upper_addr, diag, upper, lower=None,
                    local_interfaces=()) -> LduMatrix:
    """A port LduMatrix from numpy arrays.  `local_interfaces` items are
    anything with rows/cols/coeffs attributes (the reference's
    LocalInterface included)."""
    ifaces = tuple(LocalInterface(rows=np.asarray(li.rows), cols=np.asarray(li.cols),
                                  coeffs=np.asarray(li.coeffs))
                   for li in local_interfaces)
    return LduMatrix(
        n=int(n),
        lower_addr=np.asarray(lower_addr),
        upper_addr=np.asarray(upper_addr),
        diag=np.asarray(diag),
        upper=np.asarray(upper),
        lower=None if lower is None else np.asarray(lower),
        local_interfaces=ifaces,
    )


def unframe_reference(xf, n: int, tile: int) -> np.ndarray:
    """The port's flat (n,) vector from a reference halo-framed
    (Rp + 2T, 128) vector: drop the T zero rows at either end and the
    padding past n (ogl_tpu/kernels/fused.py `CgKernels.unframe`)."""
    xf = np.asarray(xf)
    return xf[tile: xf.shape[0] - tile].reshape(-1)[:n].copy()


def amg_levels_from_reference(levels, device: torch.device | str = "cpu",
                              smoother_dtype: torch.dtype = torch.float32) -> list[Level]:
    """The port's AMG levels from the reference's `_Level` list
    (ogl_tpu/precond/amg.py): each level's Dia operator (`mat.data`,
    `mat.offsets`, `mat.shape`), `inv_diag`, `agg` (pgm) or `grid` tuple,
    `natural`, `width`, `nc` and `coarse_inv`, read with np.asarray.  The
    smoother coefficients are packed in `smoother_dtype` (float32 here:
    the reference's CPU cycle is float32 throughout)."""
    out = []
    for lv in levels:
        mat = lv.mat
        kind = type(mat).__name__
        if kind != "Dia":
            # AMG on Gdia, Xell or Ell levels is A11
            raise TypeError(f"level operator {kind}: only Dia levels have a port "
                            "counterpart (ROADMAP.md A11)")
        out.append(make_level(
            dia_from_arrays(mat.data, mat.offsets, mat.shape, device),
            np.asarray(lv.inv_diag), int(lv.nc),
            agg=None if lv.agg is None else np.asarray(lv.agg),
            natural=bool(lv.natural), grid=lv.grid, width=int(lv.width),
            coarse_inv=None if lv.coarse_inv is None else np.asarray(lv.coarse_inv),
            smoother_dtype=smoother_dtype))
    return out


def gdia_from_reference(m, device: torch.device | str = "cpu") -> Gdia:
    """The port's Gdia from a reference Gdia (`vals`, `lidx`,
    `plane_offsets`, `shape`, read with np.asarray)."""
    return Gdia(vals=torch.tensor(np.asarray(m.vals), device=device),
                lidx=torch.tensor(np.asarray(m.lidx), device=device),
                plane_offsets=tuple(int(q) for q in m.plane_offsets),
                shape=tuple(int(s) for s in m.shape))


def xell_from_reference(m, device: torch.device | str = "cpu") -> Xell:
    """The port's Xell from a reference Xell (`vals`, `ll`, `bbT`, the COO
    `spill`, `c_left`, `c_chunks`, `shape`, read with np.asarray); the
    spill's per-row CSR is built here, as xell_from_coo builds it."""
    def up(a, dtype=None):
        a = np.asarray(a)
        return torch.tensor(a if dtype is None else a.astype(dtype), device=device)

    shape = tuple(int(s) for s in m.shape)
    rows, cols = np.asarray(m.spill.rows), np.asarray(m.spill.cols)
    spill = Coo(rows=up(rows, np.int32), cols=up(cols, np.int32),
                vals=up(m.spill.vals), shape=shape)
    return Xell(vals=up(m.vals), ll=up(m.ll), bbT=up(m.bbT), spill=spill,
                spill_csr=spill_csr(rows, cols, shape[0], device),
                c_left=int(m.c_left), c_chunks=int(m.c_chunks), shape=shape)


def _shape(m) -> tuple[int, int]:
    return tuple(int(s) for s in m.shape)


def coo_from_reference(m, device: torch.device | str = "cpu") -> DeviceCoo:
    """The port's device Coo from a reference Coo (`rows`, `cols`, `vals`,
    `shape`, read with np.asarray)."""
    return coo_to_device(Coo(rows=np.asarray(m.rows), cols=np.asarray(m.cols),
                             vals=np.asarray(m.vals), shape=_shape(m)), device)


def csr_from_reference(m, device: torch.device | str = "cpu") -> Csr:
    """The port's Csr from a reference Csr (`row_ptr`, `cols`, `vals`,
    `shape`)."""
    def up(a):
        return torch.tensor(np.asarray(a), device=device)

    return Csr(row_ptr=up(m.row_ptr), cols=up(m.cols), vals=up(m.vals), shape=_shape(m))


def ell_from_reference(m, device: torch.device | str = "cpu") -> Ell:
    """The port's slot-major Ell from a reference Ell, whose cols/vals are
    row-major (n, K).  The reference keeps no row lengths, so each row's is
    read from its padding: the slots up to its last one that is not (its own
    column, value 0), and one more where that slot could be a stored zero on
    the diagonal — the row holds no column above its own (columns ascend
    within a row), so its (i, i) entry would come next.  Taking such an entry
    for padding would drop it once a value update makes it nonzero; reading
    one padding slot too many adds 0 · x[i]."""
    cols, vals = np.asarray(m.cols), np.asarray(m.vals)
    n, k = cols.shape
    own = np.arange(n)
    live = (cols != own[:, None]) | (vals != 0)
    counts = np.where(live.any(axis=1), k - np.argmax(live[:, ::-1], axis=1), 0)
    last_col = cols[own, np.maximum(counts - 1, 0)] if k else own
    counts = counts + ((counts < k) & ((counts == 0) | (last_col < own)))

    def up(a):
        return torch.tensor(np.ascontiguousarray(a.T), device=device)

    return Ell(cols=up(cols), vals=up(vals), shape=_shape(m),
               warp_slots=torch.tensor(ell_warp_slots(counts, k), device=device))


def sell_from_reference(m, device: torch.device | str = "cpu") -> Sell:
    """The port's Sell from a reference Sell: each bucket's (ns, C, w)
    block stored as (w, ns · C), concatenated.  The reference keeps no row
    lengths, so each slot's is read from its padding, (column 0, value 0):
    the lanes up to its last other one.  Columns ascend within a row, so a
    real entry on column 0 is a row's first; the slices' widths are at
    least 1 (sell_slices), which covers a row whose only entry is a stored
    zero on column 0."""
    def flat(blocks):
        return np.concatenate([np.asarray(b).reshape(-1, np.asarray(b).shape[2]).T.reshape(-1)
                               for b in blocks])

    def slot_counts(cols, vals):
        live = (cols != 0) | (vals != 0)  # (slots, w)
        w = live.shape[1]
        return np.where(live.any(axis=1), w - np.argmax(live[:, ::-1], axis=1), 0)

    widths = tuple(int(np.asarray(v).shape[2]) for v in m.vals)
    ns_of = tuple(int(np.asarray(v).shape[0]) for v in m.vals)
    C = int(m.slice_height)
    counts = np.concatenate([slot_counts(np.asarray(c).reshape(-1, w), np.asarray(v).reshape(-1, w))
                             for c, v, w in zip(m.cols, m.vals, widths)])
    slice_widths, slice_buckets = sell_slices(counts, ns_of, C)
    return Sell(cols=torch.tensor(flat(m.cols), device=device),
                vals=torch.tensor(flat(m.vals), device=device),
                slot_rows=torch.tensor(np.concatenate([np.asarray(r) for r in m.slot_rows]),
                                       device=device),
                table=torch.tensor(sell_table(widths, ns_of, C), device=device),
                slice_widths=torch.tensor(slice_widths, device=device),
                slice_buckets=torch.tensor(slice_buckets, device=device),
                widths=widths, n_slices=ns_of, shape=_shape(m), slice_height=C,
                sigma=int(m.sigma))


def hybrid_from_reference(m, device: torch.device | str = "cpu") -> Hybrid:
    """The port's Hybrid from a reference Hybrid (its `ell` and its COO
    tail `coo`, which the port stores as a Csr)."""
    tail = Coo(rows=np.asarray(m.coo.rows), cols=np.asarray(m.coo.cols),
               vals=np.asarray(m.coo.vals), shape=_shape(m))
    return Hybrid(ell=ell_from_reference(m.ell, device), tail=coo_to_csr(tail, device),
                  shape=_shape(m))
