"""Sparse matrix containers for the port: Coo (the host exchange format,
and its device form), Csr, Ell, Sell and Hybrid (the reference-parity
formats, each with a hand-written SpMV in kernels/gather_spmv.py), Dia (the
device format of the structured-mesh path), their converters, and the
steady-state value update of every format (Gdia and Xell live in
kernels/gdia.py and kernels/xell.py).

Counterpart: ogl_tpu/core/formats.py (`Coo`, `Csr`, `Ell`, `Dia`, `Sell`,
`Hybrid`, `coo_from_dense`, `to_dense`, `coo_to_csr`, `ell_layout`,
`coo_to_ell`, `coo_to_hybrid`, `dia_layout`, `coo_to_dia`, `sell_layout`,
`coo_to_sell`, `with_values`, `values_flat`, `cast_values`,
`ValueMap`/`value_map`).  The layout functions are the reference's numpy
branches carried over unchanged; the containers hold torch tensors
instead of JAX pytrees.  `BlockUpdatePlan` is not ported (ROADMAP.md A7).

  Coo    — row/col/val triplets, row-major sorted: the host exchange
           format (numpy arrays).  `matrixFormat Coo` puts it on the device
           as a `DeviceCoo` (`coo_to_device`): its entries as a Csr, whose
           SpMV the CSR kernel computes; `format_name` still says Coo.
  Csr    — row_ptr (n + 1) / cols / vals, int32 indices.
  Ell    — slot-major: cols/vals of shape (K, n), entry k of row i at
           [k, i] (the reference stores (n, K); the kernel's threads read
           one slot of neighbouring rows at neighbouring addresses).
           Padding: col = the row itself, val 0.  `warp_slots` holds the
           longest row of each 32-row group: the kernels' warps stop there.
  Sell   — SELL-C-σ width buckets stored flat, bucket after bucket, each
           bucket slot-major: (w_b, ns_b · C), lane k of slot s at [k, s],
           where the reference stores (ns_b, C, w_b).  Padding: col 0,
           val 0; pad slots' rows are n.  `table` is the buckets' device
           table of (first slot, first value, width); per slice, in slot
           order, `slice_widths` holds its longest row (the kernels' slices
           stop there, short of a rounded bucket width) and `slice_buckets`
           its bucket.
  Hybrid — an Ell bulk plus a tail (the entries past the Ell width,
           row-major) stored as a Csr.
  Dia    — data[d, i] = A[i, i + offsets[d]], 0 where i + offsets[d] falls
           outside [0, n).  `data` is a contiguous (n_diags, n) float32
           tensor on the solver's device; `offsets` is a host tuple.

Every value storage is addressed flat by `value_map`'s `dest`, in the
device layout; the parity tests map Ell and Sell back to the reference's
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Coo", "Csr", "DeviceCoo", "Ell", "Sell", "Hybrid", "Dia", "format_name",
           "coo_from_dense", "to_dense", "coo_to_device", "coo_to_csr", "ell_layout",
           "ELL_GROUP", "ell_warp_slots", "coo_to_ell", "coo_to_hybrid", "dia_layout",
           "coo_to_dia", "sell_layout", "sell_device_index", "sell_table", "sell_slices",
           "coo_to_sell",
           "with_values", "values_flat", "cast_values", "ValueMap", "value_map"]


def _np(a) -> np.ndarray:
    """A host numpy view of a numpy array or a tensor on any device."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _up(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(a if dtype is None else a.astype(dtype), device=device)


@dataclasses.dataclass(frozen=True)
class Coo:
    """Row-major sorted COO. rows/cols are int32, vals any float dtype."""

    rows: Any
    cols: Any
    vals: Any
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class Csr:
    """Compressed sparse row, columns row-major sorted within each row."""

    row_ptr: torch.Tensor  # (n + 1,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceCoo(Csr):
    """`matrixFormat Coo` on the device: the row-major entries with their
    rows' offsets, derived once per sparsity — a Csr in all but its name."""


def format_name(m) -> str:
    """The matrixFormat a container answers to."""
    return "Coo" if isinstance(m, DeviceCoo) else type(m).__name__


@dataclasses.dataclass(frozen=True)
class Ell:
    """Slot-major ELLPACK: cols/vals of shape (K, n_rows).  Padding has
    col == the row's own index and val == 0, so the SpMV needs no mask.
    warp_slots[g] is the longest row among rows 32g .. 32g + 31
    (`ell_warp_slots`): the slots past it hold padding only, and the
    kernels' warps stop there.  It belongs to the sparsity, so a value
    update carries it."""

    cols: torch.Tensor  # (K, n) int32
    vals: torch.Tensor  # (K, n)
    shape: tuple[int, int]
    warp_slots: torch.Tensor  # (ceil(n / 32),) int32

    @property
    def row_width(self) -> int:
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class Sell:
    """SELL-C-σ with per-slice width buckets (the reference's `Sell`),
    stored flat: bucket b holds n_slices[b] slices of C = slice_height rows
    padded to widths[b], slot-major, (w_b, ns_b · C).
    slot_rows[g] is the original row of slot g (pad slots: n); table[b] =
    (first slot, first value, width) of bucket b, int64 on the device.
    Slice s holds slots s·C .. s·C + C − 1 (buckets hold whole slices):
    slice_widths[s] is its longest row (at least 1; `sell_layout`'s width
    before any rounding to a power of two), at most its bucket's width,
    slice_buckets[s] its bucket.  Both belong to the sparsity, so value
    updates carry them."""

    cols: torch.Tensor  # (stored,) int32
    vals: torch.Tensor  # (stored,)
    slot_rows: torch.Tensor  # (Σ ns_b · C,) int32
    table: torch.Tensor  # (n_buckets, 3) int64
    slice_widths: torch.Tensor  # (Σ ns_b,) int32
    slice_buckets: torch.Tensor  # (Σ ns_b,) uint8
    widths: tuple[int, ...]
    n_slices: tuple[int, ...]
    shape: tuple[int, int]
    slice_height: int
    sigma: int = 64

    @property
    def stored(self) -> int:
        """Stored (padded) entry count — the SELL footprint."""
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class Hybrid:
    """Ginkgo-style hybrid: an Ell part for the regular bulk plus a tail,
    stored as a Csr, for the entries past the Ell width (the reference's
    `coo`)."""

    ell: Ell
    tail: Csr
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.ell.vals)) + self.tail.nnz


@dataclasses.dataclass(frozen=True)
class Dia:
    """Diagonal (DIA) storage.  data[d, i] = A[i, i + offsets[d]]."""

    data: torch.Tensor  # (n_diags, n_rows)
    offsets: tuple[int, ...]
    shape: tuple[int, int]


# ---- construction / conversion (host numpy, then one upload) ---------------


def coo_from_dense(a: np.ndarray, dtype=None) -> Coo:
    """The host Coo of a dense array's nonzeros, row-major."""
    a = np.asarray(a)
    rows, cols = np.nonzero(a)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = a[rows, cols]
    if dtype is not None:
        vals = vals.astype(dtype)
    return Coo(rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals,
               shape=a.shape)


def to_dense(m) -> np.ndarray:
    """Densify any port format on the host (tests and IO)."""
    n, mcols = m.shape
    if isinstance(m, Hybrid):
        return to_dense(m.ell) + to_dense(m.tail)
    if type(m).__name__ == "Xell":
        from ogl_tpu_torch.kernels.xell import xell_to_coo

        return to_dense(xell_to_coo(m))
    vals = _np(m.data if isinstance(m, Dia) else m.vals)
    out = np.zeros((n, mcols), dtype=vals.dtype)
    if isinstance(m, Coo):
        np.add.at(out, (_np(m.rows).astype(np.int64), _np(m.cols).astype(np.int64)), vals)
    elif isinstance(m, Csr):
        r = np.repeat(np.arange(n), np.diff(_np(m.row_ptr).astype(np.int64)))
        np.add.at(out, (r, _np(m.cols).astype(np.int64)), vals)
    elif isinstance(m, Ell):
        r = np.broadcast_to(np.arange(n), vals.shape)
        np.add.at(out, (r.ravel(), _np(m.cols).astype(np.int64).ravel()), vals.ravel())
    elif isinstance(m, Sell):
        # each stored value's slot, from the layout (w, ns · C) of its bucket
        C = m.slice_height
        slot = np.empty(m.stored, np.int64)
        table = sell_table(m.widths, m.n_slices, C)
        for (first_slot, first_val, w), ns in zip(table, m.n_slices):
            k = np.arange(ns * w * C)
            slot[first_val + k] = first_slot + k % (ns * C)
        rr = _np(m.slot_rows).astype(np.int64)[slot]
        live = rr < n  # pad slots park at row n; pad entries add 0
        np.add.at(out, (rr[live], _np(m.cols).astype(np.int64)[live]), vals[live])
    elif isinstance(m, Dia):
        for k, off in enumerate(m.offsets):
            i = np.arange(n)
            j = i + off
            ok = (j >= 0) & (j < mcols)
            out[i[ok], j[ok]] += vals[k, i[ok]]
    else:
        raise TypeError(f"unknown format {type(m)}")
    return out


def _host(m: Coo):
    return _np(m.rows), _np(m.cols), _np(m.vals)


def _row_ptr(rows: np.ndarray, n: int) -> np.ndarray:
    """The CSR offsets of row-major sorted rows (int32, n + 1)."""
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(np.asarray(rows, np.int64), minlength=n), out=row_ptr[1:])
    return row_ptr.astype(np.int32)


def coo_to_csr(m: Coo, device: torch.device | str = "cpu") -> Csr:
    rows, cols, vals = _host(m)
    return Csr(row_ptr=_up(_row_ptr(rows, m.shape[0]), device),
               cols=_up(cols, device, np.int32), vals=_up(vals, device),
               shape=tuple(m.shape))


def coo_to_device(m: Coo, device: torch.device | str = "cpu") -> DeviceCoo:
    """`matrixFormat Coo` on the device (the reference's `_to_device_coo`,
    foam/solver.py:57): the row-major sorted entries as a DeviceCoo."""
    return DeviceCoo(**vars(coo_to_csr(m, device)))


def ell_layout(rows: np.ndarray, n: int, width: int | None = None):
    """Per-entry (row, lane) destination for packing row-major COO into ELL.

    Returns (width, slot) where slot[i] is the lane of entry i within its row.
    The packing is order-preserving within a row, so ELL columns stay
    row-major sorted.
    """
    counts = np.bincount(rows, minlength=n)
    k = int(counts.max()) if width is None else width
    if width is not None and counts.max() > width:
        raise ValueError(f"row width {counts.max()} exceeds requested ELL width {width}")
    # position of each entry within its row (rows are sorted ascending)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows)) - starts[rows]
    return k, slot.astype(np.int64)


ELL_GROUP = 32  # rows of one warp of the Ell kernels (csrc/ell_rows.cuh), one slot count each


def ell_warp_slots(counts: np.ndarray, width: int) -> np.ndarray:
    """The slot count of each ELL_GROUP-row group: its longest row, with
    rows cut at the Ell width (a Hybrid's longer rows go on in the tail)."""
    c = np.minimum(np.asarray(counts, np.int64), width)
    c = np.pad(c, (0, -len(c) % ELL_GROUP)).reshape(-1, ELL_GROUP)
    return c.max(axis=1, initial=0).astype(np.int32)


def coo_to_ell(m: Coo, width: int | None = None,
               device: torch.device | str = "cpu") -> Ell:
    """The reference's `coo_to_ell`, stored slot-major (K, n)."""
    rows, cols, vals = _host(m)
    rows = rows.astype(np.int64)
    n = m.shape[0]
    k, slot = ell_layout(rows, n, width)
    ecols = np.repeat(np.arange(n, dtype=np.int32)[None, :], k, axis=0)  # pad col = own row
    evals = np.zeros((k, n), dtype=vals.dtype)
    ecols[slot, rows] = cols
    evals[slot, rows] = vals
    return Ell(cols=_up(ecols, device), vals=_up(evals, device), shape=tuple(m.shape),
               warp_slots=_up(ell_warp_slots(np.bincount(rows, minlength=n), k), device))


def coo_to_hybrid(m: Coo, width: int | None = None,
                  device: torch.device | str = "cpu") -> Hybrid:
    """Hybrid = ELL bulk + COO tail.  Entries up to `width` per row land in
    the ELL planes; overflow entries go to the row-major COO tail.  Width
    defaults to the 80th-percentile row length (bounds ELL padding waste on
    matrices with a few long rows)."""
    rows, cols, vals = _host(m)
    rows = rows.astype(np.int64)
    n = m.shape[0]
    counts = np.bincount(rows, minlength=n) if n else np.zeros(0, np.int64)
    if width is None:
        width = max(1, int(np.percentile(counts, 80))) if n else 1
    _, slot = ell_layout(rows, n)
    in_ell = slot < width
    ecols = np.repeat(np.arange(n, dtype=np.int32)[None, :], width, axis=0)
    evals = np.zeros((width, n), dtype=vals.dtype)
    ecols[slot[in_ell], rows[in_ell]] = cols[in_ell]
    evals[slot[in_ell], rows[in_ell]] = vals[in_ell]
    tail = ~in_ell
    return Hybrid(
        ell=Ell(cols=_up(ecols, device), vals=_up(evals, device), shape=tuple(m.shape),
                warp_slots=_up(ell_warp_slots(counts, width), device)),
        tail=coo_to_csr(Coo(rows=rows[tail], cols=cols[tail], vals=vals[tail],
                            shape=tuple(m.shape)), device),
        shape=tuple(m.shape))


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


def sell_layout(rows: np.ndarray, n: int, slice_height: int = 8,
                sigma: int = 64, max_buckets: int = 8):
    """Deterministic SELL-C-σ layout from the row-major COO structure
    (shared by coo_to_sell and value_map so the steady-state update cannot
    drift from construction).

    σ-window descending-stable length sort → slices of C rows → per-slice
    width = its longest row → slices grouped into buckets by width.  If
    more than `max_buckets` distinct widths occur, widths round up to
    powers of two (bounding the bucket count at log2(max width), ≤2x
    padding overhead).

    Returns (widths, ns_of, dest, slot_rows, total): per-bucket widths and
    slice counts, the per-entry flat destination into the concatenated
    bucket storage in the reference's (ns, C, w) order (sell_device_index
    maps it to the port's (w, ns · C)), per-bucket original-row tables
    (pad slots -> n), and the total stored entry count."""
    C = slice_height
    counts = np.bincount(rows, minlength=n)
    order = np.arange(n)
    for s in range(0, n, sigma):
        w = order[s:s + sigma]
        order[s:s + sigma] = w[np.argsort(counts[w], kind="stable")[::-1]]
    n_slices = max(-(-n // C), 1)
    n_pad = n_slices * C
    perm = np.full(n_pad, -1, np.int64)
    perm[:n] = order
    counts_pad = np.zeros(n_pad, np.int64)
    counts_pad[:n] = counts[order]
    slice_w = np.maximum(counts_pad.reshape(n_slices, C).max(axis=1), 1)
    if len(np.unique(slice_w)) > max_buckets:
        slice_w = 2 ** np.ceil(np.log2(slice_w)).astype(np.int64)
    widths = [int(w) for w in np.unique(slice_w)]
    bucket_of = {w: b for b, w in enumerate(widths)}
    slice_bucket = np.array([bucket_of[int(w)] for w in slice_w], np.int64)
    pos_in_bucket = np.zeros(n_slices, np.int64)
    ns_of = []
    for b in range(len(widths)):
        sel = slice_bucket == b
        pos_in_bucket[sel] = np.arange(int(sel.sum()))
        ns_of.append(int(sel.sum()))
    base = np.zeros(len(widths) + 1, np.int64)
    base[1:] = np.cumsum([ns * C * w for ns, w in zip(ns_of, widths)])

    inv = np.zeros(n, np.int64)
    inv[order] = np.arange(n)
    _, slot = ell_layout(rows, n)
    p = inv[rows]
    s_of = p // C
    dest = (base[slice_bucket[s_of]]
            + (pos_in_bucket[s_of] * C + p % C) * slice_w[s_of] + slot)

    slot_rows = []
    for b in range(len(widths)):
        sl = np.nonzero(slice_bucket == b)[0]
        pr = perm[(sl[:, None] * C + np.arange(C)[None, :])].reshape(-1)
        slot_rows.append(np.where(pr >= 0, pr, n).astype(np.int32))
    return widths, ns_of, dest, slot_rows, int(base[-1])


def sell_device_index(flat, widths, ns_of, slice_height: int) -> np.ndarray:
    """Map flat indices of the reference's Sell storage (buckets of
    (ns, C, w)) to the port's (buckets of (w, ns · C)), bucket bases
    equal."""
    flat = np.asarray(flat, np.int64)
    C = slice_height
    base = np.zeros(len(widths) + 1, np.int64)
    base[1:] = np.cumsum([ns * C * w for ns, w in zip(ns_of, widths)])
    b = np.searchsorted(base, flat, side="right") - 1
    w = np.asarray(widths, np.int64)[b] if len(widths) else flat
    slots = np.asarray(ns_of, np.int64)[b] * C if len(widths) else flat
    local = flat - base[b]
    slot, k = local // w, local % w  # slot = slice · C + c within the bucket
    return base[b] + k * slots + slot


def sell_table(widths, ns_of, slice_height: int) -> np.ndarray:
    """The buckets' (first slot, first value, width) rows, int64."""
    table = np.zeros((len(widths), 3), np.int64)
    slots = vals = 0
    for b, (w, ns) in enumerate(zip(widths, ns_of)):
        table[b] = (slots, vals, w)
        slots += ns * slice_height
        vals += ns * slice_height * w
    return table


def sell_slices(slot_counts: np.ndarray, ns_of, slice_height: int):
    """(slice_widths, slice_buckets) of a Sell layout from the entry count
    of each slot's row (0 for pad slots), in slot order: each slice's longest
    row, at least 1 (sell_layout's width before rounding), and its bucket."""
    c = np.asarray(slot_counts, np.int64).reshape(-1, slice_height)
    widths = np.maximum(c.max(axis=1, initial=0), 1).astype(np.int32)
    return widths, np.repeat(np.arange(len(ns_of)), ns_of).astype(np.uint8)


def coo_to_sell(m: Coo, slice_height: int = 8, sigma: int = 64,
                device: torch.device | str = "cpu") -> Sell:
    """SELL-C-σ (see Sell/sell_layout): per-slice padding buckets, true
    sliced storage, in the port's slot-major layout."""
    rows, cols, vals = _host(m)
    n = m.shape[0]
    widths, ns_of, dest, slot_rows, total = sell_layout(
        rows.astype(np.int64), n, slice_height, sigma)
    dest = sell_device_index(dest, widths, ns_of, slice_height)
    flat_c = np.zeros(total, np.int32)  # pad col 0 (val 0 -> inert)
    flat_v = np.zeros(total, dtype=vals.dtype)
    flat_c[dest] = cols
    flat_v[dest] = vals
    slot_rows = np.concatenate(slot_rows)
    counts = np.append(np.bincount(rows.astype(np.int64), minlength=n), 0)  # row n: pad slots
    slice_widths, slice_buckets = sell_slices(counts[slot_rows], ns_of, slice_height)
    return Sell(cols=_up(flat_c, device), vals=_up(flat_v, device),
                slot_rows=_up(slot_rows, device),
                table=_up(sell_table(widths, ns_of, slice_height), device),
                slice_widths=_up(slice_widths, device), slice_buckets=_up(slice_buckets, device),
                widths=tuple(widths), n_slices=tuple(ns_of), shape=tuple(m.shape),
                slice_height=slice_height, sigma=sigma)


# ---- value storage -----------------------------------------------------------


def with_values(m, vals: torch.Tensor):
    """The same-sparsity container with new values (the steady-state
    coefficient-update path), from the flat storage `values_flat` reads:
    Dia takes its (nd, n) data, Ell its (K, n) values, Gdia its
    (n_planes, R, 128) values, Hybrid [ell.vals.flat ++ tail.vals], Xell
    [vals.flat ++ spill.vals] — the spill's per-row index tables stay, so
    the new spill values flow through their gather index —, Coo, Csr and
    Sell their flat values."""
    if isinstance(m, Dia):
        return dataclasses.replace(m, data=vals.view(m.data.shape))
    if isinstance(m, Hybrid):
        esize = m.ell.vals.numel()
        return dataclasses.replace(
            m, ell=dataclasses.replace(m.ell, vals=vals[:esize].view(m.ell.vals.shape)),
            tail=dataclasses.replace(m.tail, vals=vals[esize:]))
    if isinstance(m, (Coo, Csr, Ell, Sell)) or type(m).__name__ == "Gdia":
        return dataclasses.replace(m, vals=vals.view(m.vals.shape))
    if type(m).__name__ == "Xell":
        msize = m.vals.numel()
        return dataclasses.replace(
            m, vals=vals[:msize].view(m.vals.shape),
            spill=dataclasses.replace(m.spill, vals=vals[msize:]))
    raise TypeError(f"no value update for format {type(m).__name__}")


def values_flat(m) -> torch.Tensor:
    """The flat value storage `with_values` consumes, read back from a
    container."""
    if isinstance(m, Dia):
        return m.data.reshape(-1)
    if isinstance(m, Hybrid):
        return torch.cat([m.ell.vals.reshape(-1), m.tail.vals])
    if type(m).__name__ == "Xell":
        return torch.cat([m.vals.reshape(-1), m.spill.vals])
    return m.vals.reshape(-1)  # Coo/Csr/Ell/Sell/Gdia


def cast_values(m, dtype):
    """Same-sparsity container with every floating tensor cast to `dtype`
    (index tensors untouched; nested containers too)."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype) if v.is_floating_point() else v
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return cast_values(v, dtype)
        return v

    return dataclasses.replace(m, **{f.name: cast(getattr(m, f.name))
                                     for f in dataclasses.fields(m) if f.init})


@dataclasses.dataclass(frozen=True)
class ValueMap:
    """Static entry→slot map making the steady-state coefficient update one
    scatter on the device (the reference's in-place device value
    overwrite, CsrMatrixWrapper.H:74-136).

    `dest[i]` is the flat index of COO entry i in the container's value
    storage (int64, on the matrix's device; None = the storage IS the entry
    order: Coo, Csr, DeviceCoo).  `unique` means no two entries share a
    slot, so the scatter is a set; otherwise duplicates accumulate
    (matching the converters' bincount)."""

    dest: torch.Tensor | None
    out_shape: tuple
    unique: bool

    def update(self, m, coo_vals: torch.Tensor):
        """New container with the same sparsity, values from the row-major
        COO entry array (already on the matrix's device)."""
        if self.dest is None:
            return with_values(m, coo_vals)
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
    if isinstance(m, (Coo, Csr)):
        return ValueMap(dest=None, out_shape=(int(len(rows)),), unique=True)
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    n = m.shape[0]
    kind = type(m).__name__
    if isinstance(m, Ell):
        k, slot = ell_layout(rows, n, m.row_width)
        dest = slot * n + rows
        shape = (k, n)
        device = m.vals.device
    elif isinstance(m, Sell):
        widths, ns_of, dest, _, total = sell_layout(rows, n, m.slice_height, m.sigma)
        if (tuple(widths), tuple(ns_of)) != (m.widths, m.n_slices):
            raise ValueError(
                f"sparsity changed: SELL buckets {list(zip(ns_of, widths))} do not match "
                f"container {list(zip(m.n_slices, m.widths))}")
        dest = sell_device_index(dest, widths, ns_of, m.slice_height)
        shape = (total,)
        device = m.vals.device
    elif isinstance(m, Hybrid):
        w = m.ell.row_width
        _, slot = ell_layout(rows, n)
        in_ell = slot < w
        dest = np.empty(len(rows), np.int64)
        dest[in_ell] = slot[in_ell] * n + rows[in_ell]
        esize = int(m.ell.vals.numel())
        dest[~in_ell] = esize + np.arange(int((~in_ell).sum()))
        shape = (esize + m.tail.nnz,)
        device = m.ell.vals.device
    elif isinstance(m, Dia):
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
        raise TypeError(f"no value map for format {kind}")
    seen = np.zeros(int(np.prod(shape)), np.bool_)
    seen[dest] = True
    unique = int(seen.sum()) == len(dest)
    return ValueMap(dest=torch.tensor(dest, device=device), out_shape=shape,
                    unique=unique)
