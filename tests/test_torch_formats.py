"""The reference-parity formats of the port (Coo, Csr, Ell, Sell, Hybrid)
against the reference's on the CPU: converters, layouts, value maps, the
flat value storage and the byte/flop model.

The converters must give the reference's containers bit for bit, Ell and
Sell mapped back from the port's slot-major layouts to the reference's;
`value_map` the reference's destinations (mapped the same way) and
uniqueness; `ValueMap.update` the container a fresh conversion of the new
values gives."""

import dataclasses

import numpy as np
import pytest
import torch

from ogl_tpu.core import formats as ref_formats
from ogl_tpu.kernels import roofline as ref_roofline
from ogl_tpu_torch import interop
from ogl_tpu_torch.core import formats
from ogl_tpu_torch.kernels import roofline

torch.set_num_threads(2)

SIZES = [1, 13, 203, 517]  # none a multiple of 8 or 64
PORT = {"Coo": formats.coo_to_device, "Csr": formats.coo_to_csr, "Ell": formats.coo_to_ell,
        "Sell": formats.coo_to_sell, "Hybrid": formats.coo_to_hybrid}
REF = {"Coo": lambda c: c, "Csr": ref_formats.coo_to_csr, "Ell": ref_formats.coo_to_ell,
       "Sell": ref_formats.coo_to_sell, "Hybrid": ref_formats.coo_to_hybrid}
FROM_REF = {"Coo": interop.coo_from_reference, "Csr": interop.csr_from_reference,
            "Ell": interop.ell_from_reference, "Sell": interop.sell_from_reference,
            "Hybrid": interop.hybrid_from_reference}


def random_dense(n, seed=0, density=0.04):
    """A seeded n x n float32 matrix with empty rows (rows 2 and 7 when they
    exist), one dense row (row n // 2) and random sparse rows."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density) * rng.normal(size=(n, n))
    a[n // 2] = rng.normal(size=n)
    for r in (2, 7):
        if r < n and r != n // 2:
            a[r] = 0.0
    return a.astype(np.float32)


def coo_pair(a):
    """(reference Coo, port host Coo) of a dense array."""
    return ref_formats.coo_from_dense(a), formats.coo_from_dense(a)


def ell_to_ref_layout(t: torch.Tensor) -> np.ndarray:
    return t.numpy().T


def sell_to_ref_layout(m: formats.Sell, t: torch.Tensor) -> np.ndarray:
    """The port's flat Sell storage in the reference's flat order."""
    idx = formats.sell_device_index(np.arange(m.stored), m.widths, m.n_slices, m.slice_height)
    return t.numpy()[idx]


def _cat(blocks):
    return np.concatenate([np.asarray(b).reshape(-1) for b in blocks])


def test_coo_from_dense_matches_reference():
    a = random_dense(203)
    ref, ours = coo_pair(a)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)))
    assert ours.shape == ref.shape and not hasattr(ours, "row_ptr")


@pytest.mark.parametrize("n", SIZES)
def test_device_coo_carries_the_csr_offsets(n):
    """The device Coo is the entries in their order with the rows' offsets:
    a Csr that answers to the name Coo."""
    ref, ours = coo_pair(random_dense(n))
    m = formats.coo_to_device(ours)
    assert isinstance(m, formats.Csr) and formats.format_name(m) == "Coo"
    for f in ("cols", "vals"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(m.row_ptr.numpy(),
                                  np.asarray(ref_formats.coo_to_csr(ref).row_ptr))
    assert m.cols.dtype == m.row_ptr.dtype == torch.int32


@pytest.mark.parametrize("n", SIZES)
def test_csr_equals_reference(n):
    ref, ours = coo_pair(random_dense(n))
    r, m = ref_formats.coo_to_csr(ref), formats.coo_to_csr(ours)
    for f in ("row_ptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(r, f)))
        assert getattr(m, f).dtype == (torch.float32 if f == "vals" else torch.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", [None, "wide"])
def test_ell_equals_reference_slot_major(n, width):
    ref, ours = coo_pair(random_dense(n))
    w = None if width is None else n + 3
    r, m = ref_formats.coo_to_ell(ref, w), formats.coo_to_ell(ours, w)
    assert m.row_width == r.row_width and m.cols.shape == (r.row_width, n)
    np.testing.assert_array_equal(ell_to_ref_layout(m.cols), np.asarray(r.cols))
    np.testing.assert_array_equal(ell_to_ref_layout(m.vals), np.asarray(r.vals))


def test_ell_too_narrow_raises_as_reference():
    ref, ours = coo_pair(random_dense(40))
    with pytest.raises(ValueError, match="exceeds requested ELL width"):
        ref_formats.coo_to_ell(ref, 2)
    with pytest.raises(ValueError, match="exceeds requested ELL width"):
        formats.coo_to_ell(ours, 2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", [None, 1, 3, 10000])
def test_hybrid_equals_reference(n, width):
    """The default 80th-percentile width, an all-tail width (1) and a width
    wider than every row (an empty tail)."""
    ref, ours = coo_pair(random_dense(n))
    r, m = ref_formats.coo_to_hybrid(ref, width), formats.coo_to_hybrid(ours, width)
    np.testing.assert_array_equal(ell_to_ref_layout(m.ell.cols), np.asarray(r.ell.cols))
    np.testing.assert_array_equal(ell_to_ref_layout(m.ell.vals), np.asarray(r.ell.vals))
    for f in ("cols", "vals"):
        np.testing.assert_array_equal(getattr(m.tail, f).numpy(), np.asarray(getattr(r.coo, f)))
    tail = np.asarray(r.coo.rows)
    np.testing.assert_array_equal(m.tail.row_ptr.numpy(),
                                  np.r_[0, np.cumsum(np.bincount(tail, minlength=n))])
    assert m.nnz == r.nnz
    if width == 10000:
        assert m.tail.nnz == 0


def many_widths_dense(n=300, seed=3):
    """Rows of 0..n//10 entries in runs, so that slices of 4 rows take more
    than 8 distinct widths (the power-of-two rounding runs)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        k = (i // 4) % 25
        a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
    return a


@pytest.mark.parametrize("n", [*SIZES, "many widths"])
@pytest.mark.parametrize("c, sigma", [(8, 64), (4, 1)])
def test_sell_equals_reference(n, c, sigma):
    a = many_widths_dense() if n == "many widths" else random_dense(n)
    ref, ours = coo_pair(a)
    rows = np.asarray(ref.rows).astype(np.int64)
    got = formats.sell_layout(rows, a.shape[0], c, sigma)
    want = ref_formats.sell_layout(rows, a.shape[0], c, sigma)
    assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    if n == "many widths" and c == 4:
        counts = np.bincount(rows, minlength=a.shape[0])
        raw = np.maximum(counts.reshape(-1, c).max(axis=1), 1)
        assert len(np.unique(raw)) > 8  # rounded to powers of two
        assert all(w & (w - 1) == 0 for w in got[0]) and len(got[0]) <= 8
    r, m = ref_formats.coo_to_sell(ref, c, sigma), formats.coo_to_sell(ours, c, sigma)
    assert m.stored == r.stored and (m.slice_height, m.sigma) == (c, sigma)
    assert m.widths == tuple(int(v.shape[2]) for v in r.vals)
    assert m.n_slices == tuple(int(v.shape[0]) for v in r.vals)
    np.testing.assert_array_equal(sell_to_ref_layout(m, m.cols), _cat(r.cols))
    np.testing.assert_array_equal(sell_to_ref_layout(m, m.vals), _cat(r.vals))
    np.testing.assert_array_equal(m.slot_rows.numpy(), _cat(r.slot_rows))
    np.testing.assert_array_equal(
        m.table.numpy(), formats.sell_table(m.widths, m.n_slices, c))


@pytest.mark.parametrize("fmt", list(PORT))
def test_from_reference_equals_conversion(fmt):
    """Bit-equal containers, but for the Ell bridge's warp slot counts: the
    bridge reads each row's length from the padding, and counts one slot
    more where the row's next slot could hold a stored zero on the diagonal
    (the row empty, or all its columns below its own), which the converter,
    knowing the entries, does not."""
    a = random_dense(203)
    ref, ours = coo_pair(a)
    got, want = FROM_REF[fmt](REF[fmt](ref)), PORT[fmt](ours)
    if fmt == "Ell":
        n, k = a.shape[0], want.row_width
        counts = np.count_nonzero(a, axis=1)
        last = np.array([np.flatnonzero(r).max(initial=-1) for r in a])
        maybe_diag = (counts < k) & (last < np.arange(n))
        assert maybe_diag.any()
        np.testing.assert_array_equal(got.warp_slots.numpy(),
                                      formats.ell_warp_slots(counts + maybe_diag, k))
        assert bool((got.warp_slots >= want.warp_slots).all())
        got = dataclasses.replace(got, warp_slots=want.warp_slots)
    for a, b in zip(_tensors(got), _tensors(want)):
        assert torch.equal(a, b)


def _tensors(m):
    """Every tensor of a container, nested ones included, in field order."""
    out = []
    for f in m.__dataclass_fields__:
        v = getattr(m, f)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif hasattr(v, "__dataclass_fields__"):
            out += _tensors(v)
    return out


@pytest.mark.parametrize("fmt", list(PORT))
def test_to_dense_matches_reference(fmt):
    a = random_dense(203)
    ref, ours = coo_pair(a)
    np.testing.assert_array_equal(formats.to_dense(PORT[fmt](ours)),
                                  np.asarray(ref_formats.to_dense(REF[fmt](ref))))
    np.testing.assert_array_equal(formats.to_dense(PORT[fmt](ours)), a)


def _port_dest(fmt, m, ref_dest, n):
    """The reference's destinations mapped to the port's layout."""
    if fmt == "Ell":
        k = m.row_width
        return (ref_dest % k) * n + ref_dest // k
    if fmt == "Sell":
        return formats.sell_device_index(ref_dest, m.widths, m.n_slices, m.slice_height)
    if fmt == "Hybrid":
        k, esize = m.ell.row_width, m.ell.vals.numel()
        ell = ref_dest < esize
        return np.where(ell, (ref_dest % k) * n + ref_dest // k, ref_dest)
    raise AssertionError(fmt)


@pytest.mark.parametrize("n", [13, 517])
@pytest.mark.parametrize("fmt", list(PORT))
def test_value_map_matches_reference_and_fresh_conversion(fmt, n):
    a = random_dense(n)
    ref, ours = coo_pair(a)
    m, r = PORT[fmt](ours), REF[fmt](ref)
    vm = formats.value_map(m, ours.rows, ours.cols)
    rvm = ref_formats.value_map(r, np.asarray(ref.rows), np.asarray(ref.cols))
    assert vm.unique == rvm.unique
    if fmt in ("Coo", "Csr"):
        assert vm.dest is None and rvm.dest is None
    else:
        np.testing.assert_array_equal(vm.dest.numpy(),
                                      _port_dest(fmt, m, np.asarray(rvm.dest, np.int64), n))
        assert int(np.prod(vm.out_shape)) == int(np.prod(rvm.out_shape))
    new = np.random.default_rng(9).normal(size=len(ours.vals)).astype(np.float32)
    got = vm.update(m, torch.tensor(new))
    fresh = PORT[fmt](formats.Coo(ours.rows, ours.cols, new, ours.shape))
    for x, y in zip(_tensors(got), _tensors(fresh)):
        assert torch.equal(x, y)
    assert torch.equal(formats.values_flat(got), formats.values_flat(fresh))


def test_value_map_refuses_a_changed_sell_sparsity():
    ref, ours = coo_pair(random_dense(203))
    m = formats.coo_to_sell(ours)
    other = formats.coo_from_dense(random_dense(203, seed=5))
    with pytest.raises(ValueError, match="sparsity changed: SELL buckets"):
        formats.value_map(m, other.rows, other.cols)


@pytest.mark.parametrize("fmt", list(PORT))
def test_values_flat_round_trips_and_casts(fmt):
    ref, ours = coo_pair(random_dense(203))
    m = PORT[fmt](ours)
    flat = formats.values_flat(m)
    again = formats.with_values(m, flat * 2)
    assert torch.equal(formats.values_flat(again), flat * 2)
    half = formats.cast_values(m, torch.bfloat16)
    for a, b in zip(_tensors(half), _tensors(m)):
        assert a.dtype == (torch.bfloat16 if b.is_floating_point() else b.dtype)
        assert torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("fmt", ["Coo", "Csr", "Ell", "Sell", "Hybrid", "Dia"])
def test_spmv_bytes_and_flops_match_reference(fmt):
    """Hybrid has no byte model in the reference: both raise TypeError.
    The reference's Coo model is the host Coo's; the device Coo, stored as
    a Csr, moves a Csr's bytes."""
    ref, ours = coo_pair(random_dense(203))
    if fmt == "Dia":
        m, r = formats.coo_to_dia(ours), ref_formats.coo_to_dia(ref)
    elif fmt == "Coo":
        m, r = ours, ref
        assert (roofline.spmv_bytes(formats.coo_to_device(ours))
                == roofline.spmv_bytes(formats.coo_to_csr(ours)))
    else:
        m, r = PORT[fmt](ours), REF[fmt](ref)
    if fmt == "Hybrid":
        with pytest.raises(TypeError):
            ref_roofline.spmv_bytes(r)
        with pytest.raises(TypeError):
            roofline.spmv_bytes(m)
    else:
        assert roofline.spmv_bytes(m) == ref_roofline.spmv_bytes(r)
    assert roofline.spmv_flops(m) == ref_roofline.spmv_flops(r)
