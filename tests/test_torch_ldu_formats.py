"""The port's LDU sparsity, Dia conversion and Dia value map against the
reference's (exact equality: the same host arithmetic)."""

import dataclasses

import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu_torch import interop, registry
from ogl_tpu_torch.core import formats, ldu

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _port_ldu(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper,
                                   m.lower, m.local_interfaces)


CASES = [
    ("poisson", (16, 16, 8)),
    ("poisson", (96, 11)),
    ("convection", (20, 9, 3)),
    ("channel", (12, 6, 4)),
]


def _ref_case(kind, dims):
    return {"poisson": ref_testing.poisson_ldu,
            "convection": ref_testing.convection_diffusion_ldu,
            "channel": ref_testing.channel_ldu}[kind](dims)


@pytest.mark.parametrize("kind,dims", CASES)
def test_local_sparsity_matches_reference(kind, dims):
    m = _ref_case(kind, dims)
    ours = ldu.build_local_sparsity(_port_ldu(m))
    ref = ref_ldu.build_local_sparsity(m)
    assert (ours.n, ours.n_faces, ours.symmetric, ours.n_local_iface) == (
        ref.n, ref.n_faces, ref.symmetric, ref.n_local_iface)
    for f in ("rows", "cols", "permute"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))


@pytest.mark.parametrize("kind,dims", CASES)
def test_coo_to_dia_matches_reference(kind, dims):
    m = _ref_case(kind, dims)
    ref = ref_formats.coo_to_dia(ref_ldu.ldu_to_coo_host(m, dtype=np.float32))
    coo = ldu.ldu_to_coo_host(_port_ldu(m), dtype=np.float32)
    ours = formats.coo_to_dia(coo)
    assert ours.offsets == ref.offsets and ours.shape == ref.shape
    assert ours.data.dtype == torch.float32
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    back = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    np.testing.assert_array_equal(back.data.numpy(), ours.data.numpy())


def test_host_assembly_matches_reference():
    m = ref_testing.convection_diffusion_ldu((10, 7))
    sp = ldu.build_local_sparsity(_port_ldu(m))
    ours = ldu.assemble_coeffs_host(sp, _port_ldu(m), np.float32, scale=2.0)
    ref = ref_ldu.assemble_coeffs_host(ref_ldu.build_local_sparsity(m), m, np.float32,
                                       scale=2.0)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kind,dims", CASES)
def test_dia_value_map_update_equals_fresh_convert(kind, dims):
    """The steady-state path (resident blocks → device gather → value-map
    scatter) yields exactly the Dia data a fresh conversion of the new
    coefficients gives."""
    m0 = _ref_case(kind, dims)
    m1 = dataclasses.replace(m0, diag=np.asarray(m0.diag) * 1.01,
                             upper=np.asarray(m0.upper) * 0.5)
    p0, p1 = _port_ldu(m0), _port_ldu(m1)
    sp = ldu.build_local_sparsity(p0)
    mat0 = formats.coo_to_dia(ldu.ldu_to_coo_host(p0, dtype=np.float32))
    vm = formats.value_map(mat0, sp.rows, sp.cols)
    assert vm.unique
    blocks = [torch.tensor(b) for b in ldu.host_blocks(sp, p1, np.float32)]
    vals = ldu.assemble_from_blocks(blocks, torch.tensor(sp.permute.astype(np.int64)), 1.0)
    updated = vm.update(mat0, vals)
    fresh = formats.coo_to_dia(ldu.ldu_to_coo_host(p1, dtype=np.float32))
    np.testing.assert_array_equal(updated.data.numpy(), fresh.data.numpy())
    ref_fresh = ref_formats.coo_to_dia(ref_ldu.ldu_to_coo_host(m1, dtype=np.float32))
    np.testing.assert_array_equal(updated.data.numpy(), np.asarray(ref_fresh.data))


def test_value_map_rejects_changed_sparsity():
    m = ref_testing.poisson_ldu((8, 8))
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(_port_ldu(m), dtype=np.float32))
    other = ldu.build_local_sparsity(_port_ldu(ref_testing.poisson_ldu((8, 4, 2))))
    with pytest.raises(ValueError, match="sparsity changed"):
        formats.value_map(mat, other.rows, other.cols)


@pytest.mark.parametrize("kind,dims", CASES)
def test_native_and_numpy_sparsity_builds_agree(kind, dims, monkeypatch):
    """The native sparsity build and counting sort (the path taken where the
    native runtime builds, as the reference takes it) and the numpy branch
    give the same rows, cols and permute, local interfaces included."""
    from ogl_tpu_torch import native

    m = _port_ldu(_ref_case(kind, dims))
    fast = ldu.build_local_sparsity(m)
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = ldu.build_local_sparsity(m)
    for f in ("rows", "cols", "permute"):
        np.testing.assert_array_equal(getattr(fast, f), getattr(slow, f))
        assert getattr(fast, f).dtype == np.int32
