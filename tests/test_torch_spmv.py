"""The port's Dia SpMV (plain version, which the wrapper runs for CPU
tensors) against the reference's XLA `spmv_dia` and its Pallas kernel in
interpret mode.  Tolerance rtol=1e-5, atol=1e-5·max|y|: the float32 sums
run in another order than the Pallas kernel's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.kernels.pallas_spmv import dia_matvec
from ogl_tpu_torch import interop, kernels, registry
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv, dia_spmv_plain

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _poisson(dims):
    return ref_formats.coo_to_dia(
        ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(dims), dtype=np.float32))


def _banded(n=512, seed=1):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for off in (-5, -1, 0, 1, 5):
        idx = np.arange(max(0, -off), min(n, n - off))
        a[idx, idx + off] = rng.normal(size=len(idx))
    return ref_formats.coo_to_dia(ref_formats.coo_from_dense(a)), a


def _close(y, y_ref):
    np.testing.assert_allclose(y, y_ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(y_ref).max())))


@pytest.mark.parametrize("case", ["poisson2d", "banded5"])
def test_dia_spmv_plain_matches_reference(case):
    ref = _poisson((64, 8)) if case == "poisson2d" else _banded()[0]
    n = ref.shape[0]
    x = np.random.default_rng(0).normal(size=n).astype(np.float32)
    y_xla = np.asarray(ref_spmv.spmv_dia(ref, jnp.asarray(x)))
    y_pallas = np.asarray(dia_matvec(ref, tile=8, interpret=True)(jnp.asarray(x)))
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    y = dia_spmv_plain(mat.data, mat.offsets, torch.tensor(x)).numpy()
    assert y.dtype == np.float32
    _close(y, y_xla)
    _close(y, y_pallas)


def test_banded_matches_dense_product():
    ref, a = _banded(n=300, seed=3)
    x = np.random.default_rng(2).normal(size=300).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    _close(spmv.spmv(mat, torch.tensor(x)).numpy(), a.astype(np.float64) @ x)


def test_matvec_on_cpu_runs_plain_and_counts_no_launch():
    ref = _poisson((32, 8, 4))
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    x = torch.tensor(np.random.default_rng(0).normal(size=ref.shape[0]).astype(np.float32))
    kernels.reset_launches()
    y = spmv.matvec(mat)(x)
    assert kernels.launches["dia_spmv"] == 0
    torch.testing.assert_close(y, dia_spmv_plain(mat.data, mat.offsets, x), rtol=0, atol=0)
    # Coo plain product agrees with the Dia one
    coo = ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu((32, 8, 4)), dtype=np.float32)
    from ogl_tpu_torch.core.formats import Coo

    y_coo = spmv.spmv(Coo(coo.rows, coo.cols, coo.vals, coo.shape), x)
    _close(y_coo.numpy(), y.numpy())


def test_wrapper_raises_off_cpu_without_kernel():
    plan = DiaPlan(8, (-1, 0, 1), "cpu")
    data = torch.ones((3, 8))
    with pytest.raises(ValueError, match="no kernel"):
        dia_spmv(plan, data, torch.ones(8, device="meta"))


@pytest.mark.parametrize("dims", [(16, 16, 8), (200,)])
def test_fits_dia_matches_reference_pack_fast(dims):
    coo = ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(dims), dtype=np.float32)
    ref_is_dia = isinstance(ref_spmv.pack_fast(coo.rows, coo.cols, coo.vals, coo.shape[0],
                                               presorted=True), ref_formats.Dia)
    assert spmv.fits_dia(coo.rows, coo.cols, coo.shape[0]) == ref_is_dia
    rng = np.random.default_rng(0)
    n = 400
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, size=3 * n)
    assert not spmv.fits_dia(rows, cols, n)
