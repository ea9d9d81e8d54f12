"""The port's merged-kernel CG (plain kernels: CPU tensors) against the
reference's merged-kernel CG (Pallas in interpret mode) and general CG,
for `none` and scalar Jacobi.

Pinned iterations (tolerance 0, minIter = maxIter = 40) compare the
trajectories with no stop decision that a one-ulp difference could flip:
x within rtol=1e-4.  Free-running solves (tolerance 5e-5, as in
tests/test_cg_fused.py) may stop one iteration apart: |Δiterations| ≤ 1,
x atol=1e-3, final residual rtol=1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.precond.jacobi import diagonal_of as ref_diagonal_of
from ogl_tpu.solve import cg as ref_cg
from ogl_tpu.solve.cg_fused import cg_fused as ref_cg_fused
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import interop, registry
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.solve import cg, cg_fused
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

FREE = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400)
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=40, max_iter=40)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _setup(dims):
    m = ref_testing.poisson_ldu(dims)
    coo = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
    ref = ref_formats.coo_to_dia(coo)
    a = ref_testing.poisson_dense(dims)
    x_true = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    invd = (1.0 / ref_diagonal_of(coo)).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, mat, b, invd, x_true


def _port_fused(mat, b, invd, cfg, jacobi):
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    bt = torch.tensor(b)
    return cg_fused(kern, kern.pack_values(mat), bt, torch.zeros_like(bt), cfg,
                    invd=torch.tensor(invd) if jacobi else None)


def _ref_fused(ref, b, invd, cfg, jacobi):
    kern, data3 = make_cg_kernels(ref, tile=16, interpret=True)
    bj = jnp.asarray(b)
    return ref_cg_fused(kern, data3, bj, jnp.zeros_like(bj), cfg,
                        invd=jnp.asarray(invd) if jacobi else None)


def _ref_general(ref, b, invd, cfg, jacobi):
    pc = (lambda r: jnp.asarray(invd) * r) if jacobi else None
    ops = ref_ops(ref_spmv.matvec(ref), ref.shape[0], precond=pc)
    bj = jnp.asarray(b)
    return ref_cg(ops, bj, jnp.zeros_like(bj), cfg)


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
def test_pinned_trajectory_matches_reference(jacobi):
    ref, mat, b, invd, _ = _setup((128, 8))
    ours = _port_fused(mat, b, invd, PINNED, jacobi)
    want = _ref_fused(ref, b, invd, PINNED, jacobi)
    assert ours.iters == int(want.iters) == 40
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(ours.x.numpy(), x_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(x_ref).max()))
    np.testing.assert_allclose(float(ours.final_res_norm), float(want.final_res_norm),
                               rtol=1e-3)


@pytest.mark.parametrize("dims", [(128, 8), (96, 11)])
@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
def test_free_running_matches_reference(dims, jacobi):
    ref, mat, b, invd, x_true = _setup(dims)
    ours = _port_fused(mat, b, invd, FREE, jacobi)
    assert bool(ours.converged)
    for want in (_ref_fused(ref, b, invd, FREE, jacobi),
                 _ref_general(ref, b, invd, FREE, jacobi)):
        assert bool(want.converged)
        assert abs(ours.iters - int(want.iters)) <= 1
        np.testing.assert_allclose(ours.x.numpy(), np.asarray(want.x), atol=1e-3)
        np.testing.assert_allclose(float(ours.final_res_norm),
                                   float(want.final_res_norm), rtol=1e-3)
    np.testing.assert_allclose(ours.x.numpy(), x_true, atol=5e-2)


def test_frequency_gates_the_check():
    ref, mat, b, invd, _ = _setup((128, 8))
    cfg = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400, frequency=8)
    ours = _port_fused(mat, b, invd, cfg, jacobi=False)
    assert bool(ours.converged)
    assert ours.iters % 8 == 0


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
def test_general_cg_agrees_with_fused(jacobi):
    ref, mat, b, invd, _ = _setup((96, 11))
    fused = _port_fused(mat, b, invd, FREE, jacobi)
    it = torch.tensor(invd)
    ops = single_device_ops(spmv.matvec(mat), mat.shape[0],
                            precond=(lambda r: it * r) if jacobi else None)
    bt = torch.tensor(b)
    general = cg(ops, bt, torch.zeros_like(bt), FREE)
    assert bool(general.converged)
    assert abs(general.iters - fused.iters) <= 1
    np.testing.assert_allclose(general.x.numpy(), fused.x.numpy(), atol=1e-3)


def test_identity_and_unit_jacobi_give_identical_iterates():
    """K2i (z ≡ r) and K2 with invd = 1 compute the same numbers, so the
    port needs no working-set gate to stay exact."""
    ref, mat, b, _, _ = _setup((128, 8))
    ones = np.ones(mat.shape[0], np.float32)
    plain = _port_fused(mat, b, ones, FREE, jacobi=False)
    unit = _port_fused(mat, b, ones, FREE, jacobi=True)
    assert plain.iters == unit.iters
    torch.testing.assert_close(plain.x, unit.x, rtol=0, atol=0)
