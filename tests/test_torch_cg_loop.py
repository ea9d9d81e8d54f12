"""The loop kernel's plain twin (`cg_loop_plain`: the merged CG loop with
identity preconditioning, criterion included) against the reference's
merged CG (`ogl_tpu.solve.cg_fused`, Pallas in interpret mode), on the same
numpy inputs, and the dispatch of `CgKernels.cg_loop` and `cg_fused` on
CPU tensors.

Pinned iterations (tolerance 0, minIter = maxIter = 40) have no stop
decision a one-ulp difference could flip: x within rtol 1e-4.  A
free-running solve may stop one checked iteration apart (the sums are
taken in another order): |Δiterations| ≤ frequency, x atol 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.solve.cg_fused import cg_fused as ref_cg_fused
from ogl_tpu_torch import interop, kernels
from ogl_tpu_torch.kernels.fused import CgKernels, cg_loop_plain
from ogl_tpu_torch.solve.cg_fused import cg_fused, merged_norm_factor

torch.set_num_threads(2)

# name -> (stopping controls, the initial guess / right-hand side)
CASES = {
    "pinned": (StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=40, max_iter=40), "zero"),
    "free": (StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400), "zero"),
    "frequency8_minIter5": (StoppingConfig(tolerance=5e-5, rel_tol=0.0, min_iter=5,
                                           max_iter=400, frequency=8), "zero"),
    "relTol": (StoppingConfig(tolerance=0.0, rel_tol=1e-3, max_iter=400), "zero"),
    "maxIter": (StoppingConfig(tolerance=1e-12, rel_tol=0.0, max_iter=10), "zero"),
    "b_zero": (StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400), "b=0"),
    "x0_converged": (StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400), "x0=x"),
}


@pytest.fixture(scope="module", params=[(128, 8), (96, 11)], ids=str)
def system(request):
    ref = ref_formats.coo_to_dia(
        ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(request.param), dtype=np.float32))
    a = ref_testing.poisson_dense(request.param)
    x_true = np.random.default_rng(0).normal(size=ref.shape[0]).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, mat, b, x_true


def _inputs(system, start):
    _, _, b, x_true = system
    if start == "b=0":
        return np.zeros_like(b), np.zeros_like(b)
    return b, (x_true if start == "x0=x" else np.zeros_like(b))


def _loop_state(kern, data, b, x0):
    """The set-up of solve/cg_fused.py: x, r = b − A x, ρ, ‖r‖₁, nf."""
    x = x0.clone()
    r = b - kern.apply(data, x)
    return (x, r, torch.sum(r * r), torch.sum(torch.abs(r)),
            merged_norm_factor(kern, data, r, x, b))


def _port(mat, b, x0, cfg):
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    data = kern.pack_values(mat)
    x, r, rho, absr, nf = _loop_state(kern, data, torch.tensor(b), torch.tensor(x0))
    return (x, *cg_loop_plain(data, mat.offsets, x, r, rho, absr, nf, cfg))


def _reference(ref, b, x0, cfg):
    rkern, data3 = make_cg_kernels(ref, tile=16, interpret=True)
    return ref_cg_fused(rkern, data3, jnp.asarray(b), jnp.asarray(x0), cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_plain_matches_reference(system, name):
    cfg, start = CASES[name]
    ref, mat, b, _ = system
    b, x0 = _inputs(system, start)
    x, iters, rn, init_rn, converged = _port(mat, b, x0, cfg)
    want = _reference(ref, b, x0, cfg)
    want_iters = int(want.iters)
    x_ref = np.asarray(want.x)
    assert bool(converged) == bool(want.converged)
    if name == "pinned":
        assert iters == want_iters == 40
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(x_ref).max()))
    else:
        assert abs(iters - want_iters) <= cfg.frequency
        np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-3)
    np.testing.assert_allclose(float(init_rn), float(want.init_res_norm), rtol=1e-4)
    if name == "frequency8_minIter5":
        assert converged and iters % 8 == 0 and iters >= 8
    if name == "relTol":
        assert converged and float(rn) < 1e-3 * float(init_rn)
    if name == "maxIter":
        assert not converged and iters == 10
    if name in ("b_zero", "x0_converged"):
        assert converged and iters == want_iters == 0
        np.testing.assert_array_equal(x.numpy(), x0)


@pytest.mark.parametrize("name", ["free", "frequency8_minIter5"])
def test_cpu_dispatch_runs_the_plain_twin(system, name):
    """CPU tensors through CgKernels.cg_loop run cg_loop_plain (no launch is
    counted), and cg_fused on CPU keeps its host loop: the same iterate and
    count, bit for bit, as the twin."""
    cfg, start = CASES[name]
    _, mat, b, _ = system
    b, x0 = _inputs(system, start)
    x_twin, *twin = _port(mat, b, x0, cfg)
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    kernels.reset_launches()
    x, r, rho, absr, nf = _loop_state(kern, data, bt, torch.tensor(x0))
    got = kern.cg_loop(data, x, r, rho, absr, nf, cfg)
    assert kernels.launches["cg_loop"] == 0
    assert got[0] == twin[0] and all(torch.equal(g, t) for g, t in zip(got[1:], twin[1:]))
    torch.testing.assert_close(x, x_twin, rtol=0, atol=0)
    res = cg_fused(kern, data, bt, torch.tensor(x0), cfg)
    assert res.iters == twin[0] and torch.equal(res.converged, twin[3])
    torch.testing.assert_close(res.x, x_twin, rtol=0, atol=0)
    torch.testing.assert_close(res.final_res_norm, twin[1], rtol=0, atol=0)
