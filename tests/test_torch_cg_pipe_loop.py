"""The pipelined loop kernel's plain twin (`cg_pipe_loop_plain`: the merged
pipelined CG loop, criterion included, over the plan's KA and KB_pipe with
identity or scalar Jacobi preconditioning) against the reference's merged
pipelined CG (`ogl_tpu.solve.cg_pipe_fused`, Pallas in interpret mode) on
the same numpy inputs on Dia Poisson systems, and the dispatch of
`CgKernels.cg_pipe_loop` and `cg_pipelined_fused` on CPU tensors.

Pinned iterations (tolerance 0, minIter = maxIter = 40) have no stop
decision a one-ulp difference could flip: x within rtol 1e-4.  A
free-running solve may stop one checked iteration apart (the sums are
taken in another order): |Δiterations| ≤ frequency, x atol 1e-3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.solve.cg_pipe_fused import cg_pipelined_fused as ref_cg_pipelined_fused
from ogl_tpu_torch import interop, kernels
from ogl_tpu_torch.kernels.fused import CgKernels, cg_pipe_loop_plain
from ogl_tpu_torch.solve import cg_pipelined_fused
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

torch.set_num_threads(2)

CASES = {
    "pinned": StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=40, max_iter=40),
    "free": StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400),
    "frequency8_minIter5": StoppingConfig(tolerance=5e-5, rel_tol=0.0, min_iter=5,
                                          max_iter=400, frequency=8),
    "maxIter": StoppingConfig(tolerance=1e-12, rel_tol=0.0, max_iter=10),
}


@pytest.fixture(scope="module", params=[(128, 8), (96, 11)], ids=str)
def system(request):
    ref = ref_formats.coo_to_dia(
        ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(request.param), dtype=np.float32))
    a = ref_testing.poisson_dense(request.param)
    x_true = np.random.default_rng(0).normal(size=ref.shape[0]).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    invd = (1.0 / np.asarray(ref.data)[list(ref.offsets).index(0)]).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, mat, b, invd


def _setup(mat, b):
    """The plan, its data and the set-up of solve/cg_pipe_fused.py from a
    zero guess: x, r = b − A x and the norm factor."""
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    x = torch.zeros_like(bt)
    r = bt - kern.apply(data, x)
    return kern, data, x, r, merged_norm_factor(kern, data, r, x, bt)


def _port(mat, b, cfg, invd=None):
    """The twin over the plan's KA and KB_pipe from the set-up: (x, *record)."""
    kern, data, x, r, nf = _setup(mat, b)
    invd = None if invd is None else torch.tensor(invd)
    return (x, *cg_pipe_loop_plain(functools.partial(kern.ka, data), kern.kb_pipe, x, r, nf,
                                   cfg, invd))


def _reference(ref, b, cfg, invd=None):
    rkern, data3 = make_cg_kernels(ref, tile=16, interpret=True)
    bj = jnp.asarray(b)
    return ref_cg_pipelined_fused(rkern, data3, bj, jnp.zeros_like(bj), cfg,
                                  invd=None if invd is None else jnp.asarray(invd))


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("name", list(CASES))
def test_pipe_loop_plain_matches_reference(system, name, pc):
    cfg = CASES[name]
    ref, mat, b, invd = system
    invd = invd if pc == "BJ" else None
    x, iters, rn, init_rn, converged = _port(mat, b, cfg, invd)
    want = _reference(ref, b, cfg, invd)
    want_iters, x_ref = int(want.iters), np.asarray(want.x)
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
    if name == "maxIter":
        assert not converged and iters == want_iters == 10
        np.testing.assert_allclose(float(rn), float(want.final_res_norm), rtol=1e-3)


@pytest.mark.parametrize("pc", ["none", "BJ"])
def test_cpu_dispatch_runs_the_plain_twin(system, pc):
    """CPU tensors through CgKernels.cg_pipe_loop run the twin (no launch is
    counted) and return the record's four fields; cg_pipelined_fused on CPU
    tensors gives the same iterate, count and norms, bit for bit."""
    _, mat, b, invd_np = system
    invd_np = invd_np if pc == "BJ" else None
    invd = None if invd_np is None else torch.tensor(invd_np)
    cfg = CASES["frequency8_minIter5"]
    x_twin, *twin = _port(mat, b, cfg, invd_np)
    kern, data, x, r, nf = _setup(mat, b)
    kernels.reset_launches()
    got = kern.cg_pipe_loop(data, x, r, nf, cfg, invd)
    assert sum(kernels.launches.values()) == 0
    iters, rn, init_rn, converged = got
    assert isinstance(iters, int) and iters == twin[0] > 0
    assert all(isinstance(t, torch.Tensor) and t.dim() == 0 for t in (rn, init_rn, converged))
    assert bool(converged) and float(rn) < cfg.tolerance < float(init_rn)
    assert all(torch.equal(g, t) for g, t in zip(got[1:], twin[1:]))
    torch.testing.assert_close(x, x_twin, rtol=0, atol=0)
    res = cg_pipelined_fused(kern, data, torch.tensor(b), torch.zeros(len(b)), cfg, invd=invd)
    assert sum(kernels.launches.values()) == 0
    assert res.iters == twin[0] and torch.equal(res.converged, twin[3])
    torch.testing.assert_close(res.x, x_twin, rtol=0, atol=0)
    torch.testing.assert_close(res.final_res_norm, twin[1], rtol=0, atol=0)
    torch.testing.assert_close(res.init_res_norm, twin[2], rtol=0, atol=0)
