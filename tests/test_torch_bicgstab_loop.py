"""The BiCGStab loop kernel's plain twin (`bicgstab_loop_plain`: the merged
BiCGStab loop, criterion included, over the plan's K1B and KB_update)
against the reference's merged BiCGStab (`ogl_tpu.solve.bicgstab_fused`,
Pallas in interpret mode) on the same numpy inputs on Dia systems, and the
dispatch of `CgKernels.bicgstab_loop` and `bicgstab_fused` on CPU tensors.

Pinned iterations (tolerance 0, minIter = maxIter = 10) have no stop
decision a one-ulp difference could flip: x within rtol 1e-4.  Float32
BiCGStab on a Poisson system parts from another summation order after ten
to fifteen iterations (tests/test_torch_bicgstab.py), so the free-running
solve runs on the convection–diffusion system, on which both packages
converge smoothly: ±1 iteration, x atol 1e-3."""

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
from ogl_tpu.solve.bicgstab_fused import bicgstab_fused as ref_bicgstab_fused
from ogl_tpu_torch import interop, kernels
from ogl_tpu_torch.kernels.fused import (CgKernels, bicgstab_loop_plain, k1b_plain,
                                         kb_update_plain)
from ogl_tpu_torch.solve import bicgstab_fused
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

torch.set_num_threads(2)

# the systems of tests/test_torch_bicgstab.py
PROBLEMS = {"poisson": lambda: ref_testing.poisson_ldu((128, 8)),
            "convection_diffusion": lambda: ref_testing.convection_diffusion_ldu((16, 12))}
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)
FREE = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400)
# checked at 0 and at 6, 9, 12 (minIter 5, frequency 3): convection–diffusion
# meets the tolerance between the checks at 6 and 9 and stops at 9, Poisson
# runs into maxIter, so the count says whether the gating matches
GATED = StoppingConfig(tolerance=5e-4, rel_tol=0.0, min_iter=5, max_iter=12, frequency=3)
# tolerance 0: the loop runs maxIter iterations through the breakdown guards
GUARDED = StoppingConfig(tolerance=0.0, rel_tol=0.0, max_iter=6)


@functools.lru_cache(maxsize=None)
def _system(name):
    """(reference Dia, port Dia, dense A, b = A·x_true) of PROBLEMS[name]."""
    m = PROBLEMS[name]()
    ref = ref_formats.coo_to_dia(ref_ldu.ldu_to_coo_host(m, dtype=np.float32))
    a = ref_testing.to_dense_ldu(m)
    x_true = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, mat, a, b


def _setup(mat, b, x0):
    """The plan, its data and the set-up of solve/bicgstab_fused.py: x, r =
    b − A x, r̂ = r, ρ = Σ r·r, ‖r‖₁ and the norm factor."""
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    x = torch.tensor(x0)
    r = bt - kern.apply(data, x)
    nf = merged_norm_factor(kern, data, r, x, bt)
    return kern, data, x, (r, r.clone(), torch.sum(r * r), torch.sum(torch.abs(r)), nf)


def _twin(mat, b, cfg, x0=None):
    """The twin over the plain K1B and KB_update from the set-up: (x, *record)."""
    x0 = np.zeros_like(b) if x0 is None else x0
    kern, data, x, state = _setup(mat, b, x0)
    k1b = functools.partial(k1b_plain, data, kern.offsets)
    return (x, *bicgstab_loop_plain(k1b, kb_update_plain, x, *state, cfg))


def _reference(ref, b, cfg, x0=None):
    rkern, data3 = make_cg_kernels(ref, tile=16, interpret=True)
    bj = jnp.asarray(b)
    return ref_bicgstab_fused(rkern, data3, bj,
                              jnp.zeros_like(bj) if x0 is None else jnp.asarray(x0), cfg)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_pinned_twin_matches_reference(problem):
    ref, mat, _, b = _system(problem)
    x, iters, _, init_rn, converged = _twin(mat, b, PINNED)
    want = _reference(ref, b, PINNED)
    assert iters == int(want.iters) == 10
    assert not converged and not bool(want.converged)
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(x_ref).max()))
    np.testing.assert_allclose(float(init_rn), float(want.init_res_norm), rtol=1e-4)


def test_free_running_twin_matches_reference():
    ref, mat, _, b = _system("convection_diffusion")
    x, iters, rn, _, converged = _twin(mat, b, FREE)
    want = _reference(ref, b, FREE)
    assert bool(converged) and bool(want.converged) and float(rn) < FREE.tolerance
    assert abs(iters - int(want.iters)) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(want.x), atol=1e-3)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_gated_criterion_matches_reference(problem):
    ref, mat, _, b = _system(problem)
    x, iters, rn, _, converged = _twin(mat, b, GATED)
    want = _reference(ref, b, GATED)
    assert iters == int(want.iters)
    assert iters in (6, 9, 12) and bool(converged) == bool(want.converged)
    np.testing.assert_allclose(float(rn), float(want.final_res_norm), rtol=1e-3)


# (problem, start): x0 = 1 solves the Poisson system exactly; b = 0 on both
BREAKDOWN = [("poisson", "x0 solves"), ("poisson", "b zero"), ("convection_diffusion", "b zero")]


@pytest.mark.parametrize("cfg", [FREE, GUARDED], ids=["tolerance", "tolerance0"])
@pytest.mark.parametrize("problem,start", BREAKDOWN)
def test_breakdown_guard_keeps_x(problem, start, cfg):
    """r0 = 0 exactly: x0 = 1 on the Poisson system with b = A·1 (whole
    numbers, exact in float32 on both sides), or b = 0 and x0 = 0.  Every
    inner product is 0, so the guards give α = ω = β = 0: the result is
    finite, x is unchanged, and the count is the reference's (0 when the
    tolerance stops the first check, maxIter when it is 0)."""
    ref, mat, a, _ = _system(problem)
    if start == "x0 solves":
        x0 = np.ones(mat.shape[0], np.float32)
        b = (a @ x0.astype(np.float64)).astype(np.float32)
    else:
        x0 = np.zeros(mat.shape[0], np.float32)
        b = np.zeros(mat.shape[0], np.float32)
    x, iters, rn, init_rn, _ = _twin(mat, b, cfg, x0)
    want = _reference(ref, b, cfg, x0)
    assert iters == int(want.iters) == (0 if cfg is FREE else cfg.max_iter)
    assert torch.equal(x, torch.tensor(x0))
    assert np.array_equal(np.asarray(want.x), x0)
    assert float(rn) == float(init_rn) == 0.0


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_cpu_dispatch_runs_the_plain_twin(problem):
    """CPU tensors through CgKernels.bicgstab_loop run the twin (no launch is
    counted) and return the record's four fields, bit-equal to the twin over
    the plan's K1B and KB_update; bicgstab_fused on CPU tensors gives the
    same iterate, count and norms."""
    _, mat, _, b = _system(problem)
    cfg = GATED
    x0 = np.zeros_like(b)
    kern, data, x_t, state_t = _setup(mat, b, x0)
    twin = bicgstab_loop_plain(functools.partial(kern.k1b, data), kern.kb_update, x_t,
                               *state_t, cfg)
    kern, data, x, state = _setup(mat, b, x0)
    kernels.reset_launches()
    got = kern.bicgstab_loop(data, x, *state, cfg)
    assert sum(kernels.launches.values()) == 0
    iters, rn, init_rn, converged = got
    assert isinstance(iters, int) and iters == twin[0] > 0
    assert all(isinstance(t, torch.Tensor) and t.dim() == 0 for t in (rn, init_rn, converged))
    assert all(torch.equal(g, t) for g, t in zip(got[1:], twin[1:]))
    torch.testing.assert_close(x, x_t, rtol=0, atol=0)
    res = bicgstab_fused(kern, data, torch.tensor(b), torch.zeros(len(b)), cfg)
    assert sum(kernels.launches.values()) == 0
    assert res.iters == twin[0] and torch.equal(res.converged, twin[3])
    torch.testing.assert_close(res.x, x_t, rtol=0, atol=0)
    torch.testing.assert_close(res.final_res_norm, twin[1], rtol=0, atol=0)
    torch.testing.assert_close(res.init_res_norm, twin[2], rtol=0, atol=0)
