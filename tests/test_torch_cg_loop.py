"""The loop kernel's plain twin (`cg_loop_plain`: the merged CG loop,
criterion included, over the plan's K1 with identity or scalar Jacobi
preconditioning) against the reference's merged CG
(`ogl_tpu.solve.cg_fused`, Pallas in interpret mode), on the same numpy
inputs — on a Dia matrix, and on a Gdia matrix (the shuffled grid) — and
the dispatch of `CgKernels.cg_loop`, `GdiaCgKernels.cg_loop` and
`cg_fused` on CPU tensors.

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
from ogl_tpu.kernels import gdia as ref_gdia
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.solve.cg_fused import cg_fused as ref_cg_fused
from ogl_tpu_torch import interop, kernels, testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.kernels import gdia
from ogl_tpu_torch.kernels.fused import CgKernels, GdiaCgKernels, cg_loop_plain
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


def _loop_state(kern, data, b, x0, invd=None):
    """The set-up of solve/cg_fused.py: x, r = b − A x, ρ, ‖r‖₁, nf (and
    z = invd ⊙ r, ρ = Σ r·z with Jacobi)."""
    x = x0.clone()
    r = b - kern.apply(data, x)
    z = None if invd is None else invd * r
    return (x, r, torch.sum(r * (r if z is None else z)), torch.sum(torch.abs(r)),
            merged_norm_factor(kern, data, r, x, b), z)


def _port(mat, b, x0, cfg, invd=None):
    """The twin over the plan's K1 from the set-up: (x, *record)."""
    kern = _plan(mat)
    data = kern.pack_values(mat)
    invd = None if invd is None else torch.tensor(invd)
    x, r, rho, absr, nf, z = _loop_state(kern, data, torch.tensor(b), torch.tensor(x0), invd)
    return (x, *cg_loop_plain(functools.partial(kern.k1, data), x, r, rho, absr, nf, cfg,
                              invd, z))


def _plan(mat):
    if isinstance(mat, gdia.Gdia):
        return GdiaCgKernels(mat.shape[0], mat.plane_offsets, "cpu")
    return CgKernels(mat.shape[0], mat.offsets, "cpu")


def _reference(ref, b, x0, cfg, invd=None):
    rkern, data3 = make_cg_kernels(ref, tile=16, interpret=True)
    return ref_cg_fused(rkern, data3, jnp.asarray(b), jnp.asarray(x0), cfg,
                        invd=None if invd is None else jnp.asarray(invd))


def _dia_invd(ref):
    return (1.0 / np.asarray(ref.data)[list(ref.offsets).index(0)]).astype(np.float32)


def _check_against_reference(name, got, want, x0, frequency):
    x, iters, rn, init_rn, converged = got
    want_iters = int(want.iters)
    x_ref = np.asarray(want.x)
    assert bool(converged) == bool(want.converged)
    if name == "pinned":
        assert iters == want_iters == 40
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(x_ref).max()))
    else:
        assert abs(iters - want_iters) <= frequency
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


@pytest.mark.parametrize("name", list(CASES))
def test_loop_plain_matches_reference(system, name):
    cfg, start = CASES[name]
    ref, mat, _, _ = system
    b, x0 = _inputs(system, start)
    _check_against_reference(name, _port(mat, b, x0, cfg), _reference(ref, b, x0, cfg), x0,
                             cfg.frequency)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_plain_jacobi_matches_reference(system, name):
    """The twin with scalar Jacobi (K2: z = invd ⊙ r, ρ = Σ r·z) against the
    reference's merged CG with the same invd."""
    cfg, start = CASES[name]
    ref, mat, _, _ = system
    b, x0 = _inputs(system, start)
    invd = _dia_invd(ref)
    _check_against_reference(name, _port(mat, b, x0, cfg, invd),
                             _reference(ref, b, x0, cfg, invd), x0, cfg.frequency)


# the shuffled grid (renumbered inside each 128-cell run) at 4,096 rows:
# Gdia with 9 planes (a run holds four x-lines, so the y-neighbours share
# its block row), two reference tiles of 16 block rows
GDIA_DIMS = (32, 16, 8)
GDIA_CASES = ("pinned", "free", "frequency8_minIter5")


@pytest.fixture(scope="module")
def gdia_system():
    coo = ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu(GDIA_DIMS), dtype=np.float32)
    mat = gdia.gdia_from_coo(coo)
    ref = ref_gdia.gdia_from_coo(ref_formats.Coo(rows=coo.rows, cols=coo.cols, vals=coo.vals,
                                                 shape=tuple(coo.shape)))
    n = coo.shape[0]
    diag = np.zeros(n, np.float32)
    on = np.asarray(coo.rows) == np.asarray(coo.cols)
    diag[np.asarray(coo.rows)[on]] = np.asarray(coo.vals)[on]
    b = np.random.default_rng(0).normal(size=n).astype(np.float32)
    return ref, mat, b, (1.0 / diag).astype(np.float32)


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("name", GDIA_CASES)
def test_gdia_loop_plain_matches_reference(gdia_system, name, pc):
    """The twin over the Gdia K1 against the reference's merged CG over its
    GdiaCgKernels (lane-gather K1 in interpret mode)."""
    cfg, _ = CASES[name]
    ref, mat, b, invd = gdia_system
    invd = invd if pc == "BJ" else None
    x0 = np.zeros_like(b)
    assert len(mat.plane_offsets) == 9
    _check_against_reference(name, _port(mat, b, x0, cfg, invd),
                             _reference(ref, b, x0, cfg, invd), x0, cfg.frequency)


def _dispatch_matches_twin(mat, b, x0, cfg, invd=None):
    """CPU tensors through the plan's cg_loop run cg_loop_plain (no launch is
    counted), and cg_fused on CPU keeps its host loop: the same iterate and
    count, bit for bit, as the twin."""
    x_twin, *twin = _port(mat, b, x0, cfg, invd)
    kern = _plan(mat)
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    invd = None if invd is None else torch.tensor(invd)
    kernels.reset_launches()
    x, r, rho, absr, nf, z = _loop_state(kern, data, bt, torch.tensor(x0), invd)
    got = kern.cg_loop(data, x, r, rho, absr, nf, cfg, invd=invd, z=z)
    assert sum(kernels.launches.values()) == 0
    assert got[0] == twin[0] and all(torch.equal(g, t) for g, t in zip(got[1:], twin[1:]))
    torch.testing.assert_close(x, x_twin, rtol=0, atol=0)
    res = cg_fused(kern, data, bt, torch.tensor(x0), cfg, invd=invd)
    assert res.iters == twin[0] and torch.equal(res.converged, twin[3])
    torch.testing.assert_close(res.x, x_twin, rtol=0, atol=0)
    torch.testing.assert_close(res.final_res_norm, twin[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["free", "frequency8_minIter5"])
def test_cpu_dispatch_runs_the_plain_twin(system, name):
    cfg, start = CASES[name]
    _, mat, _, _ = system
    b, x0 = _inputs(system, start)
    _dispatch_matches_twin(mat, b, x0, cfg)


@pytest.mark.parametrize("route", ["Dia BJ", "Gdia none", "Gdia BJ"])
def test_cpu_dispatch_with_jacobi_and_gdia(system, gdia_system, route):
    """As above for the loop's three other variants."""
    cfg, _ = CASES["free"]
    if route == "Dia BJ":
        ref, mat, b, _ = system
        invd = _dia_invd(ref)
    else:
        _, mat, b, invd = gdia_system
        invd = invd if route.endswith("BJ") else None
    _dispatch_matches_twin(mat, b, np.zeros_like(b), cfg, invd)
    with pytest.raises(ValueError, match="invd and z"):
        kern = _plan(mat)
        kern.cg_loop(kern.pack_values(mat), *(torch.zeros(len(b)),) * 2, *(torch.ones(()),) * 3,
                     cfg, invd=torch.ones(len(b)))
