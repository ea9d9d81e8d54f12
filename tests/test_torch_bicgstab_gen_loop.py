"""The general-BiCGStab loop kernel's plain twin (`bicgstab_gen_loop_plain`,
the host loop of solve/bicgstab.py, over the twins of its phases A, B and
the update) against the reference's general BiCGStab (`ogl_tpu.solve.bicgstab`,
its matvec as the reference's own tests run it on the CPU) on the same numpy
inputs, on Dia and Gdia matrices with preconditioner `none` and scalar `BJ`;
the phase twins against the recurrence's expressions; and the dispatch of
GKOBiCGStab (route "bicgstab") through `foam.solve` on CPU tensors, which
runs the twin where the loop kernel would take the solve on the card.

Pinned iterations (tolerance 0, minIter = maxIter = 10) have no stop
decision a one-ulp difference could flip: x within rtol 1e-4.  Float32
BiCGStab on a Poisson system parts from another summation order after ten
to fifteen iterations (tests/test_torch_bicgstab.py), so the free-running
solves run on the convection–diffusion system, on which both packages
converge smoothly: ±1 iteration, x atol 1e-3.  The Gdia matrices are the
same systems renumbered inside each run of 128 rows (numpy seed 0)."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.core import reorder as ref_reorder
from ogl_tpu.kernels import gdia as ref_gdia
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.precond.jacobi import block_jacobi as ref_block_jacobi
from ogl_tpu.precond.jacobi import diagonal_of as ref_diagonal_of
from ogl_tpu.solve.bicgstab import bicgstab as ref_bicgstab
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.core import formats
from ogl_tpu_torch.kernels import gdia, spmv
from ogl_tpu_torch.kernels.block_jacobi import block_jacobi_plain
from ogl_tpu_torch.kernels.fused import (CgKernels, GdiaCgKernels, gen_check_sums,
                                         gen_phase_a_plain, gen_phase_b_plain, gen_update_plain)
from ogl_tpu_torch.precond.jacobi import block_inverses
from ogl_tpu_torch.kernels.xell import xell_from_coo
from ogl_tpu_torch.solve import bicgstab, stopping
from ogl_tpu_torch.solve.bicgstab import _safe_div, why_not
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)
# the module (the package's `bicgstab` attribute is the function)
bicgstab_module = importlib.import_module("ogl_tpu_torch.solve.bicgstab")

DIMS = (16, 16, 8)  # 2,048 rows: 16 runs of 128 for the Gdia renumbering
PROBLEMS = {"poisson": lambda: ref_testing.poisson_ldu(DIMS),
            "convection_diffusion": lambda: ref_testing.convection_diffusion_ldu(DIMS)}
FORMATS = ["Dia", "Gdia"]
PCS = ["none", "BJ"]
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)
FREE = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400)
# checked at 0 and at 6, 9, 12 (minIter 5, frequency 3): the count says
# whether the gating matches
GATED = StoppingConfig(tolerance=5e-4, rel_tol=0.0, min_iter=5, max_iter=12, frequency=3)
# tolerance 0: the loop runs maxIter iterations through the breakdown guards
GUARDED = StoppingConfig(tolerance=0.0, rel_tol=0.0, max_iter=6)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _shuffle(n, seed=0):
    """A permutation of the rows inside each run of 128 (as
    testing.shuffled_poisson_ldu renumbers its cells)."""
    runs = np.arange(n // 128)[:, None] * 128
    return (runs + np.random.default_rng(seed).permuted(
        np.tile(np.arange(128), (n // 128, 1)), axis=1)).ravel()


@functools.lru_cache(maxsize=None)
def _coo(problem, fmt):
    """The COO of PROBLEMS[problem], renumbered for Gdia."""
    m = PROBLEMS[problem]()
    coo = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
    return ref_reorder.permute_coo(coo, _shuffle(m.n)) if fmt == "Gdia" else coo


@functools.lru_cache(maxsize=None)
def _system(problem, fmt):
    """(reference matrix, port matrix, dense A, b = A·x_true, 1/diag) of
    PROBLEMS[problem] as Dia, or renumbered as Gdia."""
    coo = _coo(problem, fmt)
    if fmt == "Gdia":
        ref = ref_gdia.gdia_from_coo(coo)
        mat = gdia.gdia_from_coo(formats.Coo(rows=np.asarray(coo.rows),
                                             cols=np.asarray(coo.cols),
                                             vals=np.asarray(coo.vals), shape=coo.shape))
        assert len(mat.plane_offsets) < 16  # a Gdia matrix, not a wide Dia
    else:
        ref = ref_formats.coo_to_dia(coo)
        mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    a = np.asarray(ref_formats.to_dense(coo))
    x_true = np.random.default_rng(0).normal(size=coo.shape[0]).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    invd = (1.0 / ref_diagonal_of(coo)).astype(np.float32)
    return ref, mat, a, b, invd


def _plan(mat):
    if isinstance(mat, gdia.Gdia):
        return GdiaCgKernels(mat.shape[0], mat.plane_offsets, "cpu")
    return CgKernels(mat.shape[0], mat.offsets, "cpu")


def _port(mat, b, invd, cfg, x0=None, inv_t=None):
    """solve/bicgstab.py handed the plan of the loop kernel (on CPU tensors:
    the twin); inv_t: the block-Jacobi inverses in place of invd."""
    kern = _plan(mat)
    iv = None if invd is None else torch.tensor(invd)
    pc = None if iv is None else (lambda r: iv * r)
    if inv_t is not None:
        pc = functools.partial(block_jacobi_plain, inv_t)
    ops = single_device_ops(spmv.matvec(mat), mat.shape[0], precond=pc)
    bt = torch.tensor(b)
    x0 = torch.zeros_like(bt) if x0 is None else torch.tensor(x0)
    kernels.reset_launches()
    res = bicgstab(ops, bt, x0, cfg, kern, kern.pack_values(mat), iv, inv_t)
    assert sum(kernels.launches.values()) == 0  # CPU tensors run the twin
    return res


def _reference(ref, b, invd, cfg, x0=None, precond=None):
    ij = None if invd is None else jnp.asarray(invd)
    ops = ref_ops(ref_spmv.matvec(ref), ref.shape[0],
                  precond=precond if ij is None else (lambda r: ij * r))
    bj = jnp.asarray(b)
    return ref_bicgstab(ops, bj, jnp.zeros_like(bj) if x0 is None else jnp.asarray(x0), cfg)


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_pinned_twin_matches_reference(fmt, pc):
    ref, mat, _, b, invd = _system("poisson", fmt)
    invd = invd if pc == "BJ" else None
    ours = _port(mat, b, invd, PINNED)
    want = _reference(ref, b, invd, PINNED)
    assert ours.iters == int(want.iters) == 10
    assert not bool(ours.converged) and not bool(want.converged)
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(ours.x.numpy(), x_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(x_ref).max()))
    np.testing.assert_allclose(float(ours.init_res_norm), float(want.init_res_norm),
                               rtol=1e-4)


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_free_running_twin_matches_reference(fmt, pc):
    ref, mat, _, b, invd = _system("convection_diffusion", fmt)
    invd = invd if pc == "BJ" else None
    ours = _port(mat, b, invd, FREE)
    want = _reference(ref, b, invd, FREE)
    assert bool(ours.converged) and bool(want.converged)
    assert float(ours.final_res_norm) < FREE.tolerance
    assert abs(ours.iters - int(want.iters)) <= 1
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(want.x), atol=1e-3)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_gated_criterion_matches_reference(problem, fmt):
    ref, mat, _, b, _ = _system(problem, fmt)
    ours = _port(mat, b, None, GATED)
    want = _reference(ref, b, None, GATED)
    assert ours.iters == int(want.iters)
    assert ours.iters in (6, 9, 12) and bool(ours.converged) == bool(want.converged)
    np.testing.assert_allclose(float(ours.final_res_norm), float(want.final_res_norm),
                               rtol=1e-3)


@pytest.mark.parametrize("cfg", [FREE, GUARDED], ids=["tolerance", "tolerance0"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_breakdown_guard_keeps_x(fmt, cfg):
    """b = 0 and x0 = 0: r0 = 0, so p, v and every inner product stay 0 and
    the guards give α = ω = β = 0: x is unchanged and finite, and the count
    is the reference's (0 when the tolerance stops the first check, maxIter
    when it is 0)."""
    ref, mat, _, _, invd = _system("convection_diffusion", fmt)
    b = np.zeros(mat.shape[0], np.float32)
    x0 = np.zeros_like(b)
    ours = _port(mat, b, invd, cfg, x0)
    want = _reference(ref, b, invd, cfg, x0)
    assert ours.iters == int(want.iters) == (0 if cfg is FREE else cfg.max_iter)
    assert torch.equal(ours.x, torch.tensor(x0))
    assert np.array_equal(np.asarray(want.x), x0)
    assert float(ours.final_res_norm) == float(ours.init_res_norm) == 0.0


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_phase_twins_are_the_host_loops_expressions(fmt, pc):
    """Phases A and B and the update, on CPU tensors, give the bits of the
    recurrence's expressions (the same operations in the same order), and
    the plan's wrapper on CPU tensors (its own Ops over the plan's SpMV and
    invd ⊙ ·) gives solve/bicgstab.py's iterate, count and norms bit for
    bit."""
    _, mat, _, b, invd = _system("convection_diffusion", fmt)
    n = mat.shape[0]
    mv = spmv.matvec(mat)
    iv = torch.tensor(invd) if pc == "BJ" else None
    pre = (lambda w: w) if iv is None else (lambda w: iv * w)
    ops = single_device_ops(mv, n, precond=None if iv is None else pre)
    rng = np.random.default_rng(5)
    r, p, v, rhat, x = (torch.tensor(rng.normal(size=n).astype(np.float32)) for _ in range(5))
    beta, omega, alpha = (torch.tensor(np.float32(c)) for c in (0.37, -0.61, 0.23))
    pn, y, vn, d_rv = gen_phase_a_plain(ops, r, p, v, rhat, beta, omega)
    p_want = r + beta * (p - omega * v)
    v_want = mv(pre(p_want))
    assert torch.equal(pn, p_want) and torch.equal(y, pre(p_want)) and torch.equal(vn, v_want)
    assert torch.equal(d_rv, torch.sum(rhat * v_want))
    s, z, t, d_ts, d_tt = gen_phase_b_plain(ops, r, vn, alpha)
    s_want = r - alpha * v_want
    t_want = mv(pre(s_want))
    assert torch.equal(s, s_want) and torch.equal(z, pre(s_want)) and torch.equal(t, t_want)
    assert torch.equal(d_ts, torch.sum(t_want * s_want))
    assert torch.equal(d_tt, torch.sum(t_want * t_want))
    x2, r2 = x.clone(), r.clone()
    absr, rho = gen_update_plain(ops, x2, r2, y, z, s, t, rhat, alpha, omega)
    x_want = x + alpha * pre(p_want) + omega * pre(s_want)
    r_want = s_want - omega * t_want
    assert torch.equal(x2, x_want) and torch.equal(r2, r_want)
    assert torch.equal(absr, torch.sum(torch.abs(r_want)))
    assert torch.equal(rho, torch.sum(rhat * r_want))
    assert [float(u) for u in gen_check_sums(ops, r2, rhat)] == [float(absr), float(rho)]
    # the plan's wrapper on CPU tensors against solve/bicgstab.py, one set-up
    kern = _plan(mat)
    bt = torch.tensor(b)
    host = bicgstab(ops, bt, torch.zeros_like(bt), GATED)
    x0 = torch.zeros_like(bt)
    r0 = bt - mv(x0)
    nf = stopping.initial_norm_factor(ops, r0, x0, bt)
    rh = r0.clone()
    got = kern.bicgstab_gen_loop(kern.pack_values(mat), x0, r0, rh, torch.sum(rh * r0),
                                 torch.sum(torch.abs(r0)), nf, GATED, iv)
    assert got[0] == host.iters and torch.equal(x0, host.x)
    assert torch.equal(got[1], host.final_res_norm)
    assert torch.equal(got[2], host.init_res_norm) and torch.equal(got[3], host.converged)


@functools.lru_cache(maxsize=None)
def _block_jacobi(problem, fmt, bs):
    """(the reference's block-Jacobi apply, the port's inverses inv_t) of bs
    rows on the system's COO."""
    coo = _coo(problem, fmt)
    port = formats.Coo(rows=np.asarray(coo.rows), cols=np.asarray(coo.cols),
                       vals=np.asarray(coo.vals), shape=coo.shape)
    return ref_block_jacobi(coo, bs), torch.tensor(block_inverses(port, bs))


@pytest.mark.parametrize("bs", [3, 4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_block_jacobi_pinned_twin_matches_reference(fmt, bs):
    """GKOBiCGStab + BJ maxBlockSize bs (2,048 rows: bs 3 leaves a padded
    block): the loop plan handed inv_t runs the twin over block_jacobi_plain,
    against the reference's BiCGStab over its own block-Jacobi apply."""
    ref, mat, _, b, _ = _system("poisson", fmt)
    ref_pc, inv_t = _block_jacobi("poisson", fmt, bs)
    ours = _port(mat, b, None, PINNED, inv_t=inv_t)
    want = _reference(ref, b, None, PINNED, precond=ref_pc)
    assert ours.iters == int(want.iters) == 10
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(ours.x.numpy(), x_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(x_ref).max()))


@pytest.mark.parametrize("bs", [2, 4, 32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_block_jacobi_free_running_twin_matches_reference(fmt, bs):
    ref, mat, _, b, _ = _system("convection_diffusion", fmt)
    ref_pc, inv_t = _block_jacobi("convection_diffusion", fmt, bs)
    ours = _port(mat, b, None, FREE, inv_t=inv_t)
    want = _reference(ref, b, None, FREE, precond=ref_pc)
    assert bool(ours.converged) and bool(want.converged)
    assert abs(ours.iters - int(want.iters)) <= 1
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(want.x), atol=1e-3)


@pytest.mark.parametrize("bs", [2, 3, 32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_block_jacobi_plan_gives_the_host_loops_bits(fmt, bs):
    """The plan's wrapper with inv_t on CPU tensors (its own Ops over the
    plan's SpMV and block_jacobi_plain) gives solve/bicgstab.py's host loop
    over the same twins bit for bit: iterate, count and norms."""
    _, mat, _, b, _ = _system("convection_diffusion", fmt)
    _, inv_t = _block_jacobi("convection_diffusion", fmt, bs)
    mv = spmv.matvec(mat)
    ops = single_device_ops(mv, mat.shape[0], precond=functools.partial(block_jacobi_plain, inv_t))
    bt = torch.tensor(b)
    host = bicgstab(ops, bt, torch.zeros_like(bt), GATED)
    kern = _plan(mat)
    x0 = torch.zeros_like(bt)
    r0 = bt - mv(x0)
    nf = stopping.initial_norm_factor(ops, r0, x0, bt)
    rh = r0.clone()
    got = kern.bicgstab_gen_loop(kern.pack_values(mat), x0, r0, rh, torch.sum(rh * r0),
                                 torch.sum(torch.abs(r0)), nf, GATED, inv_t=inv_t)
    assert got[0] == host.iters and torch.equal(x0, host.x)
    assert torch.equal(got[1], host.final_res_norm)
    assert torch.equal(got[2], host.init_res_norm) and torch.equal(got[3], host.converged)


def test_plans_refuse_inconsistent_block_inverses():
    """inv_t excludes invd, and its shape must be (ceil(n / bs), bs, bs) for
    bs from 2 to 32, on every plan and every device."""
    _, mat, _, b, invd = _system("convection_diffusion", "Dia")
    _, inv_t = _block_jacobi("convection_diffusion", "Dia", 4)
    kern = _plan(mat)
    x, r = torch.zeros(mat.shape[0]), torch.tensor(b)
    one = torch.ones(())
    args = (kern.pack_values(mat), x, r, r.clone(), one, one, one, GATED)
    with pytest.raises(ValueError, match="exclude each other"):
        kern.bicgstab_gen_loop(*args, invd=torch.tensor(invd), inv_t=inv_t)
    with pytest.raises(ValueError, match="blocks of 4"):
        kern.bicgstab_gen_loop(*args, inv_t=inv_t[:-1].contiguous())
    with pytest.raises(ValueError, match="block size 33"):
        kern.bicgstab_gen_loop(*args, inv_t=torch.zeros((-(-mat.shape[0] // 33), 33, 33)))


def test_safe_div_guard():
    """sdiv of the loop kernel: n / d when |d| > small_of(float32)², else 0."""
    one = torch.tensor(1.0)
    assert float(_safe_div(one, torch.tensor(0.0))) == 0.0
    assert float(_safe_div(one, torch.tensor(1e-13))) == 0.0
    assert float(_safe_div(one, torch.tensor(-2.0))) == -0.5


# the convection–diffusion system (Dia) and the shuffled Poisson grid (Gdia:
# testing.renumber_ldu keeps only symmetric systems)
MESHES = {"Dia": lambda: testing.convection_diffusion_ldu(DIMS),
          "Gdia": lambda: testing.shuffled_poisson_ldu(DIMS)}


@pytest.mark.parametrize("pc", ["none", {"preconditioner": "BJ"},
                                {"preconditioner": "BJ", "maxBlockSize": 4}],
                         ids=[*PCS, "BJ4"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_foam_dispatch_runs_the_twin(mesh, pc, monkeypatch):
    """GKOBiCGStab through foam.solve on CPU tensors keeps the route name
    "bicgstab" and `fusedBiCGStab` false, keeps the format's plan for the
    loop kernel (why_not None: on the card one launch; a blocked BJ's
    inverses handed beside it) and here runs the twin once per solve, no
    launch counted."""
    m = MESHES[mesh]()
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOBiCGStab", "executor": "cpu", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, "preconditioner": pc}
    calls = []
    twin = bicgstab_module.bicgstab_gen_loop_plain
    monkeypatch.setattr(bicgstab_module, "bicgstab_gen_loop_plain",
                        lambda *a: calls.append(a) or twin(*a))
    slv = foam.FoamSolver("u", ctl)
    kernels.reset_launches()
    x, perf = slv.solve(m, b)
    assert sum(kernels.launches.values()) == 0 and len(calls) == 1
    assert slv.route == "bicgstab" and not slv.cfg.fused_bicgstab
    assert type(slv.matrix).__name__ == mesh
    assert type(slv.kern) is (GdiaCgKernels if mesh == "Gdia" else CgKernels)
    assert perf.converged and perf.final_residual < 1e-6
    a = testing.to_dense_ldu(m)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


def test_why_not_names_the_cases_that_keep_the_host_loop():
    """Multigrid and a format without a loop kernel keep the host loop:
    why_not names them (Dia, Gdia and Xell take the loop kernel), and
    foam.solve keeps no plan and still solves."""
    m = testing.poisson_ldu(DIMS)
    _, dia, _, _, _ = _system("poisson", "Dia")
    _, gd, _, _, _ = _system("poisson", "Gdia")
    assert why_not(dia, "none") is None and why_not(gd, "BJ") is None
    c = formats.Coo(rows=np.array([0, 1]), cols=np.array([0, 1]),
                    vals=np.ones(2, np.float32), shape=(2, 2))
    assert why_not(xell_from_coo(c), "none") is None
    assert "Coo" in why_not(c, "none")
    assert "Multigrid" in why_not(dia, "Multigrid")
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    slv = foam.FoamSolver("u", {"solver": "GKOBiCGStab", "executor": "cpu", "tolerance": 1e-6,
                                "relTol": 0, "preconditioner": "Multigrid"})
    _, perf = slv.solve(m, b)
    assert slv.route == "bicgstab" and slv.kern is None
    assert perf.converged
