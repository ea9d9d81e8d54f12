"""GKOBiCGStab of the port against the reference on the CPU: the K1B and
KB_update plain twins against the reference's Pallas `CgKernels.k1b`/
`kb_update` in interpret mode, the general and merged BiCGStab against
`ogl_tpu.solve.bicgstab`/`bicgstab_fused`, and GKOBiCGStab through
`foam.solve` on Dia, Gdia and Xell, symmetric and asymmetric, with
`none`, `BJ`, `Multigrid` and `fusedBiCGStab true`, and its steady state.

Tolerances: kernel vectors rtol 1e-5 of the output's max, sums rtol 1e-4
(summed in another order).  Solves: ±1 iteration, x atol 1e-3; pinned
iterations (tolerance 0, minIter = maxIter) x rtol 1e-4; Multigrid ±1 with
`precision float32`, +2 with bfloat16 smoother packing.

BiCGStab's float32 residual history on a Poisson system is erratic: the
two packages' trajectories agree to float32 rounding for the first ten to
fifteen iterations and then part, so where the residual crosses the
tolerance late and unevenly the two may stop several iterations apart
(the reference's own merged and general solvers do too).  The free-running
cases therefore use systems on which both converge smoothly — the
convection–diffusion matrices, and Poisson systems and tolerances checked
to cross it cleanly — and the pinned cases hold the trajectories."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.precond.jacobi import diagonal_of as ref_diagonal_of
from ogl_tpu.solve.bicgstab import bicgstab as ref_bicgstab
from ogl_tpu.solve.bicgstab_fused import bicgstab_fused as ref_bicgstab_fused
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.foam import FoamSolver
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.fused import CgKernels, k1b_plain, kb_update_plain
from ogl_tpu_torch.solve import bicgstab, bicgstab_fused
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

TILE = 16
FREE = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400)
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)
PROBLEMS = {"poisson": lambda: ref_testing.poisson_ldu((128, 8)),
            "convection_diffusion": lambda: ref_testing.convection_diffusion_ldu((16, 12))}


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _setup(m):
    coo = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
    ref = ref_formats.coo_to_dia(coo)
    a = ref_testing.to_dense_ldu(m)
    x_true = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    invd = (1.0 / ref_diagonal_of(coo)).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, mat, b, invd, x_true


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _scalar(v):
    return torch.tensor(np.float32(v))


# ---- K1B and KB_update: plain twins against the Pallas kernels -----------


@pytest.mark.parametrize("b_is_c", [False, True], ids=["b,c", "b is c"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_k1b_plain_matches_reference(problem, b_is_c):
    ref, mat, _, _, _ = _setup(PROBLEMS[problem]())
    rkern, data3 = make_cg_kernels(ref, tile=TILE, interpret=True)
    n = ref.shape[0]
    rng = np.random.default_rng(3)
    vec = {k: rng.normal(size=n).astype(np.float32) for k in ("a", "b", "c", "rhat")}
    if b_is_c:
        vec["c"] = vec["b"]
    ca, cb = 0.43, -0.29
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    w_f, q_f, *sums = rkern.k1b(data3, fr["a"], fr["b"], fr["c"], fr["rhat"], ca, cb)
    t = {k: torch.tensor(v) for k, v in vec.items()}
    if b_is_c:
        t["c"] = t["b"]  # one tensor, as the second K1B of an iteration passes v twice
    w, q, *sums2 = k1b_plain(mat.data, mat.offsets, t["a"], t["b"], t["c"], t["rhat"],
                             _scalar(ca), _scalar(cb))
    _close(w.numpy(), interop.unframe_reference(w_f, n, rkern.tile), 1e-5)
    _close(q.numpy(), interop.unframe_reference(q_f, n, rkern.tile), 1e-5)
    for got, want in zip(sums2, sums):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_kb_update_plain_matches_reference(problem):
    ref, _, _, _, _ = _setup(PROBLEMS[problem]())
    rkern, _ = make_cg_kernels(ref, tile=TILE, interpret=True)
    n = ref.shape[0]
    rng = np.random.default_rng(4)
    vec = {k: rng.normal(size=n).astype(np.float32) for k in ("x", "p", "s", "t", "rhat")}
    alpha, omega = 0.37, -0.61
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    xo, ro, d_rr, absr = rkern.kb_update(fr["x"], fr["p"], fr["s"], fr["t"], fr["rhat"],
                                         alpha, omega)
    t = {k: torch.tensor(v) for k, v in vec.items()}
    r = torch.empty(n)
    d2, a2 = kb_update_plain(t["x"], t["p"], t["s"], t["t"], t["rhat"], _scalar(alpha),
                             _scalar(omega), r)
    _close(t["x"].numpy(), interop.unframe_reference(xo, n, rkern.tile), 1e-5)
    _close(r.numpy(), interop.unframe_reference(ro, n, rkern.tile), 1e-5)
    np.testing.assert_allclose(float(d2), float(d_rr), rtol=1e-4)
    np.testing.assert_allclose(float(a2), float(absr), rtol=1e-4)


def test_k1b_and_kb_update_wrappers_dispatch_cpu_tensors_to_plain():
    _, mat, _, _, _ = _setup(PROBLEMS["convection_diffusion"]())
    n = mat.shape[0]
    kern = CgKernels(n, mat.offsets, "cpu")
    data = kern.pack_values(mat)
    rng = np.random.default_rng(5)
    a, b, rhat = (torch.tensor(rng.normal(size=n).astype(np.float32)) for _ in range(3))
    ca, cb = _scalar(0.3), _scalar(-0.2)
    kernels.reset_launches()
    want = k1b_plain(data, mat.offsets, a, b, b, rhat, ca, cb)
    for g, w in zip(kern.k1b(data, a, b, b, rhat, ca, cb), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    out = (torch.empty(n), torch.empty(n))
    got = kern.k1b(data, a, b, b, rhat, ca, cb, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="overlaps"):
        kern.k1b(data, a, b, b, rhat, ca, cb, out=(b, torch.empty(n)))
    with pytest.raises(ValueError, match="overlaps"):
        kern.k1b(data, a, b, b, rhat, ca, cb, out=(out[0], out[0][1:]))
    x1, x2 = a.clone(), a.clone()
    r1, r2 = torch.empty(n), torch.empty(n)
    s1 = kern.kb_update(x1, b, rhat, b, rhat, ca, cb, r1)
    s2 = kb_update_plain(x2, b, rhat, b, rhat, ca, cb, r2)
    for g, w in zip((x1, r1, *s1), (x2, r2, *s2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sum(kernels.launches.values()) == 0


# ---- the solvers against the reference's -------------------------------


def _port_bicgstab(mat, b, invd, cfg, jacobi, fused):
    bt = torch.tensor(b)
    if fused:
        kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
        return bicgstab_fused(kern, kern.pack_values(mat), bt, torch.zeros_like(bt), cfg)
    iv = torch.tensor(invd)
    ops = single_device_ops(spmv.matvec(mat), mat.shape[0],
                            precond=(lambda r: iv * r) if jacobi else None)
    return bicgstab(ops, bt, torch.zeros_like(bt), cfg)


def _ref_bicgstab(ref, b, invd, cfg, jacobi, fused):
    bj = jnp.asarray(b)
    if fused:
        kern, data3 = make_cg_kernels(ref, tile=TILE, interpret=True)
        return ref_bicgstab_fused(kern, data3, bj, jnp.zeros_like(bj), cfg)
    ij = jnp.asarray(invd)
    ops = ref_ops(ref_spmv.matvec(ref), ref.shape[0],
                  precond=(lambda r: ij * r) if jacobi else None)
    return ref_bicgstab(ops, bj, jnp.zeros_like(bj), cfg)


ROUTES = [(False, False), (True, False), (False, True)]  # (jacobi, fused)
ROUTE_IDS = ["none", "BJ", "merged"]


@pytest.mark.parametrize("jacobi,fused", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_pinned_trajectory_matches_reference(problem, jacobi, fused):
    ref, mat, b, invd, _ = _setup(PROBLEMS[problem]())
    ours = _port_bicgstab(mat, b, invd, PINNED, jacobi, fused)
    want = _ref_bicgstab(ref, b, invd, PINNED, jacobi, fused)
    assert ours.iters == int(want.iters) == 10
    _close(ours.x.numpy(), want.x, 1e-4)


@pytest.mark.parametrize("jacobi,fused", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_free_running_matches_reference(problem, jacobi, fused):
    ref, mat, b, invd, x_true = _setup(PROBLEMS[problem]())
    ours = _port_bicgstab(mat, b, invd, FREE, jacobi, fused)
    want = _ref_bicgstab(ref, b, invd, FREE, jacobi, fused)
    assert bool(ours.converged) and bool(want.converged)
    assert abs(ours.iters - int(want.iters)) <= 1
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(want.x), atol=1e-3)
    np.testing.assert_allclose(ours.x.numpy(), x_true, atol=5e-2)


# ---- GKOBiCGStab through foam.solve ---------------------------------------


def _knn(n):
    m, perm = testing.knn_ldu(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return testing.renumber_ldu(m, inv)


def _ref_ldu(m):
    return ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                             diag=m.diag, upper=m.upper, lower=m.lower)


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


MESHES = {"Dia": lambda: testing.poisson_ldu((128, 8)),
          "Dia-asymmetric": lambda: testing.convection_diffusion_ldu((16, 16, 8)),
          "Gdia": lambda: testing.shuffled_poisson_ldu((128, 8)),
          "Xell": lambda: _knn(4096)}
PCS = {"none": "none", "BJ": {"preconditioner": "BJ"}}


def _controls(pc, **extra):
    return {"solver": "GKOBiCGStab", "executor": "cpu", "tolerance": 1e-6, "relTol": 0,
            "adaptMinIter": False, "preconditioner": pc, **extra}


@pytest.mark.parametrize("pc", list(PCS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_foam_bicgstab_matches_reference(mesh, pc):
    """The general BiCGStab over each format's SpMV (the reference runs the
    same loop on the CPU); the solver keeps the plan of the loop kernel,
    whose CPU twin is that loop."""
    fmt = mesh.split("-")[0]
    m = MESHES[mesh]()
    b = _rhs(m.n)
    ctl = _controls(PCS[pc], matrixFormat=fmt)
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions only
    assert slv.route == "bicgstab"
    # every format keeps a plan for the loop kernel (on the CPU: its twin)
    assert type(slv.kern).__name__ == {"Dia": "CgKernels", "Gdia": "GdiaCgKernels",
                                       "Xell": "XellCgKernels"}[fmt]
    assert perf.solver_name == perf_ref.solver_name == f"GKOBiCGStab_{fmt}"
    assert perf.converged and perf_ref.converged and perf.final_residual < 1e-6
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)
    a = testing.to_dense_ldu(m)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


@pytest.mark.parametrize("dims", [(16, 12), (16, 16, 8)], ids=str)
def test_foam_fused_bicgstab_matches_reference(dims):
    """fusedBiCGStab true with `none` on Dia: the merged BiCGStab (K1B, K1B,
    KB_update) against the reference's general loop on the CPU (its merged
    route is TPU-only), and the reference's merged loop in interpret mode."""
    m = testing.convection_diffusion_ldu(dims)
    b = _rhs(m.n)
    ctl = _controls("none", fusedBiCGStab=True)
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.route == "bicgstab_fused" and perf.solver_name == "GKOBiCGStab_Dia"
    assert perf.converged and perf.final_residual < 1e-6
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)
    ref = ref_formats.coo_to_dia(ref_ldu.ldu_to_coo_host(_ref_ldu(m), dtype=np.float32))
    cfg = StoppingConfig(tolerance=1e-6, rel_tol=0.0, max_iter=2000)
    merged = _ref_bicgstab(ref, b, None, cfg, jacobi=False, fused=True)
    assert abs(perf.n_iterations - int(merged.iters)) <= 1
    # BJ falls back to the general loop, as in the reference
    _, perf_bj = foam.solve("q", m, b, _controls({"preconditioner": "BJ"},
                                                 fusedBiCGStab=True))
    assert registry.global_registry.get("q_solver").route == "bicgstab"
    assert perf_bj.converged


@pytest.mark.parametrize("precision", ["float32", None], ids=["float32", "bfloat16"])
def test_foam_bicgstab_multigrid_matches_reference(precision):
    m = testing.poisson_ldu((16, 16, 8))
    b = _rhs(m.n)
    ctl = _controls("Multigrid", matrixFormat="Dia")
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    pc = {"preconditioner": "Multigrid"}
    if precision is not None:
        pc["precision"] = precision
    x, perf = foam.solve("p", m, b, {**ctl, "preconditioner": pc})
    assert registry.global_registry.get("p_solver").route == "bicgstab"
    assert perf.converged and perf.final_residual < 1e-6
    if precision is not None:
        assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
    else:
        assert perf.n_iterations <= perf_ref.n_iterations + 2
    a = testing.to_dense_ldu(m)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


def test_asymmetric_steady_state_uploads_the_changed_blocks():
    """The asymmetric LDU system has three blocks (upper, lower, diag): the
    first solve uploads all three, a diag-only step one, a step that changes
    all of them three; the answers track the reference and the current
    operator."""
    m = testing.convection_diffusion_ldu((16, 16, 8))
    b = _rhs(m.n)
    ctl = _controls({"preconditioner": "BJ"}, matrixFormat="Dia")
    steps = [(m, b, (3, 3))]
    m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
    steps.append((m2, b * 1.01 + 0.1, (1, 3)))
    m3 = dataclasses.replace(m2, diag=np.asarray(m2.diag) * 1.02,
                             upper=np.asarray(m2.upper) * 0.98,
                             lower=np.asarray(m2.lower) * 0.97)
    steps.append((m3, b * 0.9 - 0.1, (3, 3)))
    for step, (mk, bk, want) in enumerate(steps):
        bk = bk.astype(np.float32)
        x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(mk), bk, ctl)
        x, perf = foam.solve("p", mk, bk, ctl)
        slv = registry.global_registry.get("p_solver")
        assert slv.last_blocks_uploaded == want
        if step > 0:  # the reference counts uploads from its first steady step on
            assert ref_registry.global_registry.get("p_solver").last_blocks_uploaded == want
        assert slv.last_rhs_uploaded
        assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)
        a = testing.to_dense_ldu(mk)
        assert np.abs(bk - a @ x.numpy().astype(np.float64)).sum() / np.abs(bk).sum() < 1e-5


def test_max_iter_is_doubled():
    """The reference doubles maxIter for GKOBiCGStab (two SpMVs per
    iteration): maxIter 7 with tolerance 0 runs 14 iterations."""
    assert FoamSolver("p", {"solver": "GKOBiCGStab", "executor": "cpu",
                            "maxIter": 30}).cfg.stopping.max_iter == 60
    m = testing.convection_diffusion_ldu((16, 12))
    b = _rhs(m.n)
    ctl = _controls("none", matrixFormat="Dia", tolerance=0.0, maxIter=7)
    _, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    for fused in (False, True):
        registry.global_registry.clear()
        _, perf = foam.solve("p", m, b, {**ctl, "fusedBiCGStab": fused})
        assert perf.n_iterations == perf_ref.n_iterations == 14
        assert not perf.converged and not perf_ref.converged


def test_gkobicgstab_class_takes_asymmetric_matrices():
    """GKOBiCGStab registers for both tables; GKOCG still refuses an
    asymmetric matrix.  The class equals the functional entry."""
    m = testing.convection_diffusion_ldu((16, 12))
    b = _rhs(m.n)
    ctl = _controls({"preconditioner": "BJ"})
    x1, perf1 = foam.solve("p", m, b, ctl)
    registry.global_registry.clear()
    x2, perf2 = foam.GKOBiCGStab("p", ctl).solve(m, b)
    assert perf1 == perf2 and perf2.solver_name == "GKOBiCGStab_Dia"
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="symmetric"):
        foam.GKOCG("q", {**ctl, "solver": "GKOCG"}).solve(m, b)
