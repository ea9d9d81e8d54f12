"""The pipelined (Chronopoulos–Gear) CG of the port against the reference
on the CPU: the KA and KB_pipe plain twins against the reference's Pallas
`CgKernels.ka`/`kb_pipe` in interpret mode, the general and merged
pipelined solvers against `ogl_tpu.solve.cg_pipe`/`cg_pipe_fused`, and
GKOCG `pipelinedCG true` through `foam.solve` on Dia, Gdia and Xell with
`none`, `BJ` and `Multigrid`.

Tolerances: kernel vectors rtol 1e-5 of the output's max, sums rtol 1e-4
(summed in another order).  Solves: ±1 iteration (a stop decision can
flip on one ulp), x atol 1e-3; pinned iterations (tolerance 0, minIter =
maxIter) hold the trajectories with no stop decision, x rtol 1e-4.  With
Multigrid: ±1 with `precision float32`, +2 with the default bfloat16
smoother packing, as tests/test_torch_amg.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.precond.jacobi import diagonal_of as ref_diagonal_of
from ogl_tpu.solve.cg_pipe import cg_pipelined as ref_cg_pipelined
from ogl_tpu.solve.cg_pipe_fused import cg_pipelined_fused as ref_cg_pipelined_fused
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.fused import CgKernels, ka_plain, kb_pipe_plain
from ogl_tpu_torch.solve import cg_fused, cg_pipelined, cg_pipelined_fused
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

TILE = 16
FREE = StoppingConfig(tolerance=5e-5, rel_tol=0.0, max_iter=400)
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=30, max_iter=30)
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


# ---- KA and KB_pipe: plain twins against the Pallas kernels --------------


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_ka_plain_matches_reference(problem, jacobi):
    ref, mat, _, invd, _ = _setup(PROBLEMS[problem]())
    rkern, data3 = make_cg_kernels(ref, tile=TILE, interpret=True)
    n = ref.shape[0]
    r = np.random.default_rng(3).normal(size=n).astype(np.float32)
    wf, gamma, delta, absr = rkern.ka(data3, rkern.frame(r),
                                      rkern.frame(invd) if jacobi else None)
    w, g2, d2, a2 = ka_plain(mat.data, mat.offsets, torch.tensor(r),
                             torch.tensor(invd) if jacobi else None)
    _close(w.numpy(), interop.unframe_reference(wf, n, rkern.tile), 1e-5)
    for got, want in ((g2, gamma), (d2, delta), (a2, absr)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_kb_pipe_plain_matches_reference(problem, jacobi):
    ref, mat, _, invd, _ = _setup(PROBLEMS[problem]())
    rkern, _ = make_cg_kernels(ref, tile=TILE, interpret=True)
    n = ref.shape[0]
    rng = np.random.default_rng(4)
    vec = {k: rng.normal(size=n).astype(np.float32) for k in ("w", "p", "s", "x", "r")}
    alpha, beta = 0.31, -0.47
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    want = rkern.kb_pipe(fr["w"], fr["p"], fr["s"], fr["x"], fr["r"], alpha, beta,
                         rkern.frame(invd) if jacobi else None)
    got = {k: torch.tensor(v) for k, v in vec.items()}
    kb_pipe_plain(got["w"], got["p"], got["s"], got["x"], got["r"],
                  torch.tensor(np.float32(alpha)), torch.tensor(np.float32(beta)),
                  torch.tensor(invd) if jacobi else None)
    for k, wf in zip(("p", "s", "x", "r"), want):
        _close(got[k].numpy(), interop.unframe_reference(wf, n, rkern.tile), 1e-5)


def test_ka_and_kb_pipe_wrappers_dispatch_cpu_tensors_to_plain():
    _, mat, _, invd, _ = _setup(PROBLEMS["poisson"]())
    n = mat.shape[0]
    kern = CgKernels(n, mat.offsets, "cpu")
    data = kern.pack_values(mat)
    rng = np.random.default_rng(5)
    r = torch.tensor(rng.normal(size=n).astype(np.float32))
    kernels.reset_launches()
    for iv in (None, torch.tensor(invd)):
        for g, w in zip(kern.ka(data, r, iv), ka_plain(data, mat.offsets, r, iv)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        a = [torch.tensor(rng.normal(size=n).astype(np.float32)) for _ in range(5)]
        b = [t.clone() for t in a]
        alpha, beta = torch.tensor(0.2), torch.tensor(0.6)
        assert kern.kb_pipe(*a, alpha, beta, iv) is None
        kb_pipe_plain(*b, alpha, beta, iv)
        for g, w in zip(a, b):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sum(kernels.launches.values()) == 0


# ---- the solvers against the reference's -------------------------------


def _port_pipe(mat, b, invd, cfg, jacobi, fused):
    bt = torch.tensor(b)
    iv = torch.tensor(invd) if jacobi else None
    if fused:
        kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
        return cg_pipelined_fused(kern, kern.pack_values(mat), bt, torch.zeros_like(bt), cfg,
                                  invd=iv)
    ops = single_device_ops(spmv.matvec(mat), mat.shape[0],
                            precond=(lambda r: iv * r) if jacobi else None)
    return cg_pipelined(ops, bt, torch.zeros_like(bt), cfg)


def _ref_pipe(ref, b, invd, cfg, jacobi, fused):
    bj = jnp.asarray(b)
    ij = jnp.asarray(invd) if jacobi else None
    if fused:
        kern, data3 = make_cg_kernels(ref, tile=TILE, interpret=True)
        return ref_cg_pipelined_fused(kern, data3, bj, jnp.zeros_like(bj), cfg, invd=ij)
    ops = ref_ops(ref_spmv.matvec(ref), ref.shape[0],
                  precond=(lambda r: ij * r) if jacobi else None)
    return ref_cg_pipelined(ops, bj, jnp.zeros_like(bj), cfg)


@pytest.mark.parametrize("fused", [False, True], ids=["general", "merged"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
def test_pinned_trajectory_matches_reference(jacobi, fused):
    ref, mat, b, invd, _ = _setup(PROBLEMS["poisson"]())
    ours = _port_pipe(mat, b, invd, PINNED, jacobi, fused)
    want = _ref_pipe(ref, b, invd, PINNED, jacobi, fused)
    assert ours.iters == int(want.iters) == 30
    _close(ours.x.numpy(), want.x, 1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["general", "merged"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("dims", [(128, 8), (96, 11)])
def test_free_running_matches_reference(dims, jacobi, fused):
    ref, mat, b, invd, x_true = _setup(ref_testing.poisson_ldu(dims))
    ours = _port_pipe(mat, b, invd, FREE, jacobi, fused)
    want = _ref_pipe(ref, b, invd, FREE, jacobi, fused)
    assert bool(ours.converged) and bool(want.converged)
    assert abs(ours.iters - int(want.iters)) <= 1
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(want.x), atol=1e-3)
    np.testing.assert_allclose(ours.x.numpy(), x_true, atol=5e-2)


def test_pipelined_tracks_classical_cg():
    """The reference pins pipelined within ±2 iterations of classical CG
    (tests/test_cg_fused.py); the port's merged forms agree as well."""
    _, mat, b, invd, _ = _setup(PROBLEMS["poisson"]())
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    bt = torch.tensor(b)
    classical = cg_fused(kern, kern.pack_values(mat), bt, torch.zeros_like(bt), FREE)
    pipelined = _port_pipe(mat, b, invd, FREE, jacobi=False, fused=True)
    assert abs(pipelined.iters - classical.iters) <= 2
    np.testing.assert_allclose(pipelined.x.numpy(), classical.x.numpy(), atol=1e-3)


# ---- GKOCG pipelinedCG through foam.solve --------------------------------


def _knn(n):
    m, perm = testing.knn_ldu(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return testing.renumber_ldu(m, inv)


def _ref_ldu(m):
    return ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                             diag=m.diag, upper=m.upper, lower=m.lower)


MESHES = {"Dia": lambda: testing.poisson_ldu((16, 16, 8)),
          "Gdia": lambda: testing.shuffled_poisson_ldu((32, 16, 8)),
          "Xell": lambda: _knn(4096)}
PCS = {"none": "none", "BJ": {"preconditioner": "BJ"}}


def _controls(pc, **extra):
    return {"solver": "GKOCG", "pipelinedCG": True, "executor": "cpu", "tolerance": 1e-6,
            "relTol": 0, "adaptMinIter": False, "preconditioner": pc, **extra}


@pytest.mark.parametrize("pc", list(PCS))
@pytest.mark.parametrize("fmt", list(MESHES))
def test_foam_pipelined_matches_reference(fmt, pc):
    """Dia takes the merged pipelined CG (KA + KB_pipe), Gdia and Xell the
    general pipelined loop over their SpMV kernels; the reference runs its
    general pipelined CG on the CPU."""
    m = MESHES[fmt]()
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = _controls(PCS[pc], matrixFormat=fmt)
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions only
    assert slv.route == ("cg_pipe_fused" if fmt == "Dia" else "cg_pipe")
    assert (slv.kern is None) == (fmt != "Dia")  # the plan only where a merged route runs
    assert perf.solver_name == perf_ref.solver_name == f"GKOCG_{fmt}"
    assert perf.converged and perf_ref.converged and perf.final_residual < 1e-6
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)


@pytest.mark.parametrize("precision", ["float32", None], ids=["float32", "bfloat16"])
def test_foam_pipelined_multigrid_matches_reference(precision):
    """Multigrid takes the general pipelined loop with the AMG cycle."""
    m = testing.poisson_ldu((32, 16, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = _controls("Multigrid", matrixFormat="Dia")
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    pc = {"preconditioner": "Multigrid"}
    if precision is not None:
        pc["precision"] = precision
    x, perf = foam.solve("p", m, b, {**ctl, "preconditioner": pc})
    assert registry.global_registry.get("p_solver").route == "cg_pipe"
    assert perf.converged and perf.final_residual < 1e-6
    if precision is not None:
        assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
    else:
        assert perf.n_iterations <= perf_ref.n_iterations + 2


def test_foam_pipelined_general_route_and_steady_step():
    """fusedCG false takes the general pipelined loop on Dia too; a diag-only
    step uploads one block of two and tracks the new operator."""
    m = testing.poisson_ldu((16, 16, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    x1, perf1 = foam.solve("p", m, b, _controls("none", matrixFormat="Dia"))
    x2, perf2 = foam.solve("q", m, b, _controls("none", fusedCG=False))
    assert registry.global_registry.get("q_solver").route == "cg_pipe"
    assert abs(perf1.n_iterations - perf2.n_iterations) <= 1
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-4)
    m2 = testing.poisson_ldu((16, 16, 8))
    m2 = type(m2)(**{**vars(m2), "diag": np.asarray(m2.diag) * 1.01})
    b2 = b * 1.01 + 0.1
    x3, perf3 = foam.solve("p", m2, b2, _controls("none", matrixFormat="Dia"))
    assert registry.global_registry.get("p_solver").last_blocks_uploaded == (1, 2)
    a = testing.to_dense_ldu(m2)
    assert perf3.converged
    assert np.abs(b2 - a @ x3.numpy().astype(np.float64)).sum() / np.abs(b2).sum() < 1e-5
