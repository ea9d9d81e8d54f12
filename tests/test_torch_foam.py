"""The slice as a whole: `foam.solve("p", m, b, controls)` of the port
against the reference on the same LDU system and right-hand sides.

The reference solves with its general CG on the CPU; the port takes its
merged-kernel route (plain kernels on the CPU).  Iteration counts may
differ by one (stop decisions on float32 sums in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.foam import solver as solver_mod
from ogl_tpu_torch.kernels import gdia, xell

torch.set_num_threads(2)

DIMS = (16, 16, 8)
PRECONDITIONERS = {"none": "none", "BJ": {"preconditioner": "BJ"}}


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _controls(pc, **extra):
    return {"solver": "GKOCG", "executor": "cpu", "matrixFormat": "Dia",
            "tolerance": 1e-6, "relTol": 0, "preconditioner": PRECONDITIONERS[pc],
            **extra}


def _port(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper)


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("pc", list(PRECONDITIONERS))
def test_first_solve_matches_reference(pc):
    m = ref_testing.poisson_ldu(DIMS)
    b = _rhs(m.n)
    x_ref, perf_ref = ref_foam.solve("p", m, b, _controls(pc))
    x, perf = foam.solve("p", _port(m), b, _controls(pc))
    assert perf.solver_name == perf_ref.solver_name == "GKOCG_Dia"
    assert perf.field_name == "p"
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(perf.initial_residual, perf_ref.initial_residual, rtol=1e-5)
    assert perf.converged and perf_ref.converged
    assert perf.final_residual < 1e-6 and perf_ref.final_residual < 1e-6
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.shape == (m.n,)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)
    # the solution solves the system (float64 check on the host)
    a = ref_testing.poisson_dense(DIMS)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


@pytest.mark.parametrize("pc", list(PRECONDITIONERS))
def test_steady_state_steps_match_reference(pc):
    """Two more steps, each scaling diag by 1.01 and changing b: only the
    diag block and the RHS cross to the device, and both packages track
    the new operator.  adaptMinIter is off so that the check frequency —
    derived from measured timings when it is on — cannot differ between
    the packages; the counts are the reference's 43, 39, 36 ± 1."""
    m = ref_testing.poisson_ldu(DIMS)
    b = _rhs(m.n)
    ctl = _controls(pc, adaptMinIter=False)
    for step, want in enumerate((43, 39, 36)):
        x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
        x, perf = foam.solve("p", _port(m), b, ctl)
        slv_ref = ref_registry.global_registry.get("p_solver")
        slv = registry.global_registry.get("p_solver")
        assert abs(perf_ref.n_iterations - want) <= 1
        assert abs(perf.n_iterations - want) <= 1
        assert perf.converged and perf.final_residual < 1e-6
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-3)
        a = ref_testing.to_dense_ldu(m)  # the CURRENT operator
        assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5
        if step > 0:
            assert slv.last_blocks_uploaded == slv_ref.last_blocks_uploaded == (1, 2)
            assert slv.last_rhs_uploaded and slv_ref.last_rhs_uploaded
        else:
            assert slv.last_blocks_uploaded == (2, 2)  # blocks left resident
        m = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
        b = b * 1.01 + 0.1


def test_unchanged_step_uploads_nothing():
    m = _port(ref_testing.poisson_ldu(DIMS))
    b = _rhs(m.n)
    ctl = _controls("BJ")
    foam.solve("p", m, b, ctl)
    _, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.last_blocks_uploaded == (0, 2) and not slv.last_rhs_uploaded
    assert perf.converged


def test_gkocg_class_equals_functional_entry():
    m = _port(ref_testing.poisson_ldu(DIMS))
    b = _rhs(m.n)
    x1, perf1 = foam.solve("p", m, b, _controls("BJ"))
    # the field's cross-solve properties (adaptMinIter state) live in the
    # registry: start the class from the same fresh state
    registry.global_registry.clear()
    x2, perf2 = foam.GKOCG("p", _controls("BJ")).solve(m, b)
    assert perf1 == perf2
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    asym = interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper,
                                   lower=m.upper)
    with pytest.raises(ValueError, match="symmetric"):
        foam.GKOCG("p", _controls("none")).solve(asym, b)


def test_general_route_and_auto_format():
    """fusedCG false takes the general CG; without matrixFormat the Dia
    test of the reference's auto-routing picks Dia.  Same answer."""
    m = _port(ref_testing.poisson_ldu(DIMS))
    b = _rhs(m.n)
    x1, perf1 = foam.solve("p", m, b, _controls("none"))
    ctl = {k: v for k, v in _controls("none", fusedCG=False).items() if k != "matrixFormat"}
    kernels.reset_launches()
    x2, perf2 = foam.FoamSolver("q", ctl).solve(m, b)
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions only
    assert perf2.solver_name == "GKOCG_Dia"
    assert abs(perf1.n_iterations - perf2.n_iterations) <= 1
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-4)


def test_verbose_prints_statistics(capsys):
    m = _port(ref_testing.poisson_ldu(DIMS))
    _, perf = foam.solve("p", m, _rhs(m.n), _controls("none", verbose=1))
    perf.print()
    out = capsys.readouterr().out
    for text in ("Statistics:", "Time per iteration:", "Time per iteration and DOF:",
                 "Retrieve results bandwidth", "[OGL LOG] p: solve:",
                 "GKOCG_Dia:  Solving for p, Initial residual = 1"):
        assert text in out


# ---- the unstructured path: Gdia and Xell --------------------------------
# Meshes: a Poisson grid renumbered inside each 128-cell run (more than 64
# diagonals: Gdia) and the RCM'd kNN graph of the reference's bench (Xell
# from 32,768 cells).  The reference solves with its general CG on the CPU
# (its merged kernels are TPU-only), the port with the merged CG over the
# plain Gdia/Xell twins: ±1 iteration, x within 1e-3.


def _ref_ldu(m):
    return ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                             diag=m.diag, upper=m.upper)


def _knn(n, rcm=True):
    m, perm = testing.knn_ldu(n)
    if not rcm:
        return m, perm
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return testing.renumber_ldu(m, inv), perm


def _unstructured(kind):
    if kind == "Gdia":
        return testing.shuffled_poisson_ldu((32, 16, 8))
    return _knn(4096)[0]


def _solve_both(m, ctl):
    b = _rhs(m.n)
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, ctl)
    x, perf = foam.solve("p", m, b, ctl)
    return b, x, perf, np.asarray(x_ref), perf_ref


def _residual(m, x, b):
    a = testing.to_dense_ldu(m) if m.n <= 8192 else None
    if a is not None:
        return np.abs(b - a @ x.astype(np.float64)).sum() / np.abs(b).sum()
    coo = ldu.ldu_to_coo_host(m)
    ax = np.zeros(m.n)
    np.add.at(ax, coo.rows, coo.vals * x[coo.cols].astype(np.float64))
    return np.abs(b - ax).sum() / np.abs(b).sum()


@pytest.mark.parametrize("pc", list(PRECONDITIONERS))
@pytest.mark.parametrize("fmt", ["Gdia", "Xell"])
def test_explicit_unstructured_format_matches_reference(fmt, pc):
    m = _unstructured(fmt)
    ctl = {**_controls(pc), "matrixFormat": fmt}
    b, x, perf, x_ref, perf_ref = _solve_both(m, ctl)
    assert perf.solver_name == perf_ref.solver_name == f"GKOCG_{fmt}"
    assert isinstance(registry.global_registry.get("p_solver").matrix,
                      {"Gdia": gdia.Gdia, "Xell": xell.Xell}[fmt])
    assert perf.converged and perf_ref.converged
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-3)
    assert _residual(m, x.numpy(), b) < 1e-5


@pytest.mark.parametrize("kind", ["shuffled_poisson", "knn"])
def test_auto_routing_matches_reference(kind):
    """Without matrixFormat the port takes the reference's format ladder:
    the shuffled grid → Gdia, the kNN graph at 32,768 cells → Xell."""
    if kind == "knn":
        m, want = _knn(1 << 15)[0], "Xell"
    else:
        m, want = testing.shuffled_poisson_ldu((128, 16, 8)), "Gdia"
    ctl = {k: v for k, v in _controls("BJ").items() if k != "matrixFormat"}
    b, x, perf, x_ref, perf_ref = _solve_both(m, ctl)
    assert perf.solver_name == f"GKOCG_{want}"
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-3)
    assert _residual(m, x.numpy(), b) < 1e-5


@pytest.mark.parametrize("fmt", ["Gdia", "Xell"])
def test_unstructured_steady_step_uploads_diag_only(fmt):
    """A diag-only step uploads one block of two and the RHS; the value
    update equals a fresh conversion of the new coefficients, and the
    answer solves the new operator."""
    m = _unstructured(fmt)
    b = _rhs(m.n)
    ctl = {**_controls("none"), "matrixFormat": fmt}
    foam.solve("p", m, b, ctl)
    m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
    b2 = b * 1.01 + 0.1
    x2, perf2 = foam.solve("p", m2, b2, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.last_blocks_uploaded == (1, 2) and slv.last_rhs_uploaded
    fresh = solver_mod._CONVERTERS[fmt](ldu.ldu_to_coo_host(m2, dtype=np.float32))
    torch.testing.assert_close(slv.matrix.vals, fresh.vals, rtol=0, atol=0)
    if fmt == "Xell":
        torch.testing.assert_close(slv.matrix.spill.vals, fresh.spill.vals, rtol=0, atol=0)
    assert slv.matrix.layout is None  # the host layout went into the value map
    assert perf2.converged and _residual(m2, x2.numpy(), b2) < 1e-5


def test_gdia_format_and_rcm_reorder():
    """The port of tests/test_foam.py::test_gdia_format_and_rcm_reorder in
    float32: matrixFormat Gdia + reorder rcm, then a steady step with
    changed coefficients keeps the permutation coherent."""
    m = ref_testing.poisson_ldu((12, 12))
    a = ref_testing.poisson_dense((12, 12))
    x_true = np.random.default_rng(5).normal(size=m.n)
    b = (a @ x_true).astype(np.float32)
    controls = {"solver": "GKOCG", "executor": "reference", "tolerance": 1e-7,
                "relTol": 0, "maxIter": 600, "matrixFormat": "Gdia", "reorder": "rcm"}
    x, perf = foam.solve("p", _port(m), b, controls)
    assert perf.converged and perf.solver_name == "GKOCG_Gdia"
    assert registry.global_registry.get("p_solver")._reorder is not None
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-4)
    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    x2, perf2 = foam.solve("p", _port(m2), b, {})
    np.testing.assert_allclose(x2.numpy(), x_true / 2, atol=1e-4)


def test_rcm_in_the_solver_routes_knn_to_xell():
    """The kNN mesh in its points' numbering with `reorder rcm`: it routes
    to Xell and takes the pre-renumbered solve's iterations ±1, with x
    returned in the caller's numbering."""
    n = 1 << 15
    m_orig, perm = _knn(n, rcm=False)
    m_rcm = testing.renumber_ldu(m_orig, np.argsort(perm))
    ctl = {k: v for k, v in _controls("none").items() if k != "matrixFormat"}
    b_rcm = _rhs(n)
    b_orig = np.empty_like(b_rcm)
    b_orig[perm] = b_rcm
    x_rcm, perf_rcm = foam.solve("p", m_rcm, b_rcm, ctl)
    x, perf = foam.solve("r", m_orig, b_orig, {**ctl, "reorder": "rcm"})
    assert perf.solver_name == perf_rcm.solver_name == "GKOCG_Xell"
    assert abs(perf.n_iterations - perf_rcm.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy()[perm], x_rcm.numpy(), atol=1e-4)
    assert _residual(m_orig, x.numpy(), b_orig) < 1e-5


def test_unroutable_large_matrix_raises_the_reference_error():
    """At 131,072 cells a scrambled coupling fits neither the Gdia planes nor
    the Xell window: the reference's error for its Ell landing, which
    tells the user to renumber."""
    n = 1 << 17
    i = np.arange(n, dtype=np.int64)
    j = (i * 48271 + 11) % n
    own, nbr = np.minimum(i, j)[i != j], np.maximum(i, j)[i != j]
    key = np.unique(own * n + nbr)
    own, nbr = key // n, key % n
    deg = np.bincount(own, minlength=n) + np.bincount(nbr, minlength=n)
    m = ldu.LduMatrix(n=n, lower_addr=own, upper_addr=nbr, diag=deg + 1.0,
                      upper=np.full(len(own), -1.0))
    ctl = {k: v for k, v in _controls("none").items() if k != "matrixFormat"}
    with pytest.raises(RuntimeError, match="Renumber the mesh \\(reorder: rcm\\)"):
        foam.solve("p", m, _rhs(n), ctl)


def test_verbose_names_the_routed_format(capsys):
    m = testing.shuffled_poisson_ldu((32, 16, 8))
    ctl = {k: v for k, v in _controls("none", verbose=1).items() if k != "matrixFormat"}
    _, perf = foam.solve("p", m, _rhs(m.n), ctl)
    perf.print()
    out = capsys.readouterr().out
    for text in ("matrix format: Gdia", "p: matrixFormat auto-routed Coo -> Gdia",
                 "GKOCG_Gdia:  Solving for p"):
        assert text in out


@pytest.mark.parametrize("solver", ["GKOCG", "GKOMultigrid"])
def test_multigrid_on_an_unstructured_matrix_raises(solver):
    """Multigrid on the shuffled grid (routed to Gdia) once raised, naming
    A11 (done): it now solves through the format ladder in the reference's
    iterations ±1 (float32 smoother packing), over a hierarchy whose fine
    level is Gdia, on the merged CG's host loop (GKOCG) or Richardson over
    the Gdia SpMV (GKOMultigrid)."""
    m = testing.shuffled_poisson_ldu((32, 16, 8))
    b = _rhs(m.n)
    pc = {"preconditioner": "Multigrid" if solver == "GKOCG" else "none",
          "precision": "float32"}
    ctl = {"solver": solver, "executor": "cpu", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, "preconditioner": pc}
    _, perf_ref = ref_foam.solve("p", m, b, ctl)
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert perf.solver_name == f"{solver}_Gdia"  # the reference names the configured Coo
    assert slv.route == ("cg_fused" if solver == "GKOCG" else "ir")
    assert type(slv._precond_op.state[0].mat).__name__ == "Gdia"
    assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1


@pytest.mark.parametrize("fmt", ["Gdia", "Xell"])
def test_general_route_on_unstructured(fmt):
    """fusedCG false: the general CG over the format's SpMV wrapper."""
    m = _unstructured(fmt)
    b = _rhs(m.n)
    x1, perf1 = foam.solve("p", m, b, {**_controls("BJ"), "matrixFormat": fmt})
    x2, perf2 = foam.solve("q", m, b, {**_controls("BJ"), "matrixFormat": fmt,
                                       "fusedCG": False})
    assert perf2.solver_name == f"GKOCG_{fmt}"
    assert abs(perf1.n_iterations - perf2.n_iterations) <= 1
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-4)
