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
from ogl_tpu_torch import foam, interop, kernels, registry

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
