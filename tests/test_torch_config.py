"""The port's copied host modules (config, registry, testing) against the
reference's, the slice's rejection of controls it does not implement, and
the executor → device mapping."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu import config as ref_config
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu_torch import config, device_for, registry, testing
from ogl_tpu_torch.foam import GKOCG, FoamSolver

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


CONTROLS = [
    {},
    {"solver": "GKOCG", "tolerance": 1e-8, "relTol": 0.01, "maxIter": 50},
    {"preconditioner": {"preconditioner": "BJ", "maxBlockSize": 1, "caching": 3}},
    {"preconditioner": "BJ", "adaptMinIter": "off", "relaxationFactor": 0.8,
     "normEvalLimit": 20},
    {"evalFrequency": 8, "minIter": 5, "scaling": 2.5, "verbose": 1},
    {"matrixFormat": "Dia", "executor": "cuda", "fusedCG": "false",
     "updateRHS": "no", "updateInitGuess": True, "updateSysMatrix": 0},
    {"solver": "GKOBiCGStab", "maxIter": 30, "uploadPrecision": "bfloat16",
     "uploadDeltaTol": 1e-4},
    {"solver": "GKOIR", "inner": {"tolerance": 1e-2, "precision": "bfloat16"},
     "preconditioner": {"preconditioner": "Multigrid", "maxLevels": 4,
                        "coarseMaxIters": 6}},
]


@pytest.mark.parametrize("controls", CONTROLS)
def test_parse_controls_matches_reference(controls):
    ours = config.parse_controls(controls)
    ref = ref_config.parse_controls(controls)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_parse_controls_rejects_like_reference():
    for bad in ({"matrixFormat": "Bogus"}, {"uploadPrecision": "fp8"}):
        with pytest.raises(ValueError):
            ref_config.parse_controls(bad)
        with pytest.raises(ValueError):
            config.parse_controls(bad)


def test_registry_matches_reference():
    for mod in (registry, ref_registry):
        reg = mod.Registry()
        assert reg.get_or_init("a", lambda: 1) == 1
        assert reg.get_or_init("a", lambda: 2) == 1
        reg.put("b", 3)
        assert "b" in reg and reg.pop("b") == 3 and "b" not in reg
        props = reg.properties("p")
        assert vars(props) == vars(ref_registry.SolverProperties())
        props.prev_solve_iters = 7
        assert reg.properties("p").prev_solve_iters == 7
        reg.clear()
        assert reg.get("a") is None
        assert reg.properties("p").prev_solve_iters == 0


@pytest.mark.parametrize("dims", [(16, 16, 8), (96, 11), 7])
def test_testing_problems_match_reference(dims):
    ours, ref = testing.poisson_ldu(dims), ref_testing.poisson_ldu(dims)
    for f in ("n", "lower_addr", "upper_addr", "diag", "upper"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.lower is None and ref.lower is None
    np.testing.assert_array_equal(testing.poisson_dense(dims), ref_testing.poisson_dense(dims))
    cd, cd_ref = (mod.convection_diffusion_ldu(dims) for mod in (testing, ref_testing))
    np.testing.assert_array_equal(cd.lower, cd_ref.lower)
    np.testing.assert_array_equal(testing.to_dense_ldu(cd), ref_testing.to_dense_ldu(cd_ref))
    assert testing.grid_shape(dims) == ref_testing.grid_shape(dims)


# the ids are the list's positions before the AMG controls (A11) and
# uploadPrecision bfloat16 (A7) below left it: they solve now
UNSUPPORTED = [
    pytest.param({"solver": "GKOIR"}, "A9", id="controls0-A9"),
    pytest.param({"preconditioner": {"preconditioner": "ILU", "precision": "bfloat16"}}, "A10",
                 id="controls1-A10"),
    pytest.param({"preconditioner": {"preconditioner": "Multigrid", "precision": "bfloat16"}},
                 "A10", id="controls2-A10"),
    pytest.param({"preconditioner": {"preconditioner": "ISAI", "precision": "bfloat16"}}, "A10",
                 id="controls3-A10"),
    pytest.param({"dtype": "float64"}, "A14", id="controls6-A14"),
    pytest.param({"solver": "GKOBiCGStab", "dtype": "float64"}, "A14", id="controls7-A14"),
    pytest.param({"export": True}, "A15", id="controls10-A15"),
    pytest.param({"debug": True}, "A15", id="controls11-A15"),
]


@pytest.mark.parametrize("controls,item", UNSUPPORTED)
def test_unsupported_controls_raise(controls, item):
    ctl = {"executor": "cpu", **controls}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        FoamSolver("p", ctl)


# AMG on a matrix format other than Dia (ROADMAP.md A11, once refused like
# the controls above): each solves on the CPU in the reference's iterations,
# +2 at most with the port's default bfloat16 smoother packing (the
# reference's CPU cycle is float32), -1 at least
FORMER_A11 = [
    pytest.param({"matrixFormat": "Csr", "preconditioner": "Multigrid"}, id="controls4-A11"),
    pytest.param({"matrixFormat": "Ell", "solver": "GKOMultigrid"}, id="controls5-A11"),
    pytest.param({"matrixFormat": "Gdia", "preconditioner": "Multigrid"}, id="controls8-A11"),
    pytest.param({"matrixFormat": "Xell", "solver": "GKOMultigrid"}, id="controls12-A11"),
    pytest.param({"matrixFormat": "Sell", "preconditioner": "Multigrid"}, id="controls13-A11"),
]


@pytest.mark.parametrize("controls", FORMER_A11)
def test_former_a11_controls_solve_like_the_reference(controls):
    from ogl_tpu import foam as ref_foam

    m = testing.shuffled_poisson_ldu((16, 8, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"executor": "cpu", "tolerance": 1e-6, "relTol": 0, "adaptMinIter": False,
           **controls}
    _, perf_ref = ref_foam.solve(f"p_{controls['matrixFormat']}", m, b, ctl)
    _, perf = FoamSolver("p", ctl).solve(m, b)
    solver = controls.get("solver", "GKOCG")
    assert perf.solver_name == perf_ref.solver_name == f"{solver}_{controls['matrixFormat']}"
    assert perf.converged and perf_ref.converged
    assert perf_ref.n_iterations - 1 <= perf.n_iterations <= perf_ref.n_iterations + 2


# uploadPrecision bfloat16 (ROADMAP.md A7, once refused like the controls
# above): a steady step sends its changed blocks as bfloat16 deltas and
# solves in the reference's iterations
FORMER_A7 = [pytest.param({"uploadPrecision": "bfloat16"}, id="controls9-A7")]


@pytest.mark.parametrize("controls", FORMER_A7)
def test_former_a7_controls_solve_like_the_reference(controls):
    import dataclasses as dc

    from ogl_tpu import foam as ref_foam

    m = testing.poisson_ldu((16, 8, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"executor": "cpu", "tolerance": 1e-6, "relTol": 0, "adaptMinIter": False,
           "matrixFormat": "Dia", **controls}
    ref, ours = ref_foam.FoamSolver("p", ctl), FoamSolver("p", ctl)
    for k in range(3):
        mk = dc.replace(m, diag=np.asarray(m.diag) * np.float32(1.0 + 1e-6 * k))
        _, perf_ref = ref.solve(mk, b)
        _, perf = ours.solve(mk, b)
        assert perf.converged and perf_ref.converged
        assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    assert ours.last_blocks_bf16 == ref.last_blocks_bf16 == (1, 2)


def test_executor_mapping_and_no_silent_cpu_fallback():
    for ex in ("reference", "omp", "cpu"):
        assert device_for(ex) == torch.device("cpu")
    with pytest.raises(ValueError):
        device_for("quantum")
    if torch.cuda.is_available():  # on a card both map to it
        assert device_for("tpu").type == "cuda"
        return
    for ex in ("cuda", "tpu", "hip", "dpcpp"):
        with pytest.raises(RuntimeError, match="CUDA"):
            device_for(ex)
    with pytest.raises(RuntimeError, match="CUDA"):
        GKOCG("p", {"executor": "cuda", "matrixFormat": "Dia"})
    # the default executor (tpu) is an accelerator executor too
    with pytest.raises(RuntimeError, match="CUDA"):
        FoamSolver("p", {"matrixFormat": "Dia"})


def test_port_imports_neither_jax_nor_ogl_tpu():
    code = (
        "import sys, ogl_tpu_torch, ogl_tpu_torch.foam, ogl_tpu_torch.interop, "
        "ogl_tpu_torch.testing, ogl_tpu_torch.kernels._build, "
        "ogl_tpu_torch.kernels.value_update, ogl_tpu_torch.examples.cavity, "
        "ogl_tpu_torch.examples.karman; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ogl_tpu' or m.startswith('ogl_tpu.') or m == 'triton' "
        "or m == 'ml_dtypes']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
