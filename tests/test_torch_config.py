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


UNSUPPORTED = [
    ({"solver": "GKOIR"}, "A9"),
    ({"preconditioner": {"preconditioner": "ILU", "precision": "bfloat16"}}, "A10"),
    ({"preconditioner": {"preconditioner": "Multigrid", "precision": "bfloat16"}}, "A10"),
    ({"preconditioner": {"preconditioner": "ISAI", "precision": "bfloat16"}}, "A10"),
    ({"matrixFormat": "Csr", "preconditioner": "Multigrid"}, "A11"),
    ({"matrixFormat": "Ell", "solver": "GKOMultigrid"}, "A11"),
    ({"dtype": "float64"}, "A14"),
    ({"solver": "GKOBiCGStab", "dtype": "float64"}, "A14"),
    ({"matrixFormat": "Gdia", "preconditioner": "Multigrid"}, "A11"),
    ({"uploadPrecision": "bfloat16"}, "A7"),
    ({"export": True}, "A15"),
    ({"debug": True}, "A15"),
    ({"matrixFormat": "Xell", "solver": "GKOMultigrid"}, "A11"),
    ({"matrixFormat": "Sell", "preconditioner": "Multigrid"}, "A11"),
]


@pytest.mark.parametrize("controls,item", UNSUPPORTED)
def test_unsupported_controls_raise(controls, item):
    ctl = {"executor": "cpu", **controls}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        FoamSolver("p", ctl)


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
        "ogl_tpu_torch.testing, ogl_tpu_torch.kernels._build; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ogl_tpu' or m.startswith('ogl_tpu.') or m == 'triton']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
