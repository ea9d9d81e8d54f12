"""The port's bench (ogl_tpu_torch/bench.py) and the device-only solve
timer (`FoamSolver.time_device_solve`) on the CPU.

`_poisson_dia` is held bit-equal to the conversion path of both packages;
`time_device_solve` is held, on every route, to re-running the last solve
on its resident state (no upload, the same x); `bench.run` on the CPU is
the rehearsal of the card's run at a small size."""

import json

import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu_torch import bench, foam, registry, testing
from ogl_tpu_torch.core import formats, ldu

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 4, 1), (5, 1, 1)], ids=str)
def test_poisson_dia_equals_the_conversion_of_both_packages(dims):
    got = bench._poisson_dia(dims, torch.device("cpu"))
    port = formats.coo_to_dia(ldu.ldu_to_coo_host(testing.poisson_ldu(dims),
                                                  dtype=np.float32))
    ref = ref_formats.coo_to_dia(ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(dims),
                                                         dtype=np.float32))
    assert got.offsets == port.offsets == ref.offsets
    assert got.shape == port.shape == tuple(ref.shape)
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), port.data.numpy())
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))


def test_time_device_solve_before_a_solve_raises():
    slv = foam.FoamSolver("p", {"solver": "GKOCG", "executor": "cpu"})
    with pytest.raises(RuntimeError, match="no solve has run yet"):
        slv.time_device_solve()


# route -> (controls, system)
ROUTES = {
    "cg_fused": ({"solver": "GKOCG", "preconditioner": "none"}, "poisson"),
    "cg_fused-BJ": ({"solver": "GKOCG", "preconditioner": {"preconditioner": "BJ"}},
                    "poisson"),
    "cg": ({"solver": "GKOCG", "fusedCG": False}, "poisson"),
    "cg_pipe_fused": ({"solver": "GKOCG", "pipelinedCG": True}, "poisson"),
    "bicgstab": ({"solver": "GKOBiCGStab", "preconditioner": {"preconditioner": "BJ"}},
                 "convection-diffusion"),
    "bicgstab_fused": ({"solver": "GKOBiCGStab", "fusedBiCGStab": True},
                       "convection-diffusion"),
    "ir": ({"solver": "GKOMultigrid"}, "poisson"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_time_device_solve_reruns_the_last_solve_without_uploads(name):
    spec, system = ROUTES[name]
    dims = (16, 16, 8)
    m = testing.poisson_ldu(dims) if system == "poisson" else \
        testing.convection_diffusion_ldu(dims)
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"executor": "cpu", "tolerance": 1e-6, "relTol": 0, **spec}
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.route == name.split("-")[0] and perf.converged
    before = (slv.last_blocks_uploaded, slv.last_rhs_uploaded, slv.last_upload_bytes,
              slv.last_blocks_changed, dict(slv.last_timings))
    seconds = slv.time_device_solve(reps=2)
    assert seconds > 0 and np.isfinite(seconds)
    assert before == (slv.last_blocks_uploaded, slv.last_rhs_uploaded,
                      slv.last_upload_bytes, slv.last_blocks_changed, slv.last_timings)
    again = slv._redispatch()
    assert again.iters == perf.n_iterations
    assert torch.equal(again.x, x)


def test_bench_run_on_the_cpu(capsys):
    out = bench.run(torch.device("cpu"), (16, 16, 8), (16, 16, 16), target_seconds=0.05)
    printed = capsys.readouterr().out
    lines = [json.loads(s) for s in printed.splitlines() if s.startswith('{"metric"')]
    assert len(lines) == 1
    line = lines[0]
    assert line["metric"] == "cg_time_per_iter_per_dof" and line["unit"] == "ns"
    assert line["value"] == round(out["cg"]["ns_per_iter_dof"], 4) > 0
    assert line["vs_baseline"] == round(out["spmv"]["fraction"] / 0.80, 3)
    assert out["device"] == "cpu"
    pk = out["peaks"]
    assert pk["published_gbps"] == 50.0 and pk["read_device_gbps"] == 0.0
    assert pk["denominator_gbps"] == max(pk["published_gbps"], pk["triad_gbps"],
                                         pk["read_gbps"])
    assert 0 < out["spmv"]["fraction"] <= bench.PEAK_FRACTION_LIMIT
    for lane, n in (("cg", 2048), ("cg_big", 4096)):
        cg = out[lane]
        assert cg["n"] == n and cg["iters"] > 0 and cg["us_per_iter"] > 0
        assert cg["true_residual"] <= bench.TRUE_RESIDUAL_MARGIN * bench.TOL
    step = out["foam_step"]
    assert step["n"] == 2048 and step["step_ms"] > 0 and step["device_only_ms"] > 0
    assert step["diag_only_ms"] > 0 and "solve" in step["split_ms"]
    # a CPU run gives no device-timeline figure
    assert not any(k.startswith("device_") for lane in ("spmv", "cg", "cg_big")
                   for k in out[lane])
    assert "device-busy" not in printed and printed.count("not measured (CPU run)") == 3


def test_a_fraction_above_the_limit_raises():
    bench._check_fraction("ok", 1.05)
    with pytest.raises(RuntimeError, match="a fault of the measurement"):
        bench._check_fraction("SpMV roofline", 1.06)
    with pytest.raises(RuntimeError):
        bench._check_fraction("nan", float("nan"))


def test_bench_main_without_cuda_exits_one(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
