"""The lid-driven-cavity example on the port (ogl_tpu_torch/examples/
cavity.py) on the CPU: the bounds and sizes of tests/test_example_cavity.py
(Ghia, Ghia & Shin 1982 at Re = 100), and ψ after the first five steps
within 1e-4 of the reference application's (examples/cavity.py on
ogl_tpu)."""

import os
import sys

import numpy as np
import pytest
import torch

from ogl_tpu import registry as ref_registry
from ogl_tpu_torch import registry
from ogl_tpu_torch.examples.cavity import Cavity, run

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_registries():
    registry.global_registry.clear()
    ref_registry.global_registry.clear()
    yield
    registry.global_registry.clear()
    ref_registry.global_registry.clear()


def test_cavity_ghia_validation():
    cav, records = run(n=32, re=100.0, verbose=False, executor="cpu")
    psi_min = float(cav.psi.min())
    # Ghia et al. Re=100: psi_min = -0.10342 (129x129, second order); a
    # first-order-upwind 32x32 solution lands within a few percent
    assert -0.115 < psi_min < -0.085, psi_min
    pn = np.pad(cav.psi, 1)
    jc = cav.n // 2
    u_c = (pn[2:, jc + 1] - pn[:-2, jc + 1]) / (2 * cav.h)
    assert -0.24 < float(u_c.min()) < -0.17  # Ghia: -0.2109
    assert float(u_c[-1]) > 0.3  # the lid drives a clockwise primary vortex


def test_cavity_solvers_reach_steady_iteration_plateau():
    """Per-step coefficient updates: the transport solve's iteration count
    settles and every step converges within maxIter."""
    cav, records = run(n=24, re=100.0, verbose=False, executor="cpu")
    iters_w = [r["omega_iters"] for r in records]
    iters_p = [r["psi_iters"] for r in records]
    assert max(iters_w) < 1000 and max(iters_p) < 1000
    tail_w = iters_w[-10:]
    assert max(tail_w) - min(tail_w) <= 5, tail_w
    assert records[-1]["dmax"] < 1e-2 * max(r["dmax"] for r in records)


def test_cavity_momentum_system_is_asymmetric():
    cav = Cavity(16, 100.0, 0.05)
    cav.psi = np.random.default_rng(0).normal(size=(16, 16)) * 0.01
    m, rhs = cav.assemble_omega()
    assert not m.symmetric
    assert rhs.shape == (256,)
    assert np.all(np.asarray(m.diag) > 0)
    assert np.all(np.asarray(m.upper) <= 0)
    assert np.all(np.asarray(m.lower) <= 0)


def test_cavity_first_five_steps_match_reference():
    import cavity as ref_cavity

    ref, ref_rec = ref_cavity.run(n=32, re=100.0, steps=5, verbose=False)
    cav, rec = run(n=32, re=100.0, steps=5, verbose=False, executor="cpu")
    assert len(rec) == len(ref_rec) == 5
    np.testing.assert_allclose(cav.psi, ref.psi, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cav.omega, ref.omega, rtol=1e-3, atol=1e-3)
