"""The Karman-vortex-street example on the port (ogl_tpu_torch/examples/
karman.py) on the CPU: the wake checks of tests/test_example_karman.py at
96x32 for 400 steps, the assembled systems' structure, and ψ after the
first five steps within 1e-4 of the reference application's
(examples/karman.py on ogl_tpu)."""

import os
import sys

import numpy as np
import pytest
import torch

from ogl_tpu import registry as ref_registry
from ogl_tpu_torch import registry
from ogl_tpu_torch.examples.karman import Karman, run, strouhal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_registries():
    registry.global_registry.clear()
    ref_registry.global_registry.clear()
    yield
    registry.global_registry.clear()
    ref_registry.global_registry.clear()


def test_karman_develops_wake():
    k, probe = run(nx=96, ny=32, d=6, re=100.0, steps=400, verbose=False, executor="cpu")
    assert np.all(np.isfinite(k.psi)) and np.all(np.isfinite(k.omega))
    u, v = k.velocities()
    jc = k.ny // 2
    behind = u[jc, k.i0 + k.d + 1: k.i0 + k.d + 6]
    assert behind.mean() < 0.5 * k.u0, behind
    ahead = u[jc - k.d: jc + k.d, 2].mean()
    assert ahead > 0.6 * k.u0, ahead
    assert np.all(u[k.solid] == 0.0)
    np.testing.assert_allclose(k.psi[k.solid], k.psi_obs, rtol=1e-5)
    st, amp = strouhal(probe, k.dt)
    assert np.isfinite(st) and np.isfinite(amp)


def test_karman_system_structure():
    k = Karman(nx=64, ny=24, d=4, re=100.0)
    m = k.a_psi
    assert m.symmetric
    d = np.asarray(m.diag)
    assert np.all(d[k.solid.ravel()] == 1.0)
    assert np.all(d[~k.solid.ravel()] >= 3.0)
    k.psi += 0.01 * np.random.default_rng(0).standard_normal(k.psi.shape)
    mo, rhs = k.assemble_omega()
    assert not mo.symmetric
    assert np.all(np.asarray(mo.upper) <= 0)
    assert np.all(np.asarray(mo.lower) <= 0)
    assert np.all(np.asarray(mo.diag)[k.solid.ravel()] == 1.0)
    assert rhs.shape == (k.nx * k.ny,)


def test_karman_first_five_steps_match_reference():
    import karman as ref_karman

    ref, ref_probe = ref_karman.run(nx=96, ny=32, d=6, re=100.0, steps=5, verbose=False)
    k, probe = run(nx=96, ny=32, d=6, re=100.0, steps=5, verbose=False, executor="cpu")
    np.testing.assert_allclose(k.psi, ref.psi, rtol=0, atol=1e-4)
    np.testing.assert_allclose(probe, ref_probe, rtol=0, atol=1e-4)
