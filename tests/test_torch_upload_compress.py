"""uploadPrecision bfloat16 on the port (foam/solver.py `_bf16_delta`,
`_stage_blocks`, `_update_rhs`; the delta decoded by the value-update
kernel) against the reference's: the seven cases of
tests/test_upload_compress.py, with the deltas and mirrors bit-equal to
the reference's `_bf16_delta` (the reference quantises with ml_dtypes, the
port with torch — both round to nearest even) and the device copies
bit-equal to the host mirrors."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import parse_controls as ref_parse_controls
from ogl_tpu_torch import foam, interop, registry
from ogl_tpu_torch.config import parse_controls
from ogl_tpu_torch.core import ldu

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clear():
    registry.global_registry.clear()
    ref_registry.global_registry.clear()
    yield
    registry.global_registry.clear()
    ref_registry.global_registry.clear()


BASE = {"solver": "GKOCG", "tolerance": 1e-7, "relTol": 0.0, "maxIter": 3000,
        "uploadPrecision": "bfloat16", "executor": "cpu", "matrixFormat": "Dia"}


def _port(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper)


def _case(dims=(12, 10, 6), seed=0):
    m = ref_testing.poisson_ldu(dims)
    b = np.random.default_rng(seed).normal(size=m.n).astype(np.float32)
    return m, b


def _step(m, i, rel=1e-6):
    """A transient-CFD-like coefficient nudge: small relative change."""
    f = 1.0 + rel * (i + 1)
    return dataclasses.replace(m, diag=m.diag * f, upper=m.upper * f)


def _bits(dbf) -> np.ndarray:
    return dbf.view(torch.int16).numpy()


def test_bf16_delta_is_the_reference_encoding():
    """The same (new, mirror) pairs: deltas bit-equal, mirrors bit-equal,
    the same refusals — across magnitudes, ties and subnormal deltas."""
    ours = foam.FoamSolver("c", BASE)
    ref = ref_foam.FoamSolver("c", BASE)
    rng = np.random.default_rng(11)
    for scale in (1e-9, 1e-6, 1e-3, 1.0, 1e3):
        mirror = rng.normal(size=4099).astype(np.float32)
        new = (mirror + scale * rng.normal(size=4099)).astype(np.float32)
        new[:3] = mirror[:3] + np.float32(2.0 ** -130)  # subnormal delta
        for tol in (None, 1.0):
            ours.cfg = dataclasses.replace(ours.cfg, upload_delta_tol=tol)
            ref.cfg = dataclasses.replace(ref.cfg, upload_delta_tol=tol)
            got, want = ours._bf16_delta(new, mirror), ref._bf16_delta(new, mirror)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(_bits(got[0]), np.asarray(want[0]).view(np.int16))
                np.testing.assert_array_equal(got[1].view(np.int32),
                                              want[1].view(np.int32))
    assert ours._bf16_delta(new, None) is None and ours._bf16_delta(new, mirror[:5]) is None


def test_bf16_delta_engages_and_stays_accurate():
    m, b = _case()
    slv = foam.FoamSolver("c", BASE)
    ref = ref_foam.FoamSolver("c", BASE)
    slv.solve(_port(m), b)
    ref.solve(m, b)
    slv.solve(_port(_step(m, 99)), b)  # a ~1e-4 relative jump: refreshed full-width
    ref.solve(_step(m, 99), b)
    assert slv.last_blocks_bf16[0] == 0
    for i in range(6):
        m2 = _step(m, i)
        x, perf = slv.solve(_port(m2), b)
        ref.solve(m2, b)
        assert perf.converged
        bf, _ = slv.last_blocks_bf16
        up, _ = slv.last_blocks_uploaded
        assert (bf, up) == (ref.last_blocks_bf16[0], ref.last_blocks_uploaded[0])
        for mir, rmir in zip(slv._blocks_mirror, ref._blocks_mirror):
            np.testing.assert_array_equal(mir, rmir)
        np.testing.assert_array_equal(slv.matrix.data.numpy(), np.asarray(ref.matrix.data))
        if i == 0:
            assert bf == 0 and up > 0  # the jump back refreshes full-width
            continue
        assert bf == up > 0, f"step {i}: bf16 deltas not used ({bf}/{up})"
        coo = ldu.ldu_to_coo_host(_port(m2), dtype=np.float64)
        a64 = sp.csr_matrix((coo.vals, (coo.rows, coo.cols)), shape=coo.shape)
        res = np.abs(b - a64 @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum()
        assert res < 1e-5, f"step {i}: residual vs exact operator {res:.2e}"


def _pair(name, m, b, cfg=None):
    """The port's and the reference's solvers for `name`, after the first
    solve of (m, b)."""
    ours = foam.FoamSolver(name, BASE if cfg is None else cfg[0])
    ref = ref_foam.FoamSolver(name, BASE if cfg is None else cfg[1])
    ours.solve(_port(m), b)
    ref.solve(m, b)
    return ours, ref


def _same_step(ours, ref, m, b):
    """One steady step of (m, b) on both: the same bf16 blocks, uploads and
    bytes, the same mirrors and the same container bits."""
    x, perf = ours.solve(_port(m), b)
    ref.solve(m, b)
    assert perf.converged
    assert ours.last_blocks_bf16 == tuple(ref.last_blocks_bf16)
    assert ours.last_blocks_uploaded == tuple(ref.last_blocks_uploaded)
    assert ours.last_upload_bytes == ref.last_upload_bytes
    for mir, rmir in zip(ours._blocks_mirror, ref._blocks_mirror):
        assert (mir is None) == (rmir is None)
        if mir is not None:
            np.testing.assert_array_equal(mir.view(np.int32), np.asarray(rmir).view(np.int32))
    np.testing.assert_array_equal(ours.matrix.data.numpy().view(np.int32),
                                  np.asarray(ref.matrix.data).view(np.int32))
    return x, perf


def test_upload_bytes_halved():
    m, b = _case(seed=1)
    f32 = {k: v for k, v in BASE.items() if k != "uploadPrecision"}
    pairs = [_pair("c", m, b), _pair("c32", m, b, (f32, f32))]
    for i in range(2):
        for ours, ref in pairs:
            _same_step(ours, ref, _step(m, i), b)
    (slv, _), (slv32, _) = pairs
    assert slv.last_blocks_bf16 == (2, 2)
    assert slv.last_upload_bytes * 2 == slv32.last_upload_bytes


@pytest.mark.parametrize("warm", [False, True], ids=["first_step_doubled", "bf16_step_inexact"])
def test_large_change_full_refresh(warm):
    """A change bfloat16 cannot carry within the tolerance is uploaded at
    float32, as the reference uploads it: the reference's own case (the
    diag doubled at the first steady step, which sends its changed blocks
    at full width on both) and, after a bfloat16 step, a change no
    bfloat16 delta is within the tolerance of."""
    m, b = _case(seed=2)
    ours, ref = _pair("c", m, b)
    if warm:
        m = _step(m, 0)
        _same_step(ours, ref, m, b)
        assert ours.last_blocks_bf16 == (0, 2)  # the first steady step: full width
        m = _step(m, 1)
        _same_step(ours, ref, m, b)
        assert ours.last_blocks_bf16 == (2, 2)
        big = dataclasses.replace(m, diag=m.diag * 2.0 + np.float32(0.1234567))
    else:
        big = dataclasses.replace(m, diag=m.diag * 2.0)  # 100% change
    _same_step(ours, ref, big, b)
    assert ours.last_blocks_bf16[0] == 0 and ours.last_blocks_uploaded == (1, 2)
    np.testing.assert_array_equal(ours._blocks_dev[1].numpy(), np.asarray(big.diag, np.float32))


def test_no_drift_over_many_steps():
    """Error feedback: 40 steps of bf16 deltas, each step the reference's
    counters, mirrors and container bits; then the device copies bit-equal
    to the host mirrors and within the tolerance of the exact values."""
    m, b = _case(seed=3)
    slv, ref = _pair("c", m, b)
    m2 = m
    for i in range(40):
        m2 = _step(m, i, rel=3e-7)
        _same_step(slv, ref, m2, b)
    for mir, dev in zip(slv._blocks_mirror, slv._blocks_dev):
        np.testing.assert_array_equal(mir, dev.numpy())
    exact = [np.asarray(m2.diag, np.float32), np.asarray(m2.upper, np.float32)]
    for ex in exact:
        mir = next(mm for mm in slv._blocks_mirror if mm.shape == ex.shape)
        rel = np.max(np.abs(mir - ex)) / np.max(np.abs(ex))
        assert rel <= 1.1e-5, f"accumulated drift {rel:.2e}"


def test_first_steady_step_uploads_like_the_reference():
    """The port leaves its blocks resident from the first solve; the
    reference stages them at the first steady step.  Where a step takes
    the per-block plans, or changes every block, both upload the same
    blocks, at full width; where the full path runs over unchanged blocks
    the reference uploads them too, the port does not (and with no block
    changed does no device work).  The containers agree throughout."""
    m, b = _case(seed=8)
    ours, ref = _pair("c", m, b)
    _same_step(ours, ref, dataclasses.replace(m, diag=m.diag * np.float32(1 + 1e-6)), b)
    assert ours.last_blocks_uploaded == (1, 2) and ours.last_blocks_bf16 == (0, 2)
    ours, ref = _pair("d", m, b)
    _same_step(ours, ref, _step(m, 0), b)
    assert ours.last_blocks_uploaded == (2, 2) and ours.last_blocks_bf16 == (0, 2)
    ours, ref = _pair("e", m, b)
    ours.solve(_port(m), b)
    ref.solve(m, b)
    assert ours.last_blocks_changed == tuple(ref.last_blocks_changed) == (0, 2)
    assert ours.last_blocks_uploaded == (0, 2) and ours.last_upload_bytes == 0
    assert tuple(ref.last_blocks_uploaded) == (2, 2)
    np.testing.assert_array_equal(ours.matrix.data.numpy(), np.asarray(ref.matrix.data))


def test_rhs_bf16_path():
    m, b = _case(seed=4)
    slv = foam.FoamSolver("c", BASE)
    ref = ref_foam.FoamSolver("c", BASE)
    slv.solve(_port(m), b)
    ref.solve(m, b)
    b1 = b * (1.0 + np.float32(1e-6))
    x, perf = slv.solve(_port(m), b1)
    ref.solve(m, b1)
    assert slv.last_rhs_uploaded and slv.last_rhs_bf16 and ref.last_rhs_bf16
    assert perf.converged
    np.testing.assert_array_equal(slv._b_mirror, ref._b_mirror)
    np.testing.assert_array_equal(slv._b_dev.numpy(), slv._b_mirror)
    b2 = np.random.default_rng(6).normal(size=m.n).astype(np.float32) * 5
    slv.solve(_port(m), b2)
    assert slv.last_rhs_uploaded and not slv.last_rhs_bf16
    np.testing.assert_array_equal(slv._b_dev.numpy(), b2)


def test_f64_route_unaffected():
    """The reference ignores uploadPrecision on its float64 route; the port
    has no float64 route yet: dtype float64 raises naming its item (A14),
    and uploadPrecision bfloat16 is no longer named as missing."""
    with pytest.raises(NotImplementedError, match="dtype float64 .*A14"):
        foam.FoamSolver("c64", {**BASE, "dtype": "float64"})
    assert foam.solver.unsupported(parse_controls(BASE)) is None


def test_explicit_tol_honored_from_dataclass():
    """An explicit uploadDeltaTol — on the dataclass or as the dict key — is
    honoured, not tightened to tolerance/10, as the reference honours it."""
    m, b = _case(seed=7)
    cfg = dataclasses.replace(parse_controls(BASE), upload_delta_tol=5e-2)
    ref_cfg = dataclasses.replace(ref_parse_controls(BASE), upload_delta_tol=5e-2)
    assert ref_cfg.upload_delta_tol == cfg.upload_delta_tol
    m2 = dataclasses.replace(m, diag=m.diag * np.float32(1.001),
                             upper=m.upper * np.float32(1.001))
    keyed = {**BASE, "uploadDeltaTol": 5e-2}
    for name, c in (("cx", (cfg, ref_cfg)), ("cy", (keyed, keyed))):
        slv, ref = _pair(name, m, b, c)
        _same_step(slv, ref, _step(m, 0), b)
        _same_step(slv, ref, m2, b)  # 1e-3: above tolerance/10, below the explicit 5e-2
        bf, up = slv.last_blocks_bf16
        assert bf == slv.last_blocks_uploaded[0] == 2 and up == 2
