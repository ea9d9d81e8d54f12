"""The steady step's incremental per-block value update (core/formats.py
`block_update_plans`, `accumulate_plan`; foam/solver.py
`_apply_block_updates` over kernels/value_update.py) against the
reference's (ogl_tpu `formats.block_update_plans`, `FoamSolver.
_apply_block_updates`): the same LDU systems and change sequences through
both packages, the plans' dest/src/affine starts equal to the reference's,
and after every step the container's float32 values equal to the
reference's exactly.  The seven cases of tests/test_incremental_update.py,
and beside them the accumulate path (a map whose slots take several
entries) and a plan built before an update solving with the new values."""

import dataclasses

import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu_torch import foam, interop, registry, testing
from ogl_tpu_torch.core import formats
from ogl_tpu_torch.foam import solver as solver_mod

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_registries():
    registry.global_registry.clear()
    ref_registry.global_registry.clear()
    yield
    registry.global_registry.clear()
    ref_registry.global_registry.clear()


@pytest.fixture
def launches(monkeypatch):
    """Calls of the value-update kernel's wrapper by the solver (on the CPU
    the wrapper runs its twin: no launch is counted)."""
    calls = []
    real = solver_mod.value_update

    def counted(flat, sources, writes):
        calls.append((len(sources), len(writes)))
        return real(flat, sources, writes)

    monkeypatch.setattr(solver_mod, "value_update", counted)
    return calls


def _port(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper, m.lower,
                                   m.local_interfaces)


def _pair(name, m, b, extra=None):
    ctl = {"solver": "GKOCG", "tolerance": 1e-8, "relTol": 0.0, "maxIter": 2000,
           "matrixFormat": "Dia", "executor": "cpu", **(extra or {})}
    ref = ref_foam.FoamSolver(name, ctl)
    ours = foam.FoamSolver(name, ctl)
    ref.solve(m, b)
    ours.solve(_port(m), b)
    return ref, ours


def _step(ref, ours, m, b):
    xr, pr = ref.solve(m, b)
    x, p = ours.solve(_port(m), b)
    return x, p, xr, pr


def _flat(mat) -> np.ndarray:
    return formats.values_flat(mat).numpy()


def _same_values(ref, ours):
    """Dia, Coo and Csr store their values in the same flat order in both
    packages."""
    np.testing.assert_array_equal(_flat(ours.matrix),
                                  np.asarray(ref_formats.values_flat(ref.matrix)).reshape(-1))


def _same_plans(ref, ours):
    assert (ref._block_plans is None) == (ours._block_plans is None)
    if ref._block_plans is None:
        return
    assert len(ref._block_plans) == len(ours._block_plans)
    for rp, p in zip(ref._block_plans, ours._block_plans):
        assert (rp.dest is None) == (p.dest is None) and (rp.src is None) == (p.src is None)
        assert rp.dest_start == p.dest_start and rp.length == p.length
        if p.dest is not None:
            assert p.dest.dtype == torch.int32
            np.testing.assert_array_equal(p.dest.numpy(), np.asarray(rp.dest))
        if p.src is not None:
            assert p.src.dtype == torch.int32
            np.testing.assert_array_equal(p.src.numpy(), np.asarray(rp.src))


def _dense_solve(m, b):
    return np.linalg.solve(ref_testing.to_dense_ldu(m), np.asarray(b, np.float64))


def test_diag_only_change_is_affine_slice(launches):
    """Symmetric Poisson on Dia: the diag block's plan is affine (one run on
    the main plane), a diag-only change stages exactly that block (the
    upper block's resident copy is not touched) in one call of the
    value-update kernel, and the container equals the reference's."""
    m = ref_testing.poisson_ldu((12, 10, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("pIncr", m, b)
    upper_dev = ours._blocks_dev[0]
    for k, shift in enumerate((0.5, 1.25)):
        m2 = dataclasses.replace(m, diag=m.diag + np.float32(shift))
        del launches[:]
        x, perf, _, _ = _step(ref, ours, m2, b)
        assert perf.converged
        assert ours.last_blocks_changed == ref.last_blocks_changed == (1, 2)
        assert ours.last_blocks_uploaded == ref.last_blocks_uploaded == (1, 2)
        assert launches == [(1, 1)]  # one block, one write, one call
        assert ours._block_plans[1].dest is None
        assert ours._blocks_dev[0] is upper_dev  # never staged again
        _same_plans(ref, ours)
        _same_values(ref, ours)
        np.testing.assert_allclose(x.numpy(), _dense_solve(m2, b), atol=2e-4)


def test_nonsymmetric_partial_and_full_changes(launches):
    """Convection–diffusion (three source blocks) under GKOBiCGStab + BJ:
    each partial change pattern writes only its blocks, all three changed
    take the full path; the container equals the reference's every step."""
    m = ref_testing.convection_diffusion_ldu((10, 9, 7), peclet=0.4)
    b = np.random.default_rng(1).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("uIncr", m, b, {"solver": "GKOBiCGStab", "preconditioner": "BJ"})
    m2 = dataclasses.replace(m, diag=m.diag * np.float32(1.1))
    m3 = dataclasses.replace(m2, lower=m2.lower * np.float32(1.3))
    m4 = dataclasses.replace(m3, upper=m3.upper * np.float32(0.9),
                             diag=m3.diag + np.float32(0.2))
    m5 = dataclasses.replace(m4, upper=m4.upper * np.float32(1.05),
                             lower=m4.lower * np.float32(1.05), diag=m4.diag + np.float32(0.1))
    for mk, up, writes in ((m2, 1, 1), (m3, 1, 1), (m4, 2, 2), (m5, 3, 3)):
        del launches[:]
        x, _, _, _ = _step(ref, ours, mk, b)
        assert ours.last_blocks_uploaded == ref.last_blocks_uploaded == (up, 3)
        assert launches == [(up, writes)]
        _same_plans(ref, ours)
        _same_values(ref, ours)
        np.testing.assert_allclose(x.numpy(), _dense_solve(mk, b), atol=2e-4)


def test_incremental_with_rcm_reorder():
    """The plans compose the RCM entry order with the sparsity permute (on
    Csr: the renumbered grid has more diagonals than the Dia kernels take)."""
    m = ref_testing.poisson_ldu((9, 8, 6))
    b = np.random.default_rng(2).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("pRcm", m, b, {"reorder": "rcm", "matrixFormat": "Csr"})
    m2 = dataclasses.replace(m, diag=m.diag + np.float32(0.7))
    x, _, _, _ = _step(ref, ours, m2, b)
    assert ours.last_blocks_uploaded == ref.last_blocks_uploaded == (1, 2)
    _same_plans(ref, ours)
    _same_values(ref, ours)
    np.testing.assert_allclose(x.numpy(), _dense_solve(m2, b), atol=2e-4)


def test_incremental_identity_map_coo():
    """Coo (identity value map): the plans are the entries' positions, a
    diag-only change still uploads one block (a scatter plan)."""
    m = ref_testing.poisson_ldu((8, 7, 5))
    b = np.random.default_rng(3).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("pCooIncr", m, b, {"matrixFormat": "Coo"})
    m2 = dataclasses.replace(m, diag=m.diag + np.float32(0.5))
    x, _, _, _ = _step(ref, ours, m2, b)
    assert ours.last_blocks_uploaded == ref.last_blocks_uploaded == (1, 2)
    assert ours._block_plans[1].dest is not None and ours._block_plans[1].src is None
    _same_plans(ref, ours)
    np.testing.assert_array_equal(ours.matrix.vals.numpy(), np.asarray(ref.matrix.vals))
    np.testing.assert_allclose(x.numpy(), _dense_solve(m2, b), atol=2e-4)


def test_interface_blocks_and_scaling():
    """Periodic channel (the cyclic interface an extra source block) with
    scaling 2: every change pattern's container equals the reference's."""
    m = ref_testing.channel_ldu((8, 6, 4))
    b = np.random.default_rng(4).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("chanIncr", m, b, {"scaling": 2.0})
    li = m.local_interfaces[0]
    steps = (dataclasses.replace(m, diag=m.diag + np.float32(0.4)),
             dataclasses.replace(m, local_interfaces=(dataclasses.replace(
                 li, coeffs=li.coeffs * 1.5),)),
             dataclasses.replace(m, upper=m.upper * np.float32(0.75),
                                 diag=m.diag + np.float32(0.3)))
    for mk in steps:
        x, perf, _, _ = _step(ref, ours, mk, b)
        assert perf.converged
        assert ours.last_blocks_uploaded == ref.last_blocks_uploaded
        _same_plans(ref, ours)
        _same_values(ref, ours)
        np.testing.assert_allclose(x.numpy(), _dense_solve(mk, b), atol=3e-4)


def test_incremental_composes_with_bf16_upload(launches):
    """uploadPrecision bfloat16 + incremental: the changed block crosses as
    a bfloat16 delta, the kernel decodes it while it writes, and the
    container equals the reference's."""
    m = ref_testing.poisson_ldu((10, 8, 6))
    b = np.random.default_rng(5).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("pBfIncr", m, b, {"uploadPrecision": "bfloat16", "uploadDeltaTol": 1.0})
    _step(ref, ours, dataclasses.replace(m, diag=m.diag + np.float32(0.5)), b)
    _same_values(ref, ours)
    m2 = dataclasses.replace(m, diag=m.diag + np.float32(0.5 + 1e-3))
    del launches[:]
    x, _, _, _ = _step(ref, ours, m2, b)
    assert ours.last_blocks_bf16 == ref.last_blocks_bf16 == (1, 2)
    assert launches == [(1, 1)]
    _same_values(ref, ours)
    np.testing.assert_array_equal(ours._blocks_mirror[1], ref._blocks_mirror[1])
    np.testing.assert_array_equal(ours._blocks_dev[1].numpy(), ours._blocks_mirror[1])
    np.testing.assert_allclose(x.numpy(), _dense_solve(m2, b), atol=5e-3)


def test_block_update_plans_accumulate_guard():
    """A map whose slots take several entries has no per-block plans."""
    vm = formats.ValueMap(dest=None, out_shape=(4,), unique=False)
    assert formats.block_update_plans(vm, np.arange(4), [2, 2]) is None
    assert ref_formats.block_update_plans(
        ref_formats.ValueMap(dest=None, out_shape=(4,), unique=False),
        np.arange(4), [2, 2]) is None


def _duplicated_faces(dims):
    """A Poisson grid whose cyclic interface couples the first x faces'
    cells again: those entries share their faces' slots."""
    m = ref_testing.poisson_ldu(dims)
    lo, up = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    pick = np.flatnonzero(up - lo == 1)[::3]
    rows = np.concatenate([lo[pick], up[pick]])
    cols = np.concatenate([up[pick], lo[pick]])
    coeffs = -np.linspace(0.1, 0.4, len(rows))  # entries +0.1 .. +0.4: still diagonally dominant
    return dataclasses.replace(m, local_interfaces=(ref_ldu.LocalInterface(
        rows=rows, cols=cols, coeffs=coeffs),))


def test_accumulate_path_matches_reference(launches):
    """Slots that take several entries: no per-block plans on either side;
    the port's slot-sorted plan sums each slot in entry order, the
    reference scatter-adds; both give the same container, and the port
    repeats its bits."""
    m = _duplicated_faces((9, 7, 5))
    b = np.random.default_rng(6).normal(size=m.n).astype(np.float32)
    ref, ours = _pair("accIncr", m, b, {"solver": "GKOBiCGStab", "scaling": 1.5})
    li = m.local_interfaces[0]
    for k, mk in enumerate((dataclasses.replace(m, diag=m.diag + np.float32(0.25)),
                            dataclasses.replace(m, local_interfaces=(dataclasses.replace(
                                li, coeffs=li.coeffs * 0.5),)))):
        del launches[:]
        _step(ref, ours, mk, b)
        assert ours._block_plans is None and ref._block_plans is None
        assert not ours._value_map.unique
        assert launches == [(3, 1)]  # every block, one slot-sorted write
        _same_values(ref, ours)
        again = ours._apply_block_updates(range(3), False)
        assert torch.equal(formats.values_flat(again), formats.values_flat(ours.matrix))


def test_accumulate_plan_sums_in_entry_order():
    vm = formats.ValueMap(dest=torch.tensor([3, 0, 3, 1, 3], dtype=torch.int32),
                          out_shape=(4,), unique=False)
    plan = formats.accumulate_plan(vm, np.array([4, 3, 2, 1, 0]))
    assert plan.slots.tolist() == [0, 1, 3]
    assert plan.seg.tolist() == [0, 1, 2, 5]
    assert plan.src.tolist() == [3, 1, 4, 2, 0]
    vals = torch.tensor([1e8, 1.0, -1e8, 7.0, 0.5])
    out = testing.entries_update(
        vm, formats.Csr(row_ptr=None, cols=None, vals=torch.zeros(4), shape=(4, 4)), vals)
    # slot 3 takes entries 0, 2, 4 in that order: (1e8 + -1e8) + 0.5
    assert out.vals.tolist() == [1.0, 7.0, 0.0, 0.5]


@pytest.mark.parametrize("fmt", ["Csr", "Ell"])
def test_plan_built_before_the_update_solves_with_new_values(fmt):
    """The loop plans built at the first solve take their values from the
    container at each solve: after an update written into a fresh copy
    they solve the new system, and the old container keeps its values."""
    m = ref_testing.poisson_ldu((10, 8, 6))
    b = np.random.default_rng(7).normal(size=m.n).astype(np.float32)
    ours = foam.FoamSolver("pPlan", {"solver": "GKOCG", "tolerance": 1e-8, "relTol": 0.0,
                                     "executor": "cpu", "matrixFormat": fmt})
    ours.solve(_port(m), b)
    kern, old = ours.kern, ours.matrix
    before = _flat(old).copy()
    m2 = dataclasses.replace(m, diag=m.diag * np.float32(1.7))
    x, perf = ours.solve(_port(m2), b)
    assert ours.kern is kern and kern is not None
    np.testing.assert_array_equal(_flat(old), before)
    assert perf.converged
    np.testing.assert_allclose(x.numpy(), _dense_solve(m2, b), atol=2e-4)
