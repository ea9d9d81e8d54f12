"""Repairs of the port's own faults (ROADMAP.md §C): the interop bridge's
non-Dia AMG levels (once refused, naming A11; now carried across), and the
host-clock branch of `roofline.measure_chained` under a stalled chain."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu import testing as ref_testing
from ogl_tpu_torch import interop, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import roofline
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv
from ogl_tpu_torch.precond import amg

ref_amg = importlib.import_module("ogl_tpu.precond.amg")

torch.set_num_threads(2)


def _permuted(dims, seed=0):
    """The Poisson COO of `dims` under a random symmetric renumbering: its
    pgm levels have far more than 64 distinct diagonals."""
    c = ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(dims), dtype=np.float32)
    inv = np.argsort(np.random.default_rng(seed).permutation(c.shape[0]))
    rows, cols = inv[np.asarray(c.rows)], inv[np.asarray(c.cols)]
    order = np.lexsort((cols, rows))
    return ref_formats.Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                           vals=np.asarray(c.vals)[order], shape=c.shape)


@pytest.mark.parametrize("dims,kind,item", [((16, 16), "Gdia", "A11"), ((64, 64), "Ell", "A11")],
                         ids=str)
def test_interop_names_the_open_item_for_a_non_dia_level(dims, kind, item):
    """AMG on Gdia or Ell levels (A11, done) once made the bridge raise,
    naming the item: it now carries the levels across, and the port's cycle
    on them equals the reference's `amg` cycle within 1e-5 of the output's
    largest entry (float32 sums in another order)."""
    op = ref_amg.amg(_permuted(dims), aggregation="pgm", width=8)
    assert type(op.state[0].mat).__name__ == kind
    levels = interop.amg_levels_from_reference(op.state)
    assert [type(lv.mat).__name__ for lv in levels] == [type(lv.mat).__name__ for lv in op.state]
    r = np.random.default_rng(1).normal(size=levels[0].n).astype(np.float32)
    want = np.asarray(op(jnp.asarray(r)))
    got = amg.cycle_op(levels)(torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_measure_chained_survives_a_stalled_chain(monkeypatch):
    """One chain that loses 20 ms to another process used to make the
    single slope negative, clamped to 1e-12 s: the seconds stayed positive
    and the next measurement came out 10⁷ times slower.  The least of
    HOST_REPEATS timings of each length keeps the slope of the others."""
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(testing.poisson_ldu((24, 24)),
                                                 dtype=np.float32))
    plan = DiaPlan.of(mat)

    def mv(v, data):
        return dia_spmv(plan, data, v)

    x = torch.ones(mat.shape[0])
    real, calls = roofline._host_seconds, itertools.count()

    def stalled(*args):  # the first timing, of the iters-long chain, stalls
        return real(*args) + (20e-3 if next(calls) == 0 else 0.0)

    monkeypatch.setattr(roofline, "_host_seconds", stalled)
    r = roofline.measure_chained(mv, x, iters=64, operands=(mat.data,))
    monkeypatch.setattr(roofline, "_host_seconds", real)
    r2 = roofline.measure_chained(mv, x, iters=256, operands=(mat.data,))
    assert r.seconds > 1e-9 and r2.seconds < 20 * r.seconds


def test_measure_chained_without_a_positive_slope_takes_the_longer_chain(monkeypatch):
    """A slope that is not positive in every repeat falls back to the longer
    chain's time per apply, never to the 1e-12 s clamp."""
    monkeypatch.setattr(roofline, "_host_seconds", lambda fn, x0, k, ops: 0.5)
    r = roofline.measure_chained(lambda v: v, torch.ones(4), iters=10)
    assert r.seconds == 0.5 / 20
