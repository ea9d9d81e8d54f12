"""The AMG slice of the port against the reference on the CPU: hierarchy,
transfers, one cycle, and the GKOCG + Multigrid and GKOMultigrid solves
through `foam.solve`, on the same COO / LDU inputs.

Both packages build the hierarchy with the same numpy/SciPy steps, so
level sizes, offsets and aggregates must be equal and the values agree to
1e-6 relative.  One cycle: rtol 5e-5 of the output's max (float32 sums in
another order).  Solves: ±1 iteration (a stop decision can flip on one
ulp) and atol 1e-4 on the solution with float32 smoother packing
(`precision float32`); with the default bfloat16 packing the port may take
at most 2 iterations more than the reference, whose CPU cycle is float32."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core import formats
from ogl_tpu_torch.kernels import amg_level
from ogl_tpu_torch.precond import amg, build

ref_amg = importlib.import_module("ogl_tpu.precond.amg")

torch.set_num_threads(2)

DIMS_3D = (32, 16, 8)
DIMS_2D = (48, 48)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _ref_coo(dims):
    return ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(dims), dtype=np.float32)


def _port_coo(c):
    return formats.Coo(rows=np.asarray(c.rows), cols=np.asarray(c.cols),
                       vals=np.asarray(c.vals), shape=tuple(c.shape))


def _permuted(dims, seed=0):
    """The Poisson COO of `dims` under a random symmetric renumbering: an
    operator with far more than 64 distinct diagonals."""
    c = _ref_coo(dims)
    n = c.shape[0]
    inv = np.argsort(np.random.default_rng(seed).permutation(n))
    rows, cols = inv[np.asarray(c.rows)], inv[np.asarray(c.cols)]
    order = np.lexsort((cols, rows))
    return ref_formats.Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                           vals=np.asarray(c.vals)[order], shape=c.shape)


def _close_rel(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


# ---- hierarchy ------------------------------------------------------------

HIERARCHIES = [("auto", DIMS_3D), ("grid", (9, 6, 5)), ("natural", DIMS_3D),
               ("natural", (37, 5)), ("pgm", (16, 16))]


@pytest.mark.parametrize("aggregation,dims", HIERARCHIES, ids=str)
def test_build_hierarchy_matches_reference(aggregation, dims):
    coo = _ref_coo(dims)
    ref = ref_amg.build_hierarchy(coo, 9, 10, aggregation, width=8)
    port = amg.build_hierarchy(_port_coo(coo), 9, 10, aggregation, width=8,
                               smoother_dtype=torch.float32)
    assert [lv.n for lv in port] == [lv.n for lv in ref]
    assert len(port) >= 3  # the cycle has levels to recurse through
    for p, r in zip(port, ref):
        assert (p.nc, p.natural, p.grid, p.width) == (r.nc, r.natural, r.grid, r.width)
        assert p.mat.offsets == tuple(r.mat.offsets)
        _close_rel(p.mat.data.numpy(), r.mat.data)
        _close_rel(p.inv_diag.numpy(), r.inv_diag)
        assert (p.agg is None) == (r.agg is None)
        if p.agg is not None:
            np.testing.assert_array_equal(p.agg.numpy(), np.asarray(r.agg))
            # a pgm level on Dia transfers through the pgm kernels too (no
            # index_add_, whose float atomics on the card reorder the sums)
            assert isinstance(p.transfer, amg_level.PgmTransfer)
        assert (p.coarse_inv is None) == (r.coarse_inv is None)
        if p.coarse_inv is not None:
            _close_rel(p.coarse_inv.numpy(), r.coarse_inv)
        if p.nc:  # smoother coefficients packed as asked
            assert p.data_s.dtype == torch.float32
            torch.testing.assert_close(p.data_s, p.mat.data, rtol=0, atol=0)


def test_bf16_packing_and_coarse_cg_hierarchy():
    coo = _port_coo(_ref_coo(DIMS_3D))
    levels = amg.build_hierarchy(coo, 9, 10, "auto", coarse_solver="cg")
    assert levels[-1].coarse_inv is None and levels[-1].data_s is None
    for lv in levels[:-1]:
        assert lv.data_s.dtype == torch.bfloat16
        torch.testing.assert_close(lv.data_s, lv.mat.data.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("dims,want", [((16, 16), "Gdia"), ((64, 64), "Ell")], ids=str)
def test_wide_level_raises_naming_its_format(dims, want):
    """pgm on a renumbered operator: the reference packs the level as Gdia
    or, past Gdia's plane budget, as Ell.  The port once raised there, naming
    the format and A11 (done); it now picks the reference's format, Gdia or
    Ell, on every level, with the reference's sizes and aggregates."""
    coo = _permuted(dims)
    ref = ref_amg.build_hierarchy(coo, 9, 10, "pgm", width=8)
    assert type(ref[0].mat).__name__ == want
    port = amg.build_hierarchy(_port_coo(coo), 9, 10, "pgm", width=8)
    assert [type(lv.mat).__name__ for lv in port] == [type(lv.mat).__name__ for lv in ref]
    assert [(lv.n, lv.nc) for lv in port] == [(lv.n, lv.nc) for lv in ref]
    for p, r in zip(port[:-1], ref[:-1]):
        np.testing.assert_array_equal(p.agg.numpy(), np.asarray(r.agg))


@pytest.mark.parametrize("solver", ["GKOCG", "GKOMultigrid"])
def test_pgm_solve_on_ell_matches_reference(solver):
    """pgm aggregation (the native runtime) on the kNN-6 mesh as Ell: every
    level transfers through the pgm transfer kernels' twins, and the solve
    takes the reference's iterations ±1 (float32 smoother packing)."""
    m = testing.knn_ldu(4096)[0]
    b = _rhs(m.n)
    pc = {"preconditioner": "Multigrid" if solver == "GKOCG" else "none",
          "aggregation": "pgm", "precision": "float32"}
    ctl = {"executor": "cpu", "solver": solver, "matrixFormat": "Ell", "tolerance": 1e-6,
           "relTol": 0, "adaptMinIter": False, "preconditioner": pc}
    _, perf_ref = ref_foam.solve("p", m, b, ctl)
    _, perf = foam.solve("p", m, b, ctl)
    levels = registry.global_registry.get("p_solver")._precond_op.state
    assert all(lv.transfer is not None for lv in levels[:-1])
    assert {type(lv.mat).__name__ for lv in levels} == {"Ell", "Gdia"}
    assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1


def test_pgm_aggregate_and_grid_dims_match_reference():
    import scipy.sparse as sp

    c = _permuted((12, 10))
    a = sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows), np.asarray(c.cols))),
                      shape=c.shape)
    np.testing.assert_array_equal(amg.pgm_aggregate(a), ref_amg.pgm_aggregate(a))
    for offs, n in [([0, 1, -1, 12, -12, 96, -96], 480), ([0, 1, -1, 16, -16], 144),
                    ([0, 1, -1], 37), ([0, 1, -1, 12], 60), ([0, 2, -2], 10), ([0], 8)]:
        assert amg.grid_dims_of(offs, n) == ref_amg.grid_dims_of(offs, n)
    for dims in [(1, 4, 6), (3, 4, 5), (1, 1, 5)]:
        agg, cd = amg.grid_aggregate(dims)
        ragg, rcd = ref_amg.grid_aggregate(dims)
        np.testing.assert_array_equal(agg, ragg)
        assert cd == rcd


# ---- transfers ------------------------------------------------------------

TRANSFERS = [("grid", (3, 4, 5)), ("grid", (1, 6, 7)), ("natural", 37), ("pgm", 64)]


@pytest.mark.parametrize("kind,size", TRANSFERS, ids=str)
def test_transfers_match_reference(kind, size):
    rng = np.random.default_rng(1)
    if kind == "grid":
        agg, cdims = amg.grid_aggregate(size)
        n, nc = int(np.prod(size)), int(np.prod(cdims))
        kw = dict(grid=tuple(size) + tuple(cdims))
    elif kind == "natural":
        n, nc = size, -(-size // 4)
        kw = dict(natural=True, width=4)
    else:
        n = size
        agg = rng.permutation(n) // 3
        nc = int(agg.max()) + 1
        kw = dict(agg=jnp.asarray(agg.astype(np.int32)))
    ref_lv = ref_amg._Level(mat=None, inv_diag=None, n=n, nc=nc, **{"agg": None, **kw})
    port_kw = {k: (np.asarray(v) if k == "agg" else v) for k, v in kw.items()}
    lv = amg.make_level(formats.Dia(data=torch.zeros((0, n)), offsets=(), shape=(n, n)),
                        np.ones(n, np.float32), nc, **port_kw)
    u = rng.normal(size=n).astype(np.float32)
    v = rng.normal(size=nc).astype(np.float32)
    _close_rel(amg._restrict(lv, torch.tensor(u)).numpy(),
               ref_amg._restrict(ref_lv, jnp.asarray(u)), rtol=1e-6)
    _close_rel(amg._prolong(lv, torch.tensor(v)).numpy(),
               ref_amg._prolong(ref_lv, jnp.asarray(v)), rtol=0)


def test_cg_fixed_iters_matches_reference():
    coo = _ref_coo((12, 10))
    dense = np.zeros(coo.shape, np.float32)
    np.add.at(dense, (np.asarray(coo.rows), np.asarray(coo.cols)), np.asarray(coo.vals))
    b = np.random.default_rng(2).normal(size=coo.shape[0]).astype(np.float32)
    a_t, a_j = torch.tensor(dense), jnp.asarray(dense)
    for iters in (1, 4, 40):
        got = amg.cg_fixed_iters(lambda v: a_t @ v, torch.tensor(b), iters)
        want = ref_amg.cg_fixed_iters(lambda v: a_j @ v, jnp.asarray(b), iters)
        _close_rel(got.numpy(), want, rtol=5e-5)


# ---- one cycle ------------------------------------------------------------


def _interpret_plan(mat, inv_diag):
    """The reference's fused framed plan in Pallas interpret mode (as its
    own tests build it)."""
    from ogl_tpu.kernels.fused import CgKernels

    if not isinstance(mat, ref_formats.Dia) or not mat.offsets:
        return None, None, None
    try:
        plan = CgKernels(mat.shape[0], mat.offsets, tile=16, interpret=True)
    except ValueError:
        return None, None, None
    return plan, plan.pack_values(mat), plan.frame(inv_diag)


@pytest.mark.parametrize("framed", [False, True], ids=["flat", "framed"])
@pytest.mark.parametrize("cycle", ["v", "w", "f"])
def test_cycle_matches_reference(cycle, framed, monkeypatch):
    """The port's cycle on the reference's own hierarchy (float32 packing)
    against the reference's flat XLA cycle, and against its framed cycle
    of Pallas ksweep/kresid in interpret mode."""
    dims = (128, 8) if framed else DIMS_3D
    coo = _ref_coo(dims)
    if framed:
        monkeypatch.setattr(ref_amg, "_fused_plan", _interpret_plan)
    op = ref_amg.amg(coo, cycle=cycle, aggregation="natural", width=4)
    assert any(lv.plan is not None for lv in op.state) == framed
    port = amg.cycle_op(interop.amg_levels_from_reference(op.state), cycle)
    r = np.random.default_rng(3).normal(size=coo.shape[0]).astype(np.float32)
    want = np.asarray(op(jnp.asarray(r)))
    kernels.reset_launches()
    got = port(torch.tensor(r)).numpy()
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    _close_rel(got, want, rtol=5e-5)


def test_independent_hierarchies_give_the_same_cycle():
    coo = _ref_coo(DIMS_3D)
    ref = ref_amg.amg(coo, aggregation="auto", width=8)
    port = amg.amg(_port_coo(coo), aggregation="auto", width=8,
                   smoother_dtype=torch.float32)
    r = np.random.default_rng(4).normal(size=coo.shape[0]).astype(np.float32)
    _close_rel(port(torch.tensor(r)).numpy(), ref(jnp.asarray(r)), rtol=5e-5)


# ---- the solves through foam.solve ------------------------------------------

SOLVES = {
    "GKOCG+Multigrid": {"solver": "GKOCG", "preconditioner": "Multigrid"},
    "GKOMultigrid": {"solver": "GKOMultigrid"},
    "GKOCG+Multigrid-w": {"solver": "GKOCG",
                          "preconditioner": {"preconditioner": "Multigrid", "cycle": "w"}},
    "GKOCG+Multigrid-cg-coarse": {"solver": "GKOCG", "preconditioner": {
        "preconditioner": "Multigrid", "coarseSolver": "cg"}},
    "GKOCG+Multigrid-general": {"solver": "GKOCG", "preconditioner": "Multigrid",
                                "fusedCG": False},
}


def _controls(name, precision=None, **extra):
    ctl = {"executor": "cpu", "matrixFormat": "Dia", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, **SOLVES[name], **extra}
    if precision is not None:  # smoother packing of the port (precision key)
        pc = ctl.get("preconditioner", "none")
        pc = dict(pc) if isinstance(pc, dict) else {"preconditioner": pc}
        ctl["preconditioner"] = {**pc, "precision": precision}
    return ctl


def _port_ldu(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper)


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("dims", [DIMS_3D, DIMS_2D], ids=str)
@pytest.mark.parametrize("name", list(SOLVES))
def test_amg_solve_matches_reference(name, dims):
    m = ref_testing.poisson_ldu(dims)
    b = _rhs(m.n)
    x_ref, perf_ref = ref_foam.solve("p", m, b, _controls(name))
    kernels.reset_launches()
    x, perf = foam.solve("p", _port_ldu(m), b, _controls(name, precision="float32"))
    assert sum(kernels.launches.values()) == 0
    assert perf.solver_name == perf_ref.solver_name == f"{SOLVES[name]['solver']}_Dia"
    assert perf.converged and perf_ref.converged and perf.final_residual < 1e-6
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(perf.initial_residual, perf_ref.initial_residual, rtol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)


@pytest.mark.parametrize("dims", [DIMS_3D, DIMS_2D], ids=str)
@pytest.mark.parametrize("name", ["GKOCG+Multigrid", "GKOMultigrid"])
def test_bf16_packing_within_two_iterations(name, dims):
    m = ref_testing.poisson_ldu(dims)
    b = _rhs(m.n)
    _, perf_ref = ref_foam.solve("p", m, b, _controls(name))
    x, perf = foam.solve("p", _port_ldu(m), b, _controls(name))
    slv = registry.global_registry.get("p_solver")
    assert all(lv.data_s.dtype == torch.bfloat16 for lv in slv._precond_op.state[:-1])
    assert perf.converged and perf.final_residual < 1e-6
    assert perf.n_iterations <= perf_ref.n_iterations + 2
    a = ref_testing.poisson_dense(dims)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


def test_amg_cuts_iterations():
    m = _port_ldu(ref_testing.poisson_ldu(DIMS_3D))
    b = _rhs(m.n)
    _, plain = foam.solve("p", m, b, {"executor": "cpu", "tolerance": 1e-6, "relTol": 0})
    _, mg = foam.solve("q", m, b, {"executor": "cpu", "tolerance": 1e-6, "relTol": 0,
                                   "preconditioner": "Multigrid"})
    assert mg.n_iterations < plain.n_iterations / 2


@pytest.mark.parametrize("name", ["GKOCG+Multigrid", "GKOMultigrid"])
def test_steady_state_steps_rebuild_the_hierarchy(name):
    """caching 0: each step that changes the coefficients rebuilds the
    hierarchy from the CURRENT values; iterations track the reference."""
    m = ref_testing.poisson_ldu(DIMS_3D)
    b = _rhs(m.n)
    ctl = _controls(name, precision="float32")
    built = []
    for step in range(3):
        x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
        x, perf = foam.solve("p", _port_ldu(m), b, ctl)
        slv = registry.global_registry.get("p_solver")
        fine = slv._precond_op.state[0]
        np.testing.assert_allclose(fine.inv_diag.numpy(), 1.0 / np.asarray(m.diag, np.float32),
                                   rtol=1e-6)
        built.append(slv._precond_op)
        assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
        if step:
            assert slv.last_blocks_uploaded == (1, 2)
        m = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
        b = b * 1.01 + 0.1
    assert len({id(op) for op in built}) == 3
    # an unchanged operator keeps the hierarchy
    foam.solve("p", _port_ldu(dataclasses.replace(m, diag=np.asarray(m.diag) / 1.01)),
               b, ctl)
    assert registry.global_registry.get("p_solver")._precond_op is built[-1]


def test_caching_ttl_keeps_the_hierarchy_for_changed_operators():
    """caching 1: a changed operator reuses the hierarchy once, then
    rebuilds (the TTL of Preconditioner.H:353-431), as in the reference."""
    m = ref_testing.poisson_ldu(DIMS_3D)
    b = _rhs(m.n)
    ctl = _controls("GKOCG+Multigrid", precision="float32")
    ctl["preconditioner"] = {**ctl["preconditioner"], "caching": 1}
    ops = []
    for _ in range(3):
        _, perf_ref = ref_foam.solve("p", m, b, ctl)
        _, perf = foam.solve("p", _port_ldu(m), b, ctl)
        ops.append(registry.global_registry.get("p_solver")._precond_op)
        assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1 and perf.converged
        m = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.05)
    assert ops[0] is ops[1] and ops[2] is not ops[1]


def test_gkomultigrid_class_equals_functional_entry():
    m = _port_ldu(ref_testing.poisson_ldu(DIMS_3D))
    b = _rhs(m.n)
    x1, perf1 = foam.solve("p", m, b, _controls("GKOMultigrid"))
    registry.global_registry.clear()
    x2, perf2 = foam.GKOMultigrid("p", _controls("GKOMultigrid")).solve(m, b)
    assert perf1 == perf2
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)


def test_verbose_logs_the_multigrid_build(capsys):
    m = _port_ldu(ref_testing.poisson_ldu(DIMS_3D))
    foam.solve("p", m, _rhs(m.n), _controls("GKOCG+Multigrid", verbose=1))
    out = capsys.readouterr().out
    assert "Generate preconditioner Multigrid MaxLevels 9 MinCoarseRows 10 ZeroGuess 1 " \
           "Cycle v" in out
    assert "generate_preconditioner" in out


@pytest.mark.parametrize("controls,item", [
    ({"solver": "GKOIR"}, "A9"),
    ({"preconditioner": {"preconditioner": "Multigrid", "precision": "bfloat16"}}, "A10"),
    ({"solver": "GKOMultigrid",
      "preconditioner": {"preconditioner": "ILU", "precision": "bfloat16"}}, "A10"),
], ids=str)
def test_unported_amg_controls_raise(controls, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        foam.FoamSolver("p", {"executor": "cpu", **controls})
    if "precision" in str(controls):  # the factory refuses it as well
        with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
            build(PrecondConfig(name="Multigrid", value_precision="bfloat16"),
                  _port_coo(_ref_coo((8, 8))), "cpu")
