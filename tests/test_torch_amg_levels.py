"""AMG on unstructured meshes against the reference on the CPU: the native
pgm aggregation, hierarchies of Dia, Gdia and Ell levels, the level
smoothers and pgm transfers (their plain twins), the v, w and f cycles on
mixed-format hierarchies, the coarse CG on an Ell coarsest level and the
GKOCG + Multigrid and GKOMultigrid solves through `foam.solve` on every
format, on the same numpy inputs.

Meshes: the kNN-6 graph of 4,096 cells (`testing.knn_ldu`, in the points'
numbering: Ell levels, and Gdia once pgm has coarsened it) and the Poisson
grid (16, 16, 32) renumbered inside each 128-cell run (`shuffled_poisson_ldu`:
a Gdia fine level).  Tolerances: the hierarchies are built by the same
numpy/SciPy steps, so formats, sizes, aggregates and values are equal (Ell
and Gdia values to 1e-6 relative); a level's sweep or residual, and a whole
cycle, agree to 1e-5 of the output's largest entry (float32 sums in another
order: the reference's Ell sum runs over all K slots, its segment_sum in
XLA's order); solves within ±1 iteration with `precision float32`, and from
1 below to 2 above the reference's count with the default bfloat16 smoother
packing (the reference's CPU cycle is float32)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu.core import formats as ref_formats
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import amg_level
from ogl_tpu_torch.precond import amg

ref_amg = importlib.import_module("ogl_tpu.precond.amg")

torch.set_num_threads(2)

KNN_CELLS = 4096
SHUFFLED = (16, 16, 32)
CYCLE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


_MESHES: dict = {}


def _mesh(name):
    """The LDU system of a mesh (built once per process)."""
    if name not in _MESHES:
        _MESHES[name] = (testing.knn_ldu(KNN_CELLS)[0] if name == "knn"
                         else testing.shuffled_poisson_ldu(SHUFFLED))
    return _MESHES[name]


def _coo(name):
    c = ldu.ldu_to_coo_host(_mesh(name), dtype=np.float32)
    return c, ref_formats.Coo(rows=np.asarray(c.rows), cols=np.asarray(c.cols),
                              vals=np.asarray(c.vals), shape=tuple(c.shape))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


# ---- aggregation and hierarchy -------------------------------------------------


@pytest.mark.parametrize("mesh", ["knn", "shuffled"])
def test_native_pgm_aggregate_equals_the_loop_and_the_reference(mesh):
    c, _ = _coo(mesh)
    a = sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows), np.asarray(c.cols))),
                      shape=c.shape)
    got = amg.pgm_aggregate(a)
    np.testing.assert_array_equal(got, amg.pgm_aggregate_plain(a))
    np.testing.assert_array_equal(got, ref_amg.pgm_aggregate(a))
    assert got.max() + 1 < a.shape[0] // 1.5  # pairs, mostly


def _same_operator(p, r):
    """The port's level operator equals the reference's: format, structure
    and values."""
    kind = type(r).__name__
    assert type(p).__name__ == kind
    if kind == "Dia":
        assert p.offsets == tuple(r.offsets)
        _close(p.data.numpy(), r.data, 1e-6)
    elif kind == "Gdia":
        assert p.plane_offsets == tuple(r.plane_offsets)
        np.testing.assert_array_equal(p.lidx.numpy(), np.asarray(r.lidx))
        _close(p.vals.numpy(), r.vals, 1e-6)
    else:  # the reference's Ell is row-major (n, K), the port's slot-major (K, n)
        np.testing.assert_array_equal(p.cols.numpy(), np.asarray(r.cols).T)
        _close(p.vals.numpy(), np.asarray(r.vals).T, 1e-6)


HIERARCHIES = {("knn", "auto"): ["Ell", "Ell", "Ell"],
               ("knn", "pgm"): ["Ell", "Ell", "Ell", "Gdia", "Gdia"],
               ("shuffled", "auto"): ["Gdia", "Ell", "Dia"],
               ("shuffled", "pgm"): ["Gdia"] * 5}


@pytest.mark.parametrize("mesh,aggregation", list(HIERARCHIES), ids=str)
def test_build_hierarchy_matches_reference(mesh, aggregation):
    c, rc = _coo(mesh)
    ref = ref_amg.build_hierarchy(rc, 9, 10, aggregation, width=8)
    port = amg.build_hierarchy(c, 9, 10, aggregation, width=8, smoother_dtype=torch.float32)
    assert [type(lv.mat).__name__ for lv in port] == HIERARCHIES[mesh, aggregation]
    assert [(lv.n, lv.nc) for lv in port] == [(lv.n, lv.nc) for lv in ref]
    for p, r in zip(port, ref):
        _same_operator(p.mat, r.mat)
        assert (p.natural, p.grid, p.width) == (r.natural, r.grid, r.width)
        _close(p.inv_diag.numpy(), r.inv_diag, 1e-6)
        assert (p.agg is None) == (r.agg is None) == (p.transfer is None)
        if p.agg is not None:
            np.testing.assert_array_equal(p.agg.numpy(), np.asarray(r.agg))
        assert (p.coarse_inv is None) == (r.coarse_inv is None)
        if p.coarse_inv is not None:
            _close(p.coarse_inv.numpy(), r.coarse_inv, 1e-6)
        if p.nc:  # the smoother's values in the format's own layout
            torch.testing.assert_close(p.data_s, p.kern.pack_values(p.mat), rtol=0, atol=0)


def test_bf16_packing_on_every_format():
    c, _ = _coo("knn")
    levels = amg.build_hierarchy(c, 9, 10, "pgm", width=8)
    assert {type(lv.mat).__name__ for lv in levels[:-1]} == {"Ell", "Gdia"}
    for lv in levels[:-1]:
        assert lv.data_s.dtype == torch.bfloat16
        assert lv.data_s.shape == lv.mat.vals.shape
        torch.testing.assert_close(lv.data_s, lv.mat.vals.to(torch.bfloat16), rtol=0, atol=0)


# ---- the level operations against the reference's ------------------------------


def _level_of(mesh, aggregation, kind):
    """The first level of format `kind` of the reference's hierarchy, and the
    port's level carried across from it (float32 packing)."""
    _, rc = _coo(mesh)
    ref = ref_amg.build_hierarchy(rc, 9, 10, aggregation, width=8)
    i = next(i for i, lv in enumerate(ref) if type(lv.mat).__name__ == kind and lv.nc)
    return ref[i], interop.amg_levels_from_reference(ref)[i]


@pytest.mark.parametrize("kind,mesh,aggregation", [("Ell", "knn", "auto"),
                                                   ("Gdia", "shuffled", "auto"),
                                                   ("Gdia", "knn", "pgm")], ids=str)
def test_level_smoother_twins_match_reference(kind, mesh, aggregation):
    ref_lv, lv = _level_of(mesh, aggregation, kind)
    smoother = {"Ell": amg_level.EllSmoother, "Gdia": amg_level.GdiaSmoother}[kind]
    assert type(lv.kern) is smoother
    rng = np.random.default_rng(5)
    x, b = (rng.normal(size=lv.n).astype(np.float32) for _ in range(2))
    want_r = np.asarray(jnp.asarray(b) - ref_amg._apply_mat(ref_lv, jnp.asarray(x)))
    want_s = np.asarray(ref_amg._smooth(ref_lv, jnp.asarray(x), jnp.asarray(b), 0.9, 1))
    kernels.reset_launches()
    got_r = lv.kern.resid(lv.data_s, torch.tensor(x), torch.tensor(b))
    got_s = lv.kern.sweep(lv.data_s, torch.tensor(x), torch.tensor(b), lv.inv_diag, 0.9)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: the twins
    _close(got_r.numpy(), want_r, CYCLE_RTOL)
    _close(got_s.numpy(), want_s, CYCLE_RTOL)


@pytest.mark.parametrize("kind", ["Ell", "Gdia"])
def test_bf16_smoother_widens_the_packed_values(kind):
    """The bfloat16 twin equals the float32 twin on the values rounded to
    bfloat16 and widened again: the packing is the only difference."""
    mesh = "knn" if kind == "Ell" else "shuffled"
    c, _ = _coo(mesh)
    lv = amg.build_hierarchy(c, 9, 10, "auto", width=8)[0]
    assert type(lv.mat).__name__ == kind and lv.data_s.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    x, b = (torch.tensor(rng.normal(size=lv.n).astype(np.float32)) for _ in range(2))
    widened = lv.data_s.to(torch.float32)
    torch.testing.assert_close(lv.kern.sweep(lv.data_s, x, b, lv.inv_diag, 0.9),
                               lv.kern.sweep(widened, x, b, lv.inv_diag, 0.9), rtol=0, atol=0)
    torch.testing.assert_close(lv.kern.resid(lv.data_s, x, b), lv.kern.resid(widened, x, b),
                               rtol=0, atol=0)


def test_pgm_transfer_twins_match_segment_sum_and_take():
    rng = np.random.default_rng(7)
    n = 3001
    agg = np.concatenate([np.arange(1000), rng.integers(0, 1000, n - 1000)])
    rng.shuffle(agg)  # aggregates of 1 to ~8 rows, every one non-empty
    tr = amg_level.PgmTransfer(agg, 1000, "cpu")
    starts, members = tr.starts.numpy(), tr.members.numpy()
    for c in (0, 17, 999):  # members ascending, grouped by aggregate
        rows = members[starts[c]:starts[c + 1]]
        np.testing.assert_array_equal(rows, np.flatnonzero(agg == c))
    r = rng.normal(size=n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    ec = rng.normal(size=1000).astype(np.float32)
    want = jax.ops.segment_sum(jnp.asarray(r), jnp.asarray(agg.astype(np.int32)),
                                       num_segments=1000)
    _close(tr.restrict(torch.tensor(r)).numpy(), want, 1e-6)
    exact = np.zeros(1000, np.float64)
    np.add.at(exact, agg, r.astype(np.float64))
    seq = np.zeros(1000, np.float32)  # the kernel's order: members ascending, from 0
    for i in np.argsort(agg, kind="stable"):
        seq[agg[i]] = np.float32(seq[agg[i]] + r[i])
    np.testing.assert_array_equal(tr.restrict(torch.tensor(r)).numpy(), seq)
    _close(seq, exact, 1e-6)
    got = tr.prolong_add(torch.tensor(x), torch.tensor(ec)).numpy()
    np.testing.assert_array_equal(got, x + np.asarray(jnp.take(jnp.asarray(ec),
                                                               jnp.asarray(agg), axis=0)))


# ---- cycles -----------------------------------------------------------------------


@pytest.mark.parametrize("cycle", ["v", "w", "f"])
@pytest.mark.parametrize("mesh,aggregation", [("knn", "pgm"), ("shuffled", "auto")], ids=str)
def test_cycle_matches_reference_on_mixed_levels(mesh, aggregation, cycle):
    """The port's cycle on the reference's own hierarchy (carried across by
    interop, float32 packing) against the reference's cycle."""
    _, rc = _coo(mesh)
    # knn pgm: three Ell levels over a Gdia coarsest; shuffled: Gdia, Ell, Dia
    op = ref_amg.amg(rc, max_levels=3, cycle=cycle, aggregation=aggregation, width=8)
    assert len({type(lv.mat).__name__ for lv in op.state}) > 1
    port = amg.cycle_op(interop.amg_levels_from_reference(op.state), cycle)
    r = np.random.default_rng(3).normal(size=rc.shape[0]).astype(np.float32)
    kernels.reset_launches()
    got = port(torch.tensor(r)).numpy()
    assert sum(kernels.launches.values()) == 0
    _close(got, op(jnp.asarray(r)), CYCLE_RTOL)


def test_coarse_cg_on_an_ell_coarsest_level():
    c, rc = _coo("knn")
    # two smoothing levels: the coarsest is the 64-row Ell level
    op = ref_amg.amg(rc, max_levels=2, aggregation="auto", width=8, coarse_solver="cg")
    port = amg.amg(c, max_levels=2, aggregation="auto", width=8, coarse_solver="cg",
                   smoother_dtype=torch.float32)
    coarsest = port.state[-1]
    assert isinstance(coarsest.mat, formats.Ell) and coarsest.coarse_inv is None
    assert coarsest.matvec is not None
    r = np.random.default_rng(4).normal(size=rc.shape[0]).astype(np.float32)
    _close(port(torch.tensor(r)).numpy(), op(jnp.asarray(r)), CYCLE_RTOL)


# ---- the solves through foam.solve ----------------------------------------------

_REF_ITERS: dict = {}


def _ref_iters(mesh, solver, aggregation):
    """The reference's iterations on `mesh` (one solve per process: the
    outer matrix format does not change the count, the preconditioner is
    built from the same COO)."""
    key = (mesh, solver, aggregation)
    if key not in _REF_ITERS:
        m = _mesh(mesh)
        fmt = "Gdia" if mesh == "shuffled" else "Csr"
        _, perf = ref_foam.solve(f"ref_{mesh}_{solver}_{aggregation}", m, _rhs(m.n),
                                 _controls(solver, fmt, aggregation))
        assert perf.converged
        _REF_ITERS[key] = perf.n_iterations
    return _REF_ITERS[key]


def _controls(solver, fmt, aggregation="auto", precision=None):
    pc = {"preconditioner": "Multigrid" if solver == "GKOCG" else "none",
          "aggregation": aggregation}
    if precision is not None:
        pc["precision"] = precision
    return {"executor": "cpu", "solver": solver, "matrixFormat": fmt, "tolerance": 1e-6,
            "relTol": 0, "adaptMinIter": False, "preconditioner": pc}


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


SOLVES = [("GKOCG", fmt, "knn") for fmt in ("Csr", "Ell", "Sell", "Xell")] + [
    ("GKOCG", "Gdia", "shuffled"), ("GKOMultigrid", "Ell", "knn"),
    ("GKOMultigrid", "Xell", "knn")]
ROUTES = {"Csr": "cg", "Ell": "cg", "Sell": "cg", "Gdia": "cg_fused", "Xell": "cg_fused"}


# the default bfloat16 packing on one solve of each route
SOLVES = [(*s, "float32") for s in SOLVES] + [
    ("GKOCG", "Csr", "knn", "bfloat16 packing"), ("GKOCG", "Gdia", "shuffled", "bfloat16 packing"),
    ("GKOMultigrid", "Ell", "knn", "bfloat16 packing")]


@pytest.mark.parametrize("solver,fmt,mesh,precision", SOLVES, ids=str)
def test_amg_solve_on_every_format_matches_reference(solver, fmt, mesh, precision):
    m = _mesh(mesh)
    b = _rhs(m.n)
    want = _ref_iters(mesh, solver, "auto")
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, _controls(
        solver, fmt, precision="float32" if precision == "float32" else None))
    assert sum(kernels.launches.values()) == 0
    slv = registry.global_registry.get("p_solver")
    assert slv.route == (ROUTES[fmt] if solver == "GKOCG" else "ir")
    assert perf.solver_name == f"{solver}_{fmt}" and perf.converged
    assert perf.final_residual < 1e-6
    if precision == "float32":
        assert abs(perf.n_iterations - want) <= 1
    else:
        assert want - 1 <= perf.n_iterations <= want + 2
    c = ldu.ldu_to_coo_host(m, dtype=np.float64)
    a = sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows), np.asarray(c.cols))),
                      shape=c.shape)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-4
