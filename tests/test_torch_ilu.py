"""The port's ILU family (ILU, ILUT, IRILU, IC, ICT; precond/ilu.py over
kernels/tri_solve.py) against the reference (ogl_tpu/precond/ilu.py): the
host factorisations, `factor_depth`, the apply of each name with 8 sweeps,
`triSolveSweeps 3` and `triSolve exact` (fed the reference's factors and
its own), exact mode against SciPy's triangular solves, the level twin
against the sweep twin run to depth, the dispatch and the routes, and
`foam.solve` with each name against `ogl_tpu.foam.solve`.  The kernels'
bodies run on the CPU in tests/test_torch_tri_emu.py, the kernels on the
card in tests/test_torch_cuda.py."""

import dataclasses
import importlib
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import PrecondConfig as RefPrecondConfig
from ogl_tpu.core.formats import Coo as RefCoo
from ogl_tpu.precond import build as ref_build
from ogl_tpu_torch import foam, interop, kernels, native, registry, testing
from ogl_tpu_torch.config import PrecondConfig, parse_controls
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.foam import solver as solver_mod
from ogl_tpu_torch.kernels import _build, tri_solve
from ogl_tpu_torch.precond import build

ilu = importlib.import_module("ogl_tpu_torch.precond.ilu")
ref_ilu = importlib.import_module("ogl_tpu.precond.ilu")
cg_mod = importlib.import_module("ogl_tpu_torch.solve.cg")

torch.set_num_threads(2)

TOL = 1e-6
NAMES = ("ILU", "ILUT", "IRILU", "IC", "ICT")


@pytest.fixture(autouse=True)
def _fresh_registries():
    registry.global_registry.clear()
    ref_registry.global_registry.clear()
    yield
    registry.global_registry.clear()
    ref_registry.global_registry.clear()


def _port(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper,
                                   getattr(m, "lower", None))


def _aniso(dims, ratio=1000.0):
    """tests/test_trisolve_exact.py's stiff anisotropic diffusion."""
    m = ref_testing.poisson_ldu(dims)
    la, ua = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    upper = np.where((ua - la) == 1, m.upper * ratio, m.upper)
    diag = np.ones(m.n)
    np.add.at(diag, la, np.abs(upper))
    np.add.at(diag, ua, np.abs(upper))
    return dataclasses.replace(m, upper=upper.astype(m.upper.dtype),
                               diag=diag.astype(m.diag.dtype))


def _system(kind):
    """A reference LDU system of one kind (the kNN mesh: the port's)."""
    if kind == "p2":
        return ref_testing.poisson_ldu((12, 10))
    if kind == "p3":
        return ref_testing.poisson_ldu((6, 5, 3))
    if kind == "cd":
        return ref_testing.convection_diffusion_ldu((6, 5, 3))
    if kind == "aniso":
        return _aniso((12, 10))
    if kind == "knn":
        return testing.knn_ldu(400)[0]
    raise KeyError(kind)


def _coos(kind, dtype=np.float32):
    """The same COO in both packages."""
    m = _system(kind)
    pm = m if kind == "knn" else _port(m)
    c = ldu.ldu_to_coo_host(pm, dtype=dtype)
    ref = RefCoo(rows=np.asarray(c.rows), cols=np.asarray(c.cols), vals=np.asarray(c.vals),
                 shape=c.shape)
    return ref, c


def _equal_triples(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- the host factorisations --------------------------------------------------


@pytest.mark.parametrize("fact,kind", [("ilu0_factors", "cd"), ("ilut_factors", "cd"),
                                       ("ic0_factor", "p3"), ("ict_factor", "knn")])
def test_factors_equal_the_references(fact, kind):
    ref, coo = _coos(kind)
    got, want = getattr(ilu, fact)(coo), getattr(ref_ilu, fact)(ref)
    if fact in ("ilu0_factors", "ilut_factors"):
        _equal_triples(got[0], want[0])
        _equal_triples(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    else:
        _equal_triples(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_factorisation_sums_duplicate_entries():
    """tests/test_precond.py's case: A = [[4, -2], [-2, 4]] with each
    off-diagonal stored twice."""
    rows = np.array([0, 0, 0, 1, 1, 1], np.int32)
    cols = np.array([0, 1, 1, 0, 0, 1], np.int32)
    vals = np.array([4.0, -1.0, -1.0, -1.0, -1.0, 4.0])
    coo = formats.Coo(rows=rows, cols=cols, vals=vals, shape=(2, 2))
    (lr, lc, lv), _, ud = ilu.ilu0_factors(coo)
    np.testing.assert_allclose(ud, [4.0, 4.0 - (-2.0) * (-2.0 / 4.0)])
    np.testing.assert_allclose(lv, [-0.5])  # -2/4, not -1/4
    ref = ref_ilu.ilu0_factors(RefCoo(rows=rows, cols=cols, vals=vals, shape=(2, 2)))
    np.testing.assert_array_equal(ud, ref[2])
    for fact in ("ic0_factor", "ict_factor"):
        (_, _, v), d = getattr(ilu, fact)(coo)
        np.testing.assert_allclose(v, [-1.0])  # -2/sqrt(4)
        np.testing.assert_allclose(d, [2.0, np.sqrt(3.0)])


@pytest.mark.parametrize("fact", ["ilu0_factors", "ic0_factor", "ict_factor"])
def test_numpy_paths_without_the_native_runtime(fact, monkeypatch):
    ref, coo = _coos("cd" if fact == "ilu0_factors" else "p3")
    want = getattr(ref_ilu, fact)(ref)
    monkeypatch.setattr(native, "lib", lambda: None)
    got = getattr(ilu, fact)(coo)
    flat = [(got[0], want[0])] + ([(got[1], want[1])] if fact == "ilu0_factors" else [])
    for g, w in flat:
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[2], w[2], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-12)


# ---- factor_depth and the levels -----------------------------------------------


@pytest.mark.parametrize("kind", ["p2", "p3", "aniso", "knn"])
def test_factor_depth_is_the_references(kind):
    ref, coo = _coos(kind)
    (lr, lc, _), (ur, uc, _), _ = ref_ilu.ilu0_factors(ref)
    (ir, ic, _), _ = ref_ilu.ict_factor(ref)
    n = coo.shape[0]
    for r, c in ((lr, lc), (ur, uc), (ir, ic), (ic, ir)):
        assert ilu.factor_depth(r, c, n) == ref_ilu.factor_depth(r, c, n)
    lev = ilu.factor_levels(lr, lc, n)
    assert np.all(lev[lr] > lev[lc])  # every source sits on an earlier level


def test_factor_depth_edges_and_the_fixpoint_fallback(monkeypatch):
    n = 16
    chain = (np.arange(1, n), np.arange(0, n - 1))
    assert ilu.factor_depth(*chain, n) == n - 1
    assert ilu.factor_depth(chain[1], chain[0], n) == n - 1
    assert ilu.factor_depth(np.zeros(0), np.zeros(0), n) == 1
    # entries on both sides of the diagonal: the native pass refuses, the
    # reference's fixpoint answers
    rows, cols = np.array([1, 2, 3]), np.array([0, 3, 2])
    assert ilu.factor_depth(rows[:2], cols[:2], 4) == ref_ilu.factor_depth(rows[:2], cols[:2], 4)
    with pytest.raises(ValueError, match="strict triangular"):
        native.tri_levels(rows, cols, 4)
    monkeypatch.setattr(native, "lib", lambda: None)
    assert ilu.factor_depth(*chain, n) == n - 1


# ---- the apply -----------------------------------------------------------------


def _cfg(name, mode, cls):
    kw = {"exact": {"tri_solve": "exact"}, "sweeps3": {"tri_solve_sweeps": 3}}.get(mode, {})
    return cls(name=name, **kw)


def _ref_factors_state(name, mode, ref):
    sweeps = 5 if name == "IRILU" else 3 if mode == "sweeps3" else 8
    exact = mode == "exact" and name != "IRILU"
    if name in ("ILU", "IRILU", "ILUT"):
        lo, up, ud = (ref_ilu.ilut_factors(ref) if name == "ILUT"
                      else ref_ilu.ilu0_factors(ref))
        return ilu.state_from_factors(lo, up, ud, "lu", "cpu", sweeps, exact)
    lo, ld = ref_ilu.ict_factor(ref) if name == "ICT" else ref_ilu.ic0_factor(ref)
    return ilu.state_from_factors(lo, None, ld, "ic", "cpu", sweeps, exact)


@pytest.mark.parametrize("mode", ["sweeps8", "sweeps3", "exact"])
@pytest.mark.parametrize("name", NAMES)
def test_apply_matches_the_reference(name, mode):
    ref, coo = _coos("cd" if name in ("ILU", "ILUT", "IRILU") else "knn")
    r = np.random.default_rng(3).normal(size=coo.shape[0]).astype(np.float32)
    want = np.asarray(ref_build(_cfg(name, mode, RefPrecondConfig), ref)(r))
    scale = np.abs(want).max()
    own = build(_cfg(name, mode, PrecondConfig), coo, "cpu")
    st = _ref_factors_state(name, mode, ref)
    assert own.state.exact == st.exact == (mode == "exact" and name != "IRILU")
    before = dict(kernels.launches)
    for got in (own(torch.tensor(r)), ilu.apply(st, torch.tensor(r))):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert kernels.launches == before  # CPU tensors take the twins
    assert own.state.applies == 1 and st.applies == 1


@pytest.mark.parametrize("kind", ["lu", "ic"])
def test_exact_mode_equals_scipy_trisolve(kind):
    ref, coo = _coos("aniso", np.float64)
    n = coo.shape[0]
    r = np.random.default_rng(1).normal(size=n)
    if kind == "lu":
        (lr, lc, lv), (ur, uc, uv), ud = ilu.ilu0_factors(coo)
        L = sp.csr_matrix((lv, (lr, lc)), shape=(n, n)) + sp.eye(n)
        U = sp.csr_matrix((uv, (ur, uc)), shape=(n, n)) + sp.diags(ud)
        st = ilu.state_from_factors((lr, lc, lv), (ur, uc, uv), ud, "lu", "cpu", exact=True)
    else:
        (lr, lc, lv), ld = ilu.ic0_factor(coo)
        L = sp.csr_matrix((lv, (lr, lc)), shape=(n, n)) + sp.diags(ld)
        U = L.T
        st = ilu.state_from_factors((lr, lc, lv), None, ld, "ic", "cpu", exact=True)
    want = spsolve_triangular(U.tocsr(), spsolve_triangular(L.tocsr(), r, lower=True),
                              lower=False)
    got = ilu.apply(st, torch.tensor(r.astype(np.float32))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _swept(lower, upper, k_lower, k_upper):
    """The two triangles with k_lower and k_upper sweeps."""
    return (dataclasses.replace(lower, sweeps=k_lower), dataclasses.replace(upper, sweeps=k_upper))


@pytest.mark.parametrize("name", ["ILU", "ILUT", "IC", "ICT"])
def test_level_twin_is_the_sweep_twin_run_to_depth(name):
    _, coo = _coos("knn")
    st = build(PrecondConfig(name=name, tri_solve="exact"), coo, "cpu").state
    r = torch.tensor(np.random.default_rng(5).normal(size=coo.shape[0]).astype(np.float32))
    lo, up = st.lower, st.upper
    levels = tri_solve.tri_levels_plain(lo, up, r)
    assert torch.equal(levels, tri_solve.tri_sweep_plain(*_swept(lo, up, lo.depth, up.depth), r))


def test_one_sweep_short_of_the_depth_is_not_exact():
    """On a chain (z_i = r_i + z_(i-1)) of n rows, depth n - 1: the sweeps
    to the depth and the levels give all ones from e_0, one sweep fewer on
    either factor leaves the last row of its chain at 0."""
    n = 12
    chain = (np.arange(1, n), np.arange(0, n - 1), -np.ones(n - 1))
    back = (chain[1], chain[0], chain[2])
    st = ilu.state_from_factors(chain, back, np.ones(n), "lu", "cpu", exact=True)
    lo, up = st.lower, st.upper
    assert lo.depth == up.depth == n - 1
    r = torch.zeros(n)
    r[0] = 1.0
    z = tri_solve.tri_levels_plain(lo, up, r)
    # L z = e_0 gives all ones; U x = z then x_i = sum_(j >= i) z_j = n - i
    assert torch.equal(z, torch.arange(n, 0, -1, dtype=torch.float32))
    assert torch.equal(z, tri_solve.tri_sweep_plain(*_swept(lo, up, n - 1, n - 1), r))
    for short in ((n - 2, n - 1), (n - 1, n - 2)):
        assert not torch.equal(z, tri_solve.tri_sweep_plain(*_swept(lo, up, *short), r))


def test_zero_sweeps_scale_only():
    _, coo = _coos("p3")
    st = build(PrecondConfig(name="IC", tri_solve_sweeps=0), coo, "cpu").state
    r = torch.tensor(np.random.default_rng(2).normal(size=coo.shape[0]).astype(np.float32))
    assert torch.equal(ilu.apply(st, r), r * st.lower.d * st.upper.d)


def test_kernel_entry_points_match_their_signatures():
    """Each extern "C" entry of the two sources takes as many arguments as
    its ctypes signature names (no nvcc here to catch a mismatch)."""
    for src in ("tri_sweep.cu", "tri_levels.cu"):
        text = (_build.CSRC / src).read_text()
        for name, args in re.findall(r'extern "C" int (ogl_\w+)\(([^)]*)\)', text):
            assert len(args.split(",")) == len(_build._SIGNATURES[name]), name


def test_wrappers_refuse_a_cuda_r_against_cpu_factors():
    _, coo = _coos("p3")
    st = build(PrecondConfig(name="IC"), coo, "cpu").state
    r = torch.zeros(coo.shape[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        tri_solve.tri_sweep(st.lower, st.upper, r.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        tri_solve.tri_levels(st.lower, st.upper, r.to("meta"))


# ---- the factory, the routes and the solver layer ------------------------------


def test_the_five_names_take_the_host_loops_and_are_supported():
    dia = formats.coo_to_dia(_coos("p3")[1], "cpu")
    for name in NAMES:
        assert f"preconditioner {name}" in cg_mod.precond_why_not(name)
        for solver, route in (("GKOCG", "cg"), ("GKOBiCGStab", "bicgstab"),
                              ("GKOGMRES", "gmres")):
            cfg = parse_controls({"solver": solver, "preconditioner": name})
            assert solver_mod.unsupported(cfg) is None
            assert solver_mod._route(cfg, dia) == route
        bf = parse_controls({"preconditioner": {"preconditioner": name,
                                                "precision": "bfloat16"}})
        assert "bfloat16 (ROADMAP.md A10)" in solver_mod.unsupported(bf)
    big = parse_controls({"preconditioner": {"preconditioner": "BJ", "maxBlockSize": 64}})
    assert "A10" in solver_mod.unsupported(big)


def test_caching_rebuilds_the_factors_only_on_changed_coefficients():
    m = _port(ref_testing.poisson_ldu((6, 5, 3)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "executor": "cpu", "tolerance": TOL, "relTol": 0,
           "preconditioner": "IC"}
    foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    first = slv._precond_op
    foam.solve("p", m, b * 2, ctl)
    assert slv._precond_op is first
    foam.solve("p", dataclasses.replace(m, diag=np.asarray(m.diag) * 1.5), b, ctl)
    assert slv._precond_op is not first
    assert not torch.equal(slv._precond_op.state.lower.d, first.state.lower.d)


FOAM_CASES = {
    "GKOCG IC": ("GKOCG", "IC", "p"),
    "GKOCG ICT": ("GKOCG", "ICT", "p"),
    "GKOCG IC exact": ("GKOCG", {"preconditioner": "IC", "triSolve": "exact"}, "p"),
    "GKOBiCGStab ILU": ("GKOBiCGStab", "ILU", "cd"),
    "GKOBiCGStab IRILU": ("GKOBiCGStab", "IRILU", "cd"),
    "GKOGMRES ILUT": ("GKOGMRES", "ILUT", "cd"),
    "GKOGMRES ILU exact": ("GKOGMRES", {"preconditioner": "ILU", "triSolve": "exact"}, "cd"),
}


@pytest.mark.parametrize("case", list(FOAM_CASES))
def test_foam_solve_matches_reference(case):
    solver, pc, kind = FOAM_CASES[case]
    m = (ref_testing.poisson_ldu((12, 10, 6)) if kind == "p"
         else ref_testing.convection_diffusion_ldu((12, 10, 6)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "executor": "cpu", "tolerance": TOL, "relTol": 0,
           "preconditioner": pc, "adaptMinIter": False}
    x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
    x, perf = foam.solve("p", _port(m), b, ctl)
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1, (perf, perf_ref)
    assert perf.converged and perf_ref.converged
    a = testing.to_dense_ldu(_port(m)).astype(np.float64)
    assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 10 * TOL
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4 * np.abs(x_ref).max())
    assert registry.global_registry.get("p_solver")._precond_op.state.applies > 0


@pytest.mark.parametrize("name,solver", [("ILU", "GKOBiCGStab"), ("IC", "GKOCG")])
def test_exact_pays_off_on_the_anisotropic_study(name, solver):
    """tests/test_trisolve_exact.py's study on the port: on the 1000:1
    anisotropic case exact substitution converges in under a fifth of the
    iterations the 8-sweep default takes.  The default's count is taken
    converged or not: float32 GKOBiCGStab with the 8-sweep ILU is chaotic
    here — from this b the reference converges in 523 iterations and the
    port stops unconverged at its doubled maxIter with the apply's bits
    equal to the reference's, and one ulp of b's scale moves both sides'
    counts by hundreds to thousands (tests/aniso_scatter.py)."""
    m = _port(_aniso((24, 24)))
    b = np.random.default_rng(0).normal(size=m.n)
    its = {}
    for mode, extra in (("exact", {"triSolve": "exact"}), ("approx8", {})):
        x, perf = foam.solve(f"p_{mode}", m, b, {
            "solver": solver, "executor": "cpu", "tolerance": 1e-6, "relTol": 0.0,
            "maxIter": 4000, "preconditioner": {"preconditioner": name, **extra}})
        assert perf.converged or mode == "approx8", (mode, perf)
        its[mode] = perf.n_iterations
    assert its["exact"] * 5 < its["approx8"], its
