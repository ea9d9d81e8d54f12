"""The port's preconditioner slice against the reference: the native host
runtime (bit-equal: the same C++), blocked Jacobi (set-up and the
block-Jacobi kernel's twin), ISAI/GISAI (triples on the native and the
NumPy paths, the apply), the factory, the routing rules that keep a
blocked BJ and an ISAI away from the loop kernels, and GKOCG/GKOBiCGStab
solves with them through `foam.solve` against `ogl_tpu.foam.solve`."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import native as ref_native
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import PrecondConfig as RefPrecondConfig
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.precond import build as ref_build
from ogl_tpu_torch import foam, interop, kernels, native, registry, testing
from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.foam import solver as solver_mod
from ogl_tpu_torch.kernels.block_jacobi import block_jacobi, block_jacobi_plain
from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels
from ogl_tpu_torch.precond import VALID, build
from ogl_tpu_torch.precond.jacobi import block_inverses

# the modules themselves (the packages re-export functions of the same names)
isai_mod = importlib.import_module("ogl_tpu_torch.precond.isai")
ref_isai_mod = importlib.import_module("ogl_tpu.precond.isai")
cg_mod = importlib.import_module("ogl_tpu_torch.solve.cg")
bicgstab_mod = importlib.import_module("ogl_tpu_torch.solve.bicgstab")

torch.set_num_threads(2)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _port(m):
    return interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag, m.upper,
                                   getattr(m, "lower", None))


def _coos(m):
    """The same float32 COO in both packages."""
    ref = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
    return ref, ldu.ldu_to_coo_host(_port(m), dtype=np.float32)


def _with_zero_diagonal_row(m, row):
    """m with row `row`'s diagonal set to zero (an identity-action row)."""
    diag = np.array(m.diag, copy=True)
    diag[row] = 0.0
    return dataclasses.replace(m, diag=diag)


# ---- the native host runtime ------------------------------------------------


def _csr(m):
    import scipy.sparse as sp

    c = ref_ldu.ldu_to_coo_host(m, dtype=np.float64)
    a = sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows), np.asarray(c.cols))),
                      shape=c.shape)
    a.sort_indices()
    return a


def _native_args(name):
    m = ref_testing.convection_diffusion_ldu((9, 7, 3))
    a = _csr(m)
    n = m.n
    ip, ix = a.indptr.astype(np.int64), a.indices.astype(np.int32)
    rng = np.random.default_rng(3)
    if name == "init_local_sparsity":
        return (n, m.lower_addr, m.upper_addr, False)
    if name == "sort_coo":
        return (n, rng.integers(0, n, 500), rng.integers(0, n, 500))
    if name == "dia_layout":
        c = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
        return (np.asarray(c.rows), np.asarray(c.cols), n)
    if name == "dia_pack_f32":
        c = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
        offs, dest = ref_native.dia_layout(np.asarray(c.rows), np.asarray(c.cols), n)
        return (dest, rng.normal(size=len(dest)).astype(np.float32), len(offs), n)
    if name == "pgm_aggregate":
        return (n, ip, ix, np.abs(a.data))
    if name in ("ilu0_csr", "ilut_triples"):
        return (n, ip, ix, a.data)
    if name in ("ic0_csr", "ict_triples"):
        import scipy.sparse as sp

        low = sp.tril(_csr(ref_testing.poisson_ldu((9, 7, 3)))).tocsr()
        low.sort_indices()
        return (n, low.indptr.astype(np.int64), low.indices.astype(np.int32), low.data)
    if name == "isai_build":
        s = isai_mod._pattern_power(*(np.asarray(v, np.int64) for v in a.nonzero()), n, 2)
        k = int(np.diff(s.indptr).max())
        return (n, ip, ix, a.data.astype(np.float32), s.indptr.astype(np.int64),
                s.indices, k)
    raise KeyError(name)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [leaf for part in out for leaf in _flat(part)]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", ["init_local_sparsity", "sort_coo", "dia_layout",
                                  "dia_pack_f32", "pgm_aggregate", "ilu0_csr", "ic0_csr",
                                  "ilut_triples", "ict_triples", "isai_build"])
def test_native_entry_points_bit_equal_to_the_reference(name):
    if not (native.available() and ref_native.available()):
        pytest.skip("no g++ toolchain")
    args = _native_args(name)
    got, want = (_flat(getattr(mod, name)(*args)) for mod in (native, ref_native))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_build_is_atomic_and_keyed(tmp_path, monkeypatch):
    """A fresh build lands by rename under a name keyed by the source, and
    leaves no temporary file behind."""
    if not native.available():
        pytest.skip("no g++ toolchain")
    monkeypatch.setattr(native, "BUILD", tmp_path)
    out = native._so_path()
    assert out.parent == tmp_path and out.name.startswith("libogl_host_")
    assert native._compile(out) and out.is_file()
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]


# ---- blocked Jacobi ---------------------------------------------------------


@pytest.mark.parametrize("bs", [2, 3, 4, 8, 32])
def test_block_jacobi_matches_reference(bs):
    dims = (9, 7, 3)  # 189 rows: a multiple of none of the sizes but 3
    if bs == 3:
        dims = (10, 7, 2)  # 140 rows
    m = ref_testing.convection_diffusion_ldu(dims)
    ref_coo, coo = _coos(m)
    r = np.random.default_rng(bs).normal(size=m.n).astype(np.float32)
    want = np.asarray(ref_build(RefPrecondConfig(name="BJ", max_block_size=bs), ref_coo)(r))
    op = build(PrecondConfig(name="BJ", max_block_size=bs), coo, "cpu")
    got = op(torch.tensor(r)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    # the twin is a straight sum over each block's row of the inverse
    inv = op.state.numpy().transpose(0, 2, 1)
    rp = np.pad(r, (0, inv.shape[0] * bs - m.n)).reshape(-1, bs)
    np.testing.assert_allclose(got, np.einsum("bij,bj->bi", inv, rp).reshape(-1)[:m.n],
                               rtol=1e-5, atol=1e-6 * scale)


def test_block_jacobi_exact_on_block_diagonal():
    rng = np.random.default_rng(1)
    bs, nb = 4, 6
    blocks = rng.normal(size=(nb, bs, bs)) + 5 * np.eye(bs)
    a = np.zeros((nb * bs, nb * bs))
    for i in range(nb):
        a[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = blocks[i]
    rows, cols = np.nonzero(a)
    coo = formats.Coo(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                      vals=a[rows, cols].astype(np.float32), shape=a.shape)
    op = build(PrecondConfig(name="BJ", max_block_size=bs), coo, "cpu")
    x = rng.normal(size=nb * bs).astype(np.float32)
    got = op(torch.tensor((a @ x).astype(np.float32))).numpy()
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-5)


def test_block_jacobi_twin_rounds_in_k_order():
    """block_jacobi_plain is Σ_k from 0.0 in k order, each step rounded to
    float32 (what the kernel's __fmul_rn/__fadd_rn chain computes)."""
    rng = np.random.default_rng(7)
    nb, bs, n = 5, 6, 27
    inv_t = rng.normal(size=(nb, bs, bs)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    got = block_jacobi_plain(torch.tensor(inv_t), torch.tensor(r)).numpy()
    rp = np.pad(r, (0, nb * bs - n)).reshape(nb, bs)
    want = np.zeros((nb, bs), np.float32)
    for k in range(bs):
        want = (want + (inv_t[:, k, :] * rp[:, k:k + 1]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got, want.reshape(-1)[:n])
    kernels.reset_launches()
    np.testing.assert_array_equal(block_jacobi(torch.tensor(inv_t), torch.tensor(r)).numpy(),
                                  got)
    assert kernels.launches["block_jacobi"] == 0  # CPU tensors take the twin


def test_block_jacobi_refuses_what_the_kernel_cannot_take():
    m = ref_testing.poisson_ldu((6, 6, 2))
    _, coo = _coos(m)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        build(PrecondConfig(name="BJ", max_block_size=33), coo, "cpu")
    with pytest.raises(NotImplementedError, match="maxBlockSize 64.*A10"):
        foam.FoamSolver("p", {"executor": "cpu",
                              "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 64}})
    inv = torch.tensor(block_inverses(coo, 4))
    assert inv.shape == (18, 4, 4)


# ---- ISAI / GISAI -----------------------------------------------------------


def _isai_case(kind):
    m = (ref_testing.poisson_ldu((8, 6, 3)) if kind == "poisson"
         else ref_testing.convection_diffusion_ldu((8, 6, 3)))
    return _with_zero_diagonal_row(m, 17)


def _sorted_triples(t):
    r, c, v = (np.asarray(a) for a in t)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize("kind", ["poisson", "cd"])
def test_isai_triples_match_reference(kind, power, path, monkeypatch):
    if path == "native" and not (native.available() and ref_native.available()):
        pytest.skip("no g++ toolchain")
    if path == "numpy":
        monkeypatch.setattr(native, "lib", lambda: None)
        monkeypatch.setattr(ref_native, "lib", lambda: None)
    m = _isai_case(kind)
    ref_coo, coo = _coos(m)
    got = _sorted_triples(isai_mod.isai_triples(coo, sparsity_power=power))
    want = _sorted_triples(ref_isai_mod.isai_triples(ref_coo, sparsity_power=power))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    if path == "native":
        np.testing.assert_array_equal(got[2], want[2])  # the same C++
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
        # the zero-diagonal row takes the identity action
        row = got[0] == 17
        np.testing.assert_array_equal(got[1][row], [17])
        np.testing.assert_array_equal(got[2][row], [1.0])


@pytest.mark.parametrize("name", ["ISAI", "GISAI"])
def test_isai_apply_matches_reference(name):
    m = ref_testing.convection_diffusion_ldu((8, 6, 3))
    ref_coo, coo = _coos(m)
    r = np.random.default_rng(5).normal(size=m.n).astype(np.float32)
    want = np.asarray(ref_build(RefPrecondConfig(name=name, sparsity_power=2), ref_coo)(r))
    op = build(PrecondConfig(name=name, sparsity_power=2), coo, "cpu")
    assert len(op.state) == (2 if name == "ISAI" else 1)
    np.testing.assert_allclose(op(torch.tensor(r)).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_isai_names_its_host_memory_on_a_wide_pattern(monkeypatch):
    monkeypatch.setattr(isai_mod, "WIDE_PATTERN", 4)
    _, coo = _coos(ref_testing.poisson_ldu((6, 5, 3)))
    with pytest.warns(RuntimeWarning, match=r"k = \d+ entries .* GiB of host memory"):
        isai_mod.isai_triples(coo, sparsity_power=2)


# ---- the factory ------------------------------------------------------------


def test_factory_ports_bj_isai_gisai_and_keeps_refusing_the_rest():
    """Every name of the reference builds (the ILU family since slice 20,
    approximate and exact); `precision bfloat16` still refuses every ported
    name but `none`, naming A10."""
    assert VALID == ("none", "BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI",
                      "Multigrid")
    _, coo = _coos(ref_testing.poisson_ldu((6, 5, 3)))
    for name in ("ILU", "ILUT", "IRILU", "IC", "ICT"):
        for tri in ("approx", "exact"):
            op = build(PrecondConfig(name=name, tri_solve=tri), coo, "cpu")
            assert op.state.exact == (tri == "exact" and name != "IRILU")
            assert op.state.lower.sweeps == (5 if name == "IRILU" else 8)
    for name in VALID[1:]:
        with pytest.raises(NotImplementedError, match="bfloat16.*A10"):
            build(PrecondConfig(name=name, value_precision="bfloat16"), coo, "cpu")


@pytest.mark.parametrize("name", ["BJ", "GISAI"])
def test_skip_sorting_false_sorts_the_coo(name):
    m = ref_testing.convection_diffusion_ldu((6, 5, 3))
    _, coo = _coos(m)
    perm = np.random.default_rng(2).permutation(len(coo.rows))
    shuffled = formats.Coo(rows=coo.rows[perm], cols=coo.cols[perm], vals=coo.vals[perm],
                           shape=coo.shape)
    r = torch.tensor(np.random.default_rng(3).normal(size=m.n).astype(np.float32))
    kw = {"max_block_size": 4} if name == "BJ" else {}
    want = build(PrecondConfig(name=name, **kw), coo, "cpu")(r)
    got = build(PrecondConfig(name=name, skip_sorting=False, **kw), shuffled, "cpu")(r)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- routing: an ISAI never reaches a loop kernel; a blocked BJ only ---------
# ---- GKOBiCGStab's (its loop kernel's block-Jacobi variants) ----------------


@pytest.mark.parametrize("pc", [{"preconditioner": "BJ", "maxBlockSize": 4}, "ISAI", "GISAI"])
@pytest.mark.parametrize("solver,fmt", [("GKOCG", "Dia"), ("GKOCG", "Gdia"), ("GKOCG", "Ell"),
                                        ("GKOBiCGStab", "Dia"), ("GKOBiCGStab", "Csr")])
def test_blocked_bj_and_isai_keep_the_host_loop(solver, fmt, pc, monkeypatch):
    """No merged route, no scalar invd: `_route`, both `why_not`s and the
    route call.  ISAI, GISAI and GKOCG + blocked BJ: no plan, the host
    loop.  GKOBiCGStab + blocked BJ: the format's loop plan and the block
    inverses (the state, as inv_t) reach solve/bicgstab.py, whose loop
    kernel takes them on the card (the CPU runs its twin)."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a merged route took a non-diagonal preconditioner")

    monkeypatch.setattr(solver_mod, "cg_fused", refuse)
    monkeypatch.setattr(solver_mod, "cg", spy("cg", solver_mod.cg))
    monkeypatch.setattr(solver_mod, "bicgstab", spy("bicgstab", solver_mod.bicgstab))
    m = ref_testing.poisson_ldu((8, 8, 4))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "executor": "cpu", "matrixFormat": fmt, "tolerance": TOL,
           "relTol": 0, "preconditioner": pc}
    x, perf = foam.solve("p", _port(m), b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.route == ("cg" if solver == "GKOCG" else "bicgstab")
    name = pc if isinstance(pc, str) else "BJ"
    a, kw = seen[slv.route]
    if solver == "GKOBiCGStab" and name == "BJ":
        assert type(slv.kern) is {"Dia": CgKernels, "Csr": CsrCgKernels}[fmt]
        # (ops, b, x0, params, kern, data, invd, inv_t): the plan and the inverses
        assert len(a) == 8 and not kw
        assert a[4] is slv.kern and a[6] is None and a[7] is slv._precond_op.state
        assert tuple(a[7].shape) == (-(-slv.matrix.shape[0] // 4), 4, 4)
    else:
        assert slv.kern is None
        assert len(a) == 4 and not kw  # (ops, b, x0, params): no plan, data or invd
    assert perf.converged
    assert cg_mod.why_not(slv.matrix, name, 4) is not None
    assert (bicgstab_mod.why_not(slv.matrix, name, 4) is None) == (name == "BJ")


def test_why_not_names_blocked_bj_and_isai():
    dia = formats.coo_to_dia(_coos(ref_testing.poisson_ldu((6, 5, 3)))[1], "cpu")
    assert bicgstab_mod.why_not(dia, "BJ", 4) is None  # the loop's block-Jacobi phases
    assert "maxBlockSize 4 > 1" in cg_mod.precond_why_not("BJ", 4)
    assert "maxBlockSize 33 > 1" in bicgstab_mod.why_not(dia, "BJ", 33)
    assert bicgstab_mod.why_not(dia, "BJ", 1) is None
    assert "preconditioner ISAI" in bicgstab_mod.why_not(dia, "ISAI")
    assert "preconditioner GISAI" in cg_mod.precond_why_not("GISAI")


def test_merged_routes_only_for_diagonal_preconditioners():
    from ogl_tpu_torch.config import parse_controls

    dia = formats.coo_to_dia(_coos(ref_testing.poisson_ldu((6, 5, 3)))[1], "cpu")
    for pc, route in (("none", "cg_fused"), ("BJ", "cg_fused"), ("Multigrid", "cg_fused"),
                      ({"preconditioner": "BJ", "maxBlockSize": 2}, "cg"),
                      ("GISAI", "cg")):
        assert solver_mod._route(parse_controls({"preconditioner": pc}), dia) == route
        pipe = parse_controls({"preconditioner": pc, "pipelinedCG": True})
        assert solver_mod._route(pipe, dia) == (
            "cg_pipe_fused" if pc in ("none", "BJ") else "cg_pipe")


# ---- foam.solve against the reference ---------------------------------------

FOAM_CASES = {
    "GKOCG GISAI Ell": ("GKOCG", "GISAI", "Ell", "poisson"),
    "GKOCG ISAI Dia": ("GKOCG", "ISAI", "Dia", "poisson"),
    "GKOBiCGStab BJ4 Csr": ("GKOBiCGStab", {"preconditioner": "BJ", "maxBlockSize": 4},
                            "Csr", "cd"),
    "GKOBiCGStab BJ8 Dia cd": ("GKOBiCGStab", {"preconditioner": "BJ", "maxBlockSize": 8},
                               "Dia", "cd"),
    "GKOBiCGStab GISAI Xell": ("GKOBiCGStab", "GISAI", "Xell", "cd"),
    # blocked BJ on the loop plans of the other formats (the loop kernel's
    # block-Jacobi variants on the card; here their twin)
    **{f"GKOBiCGStab BJ4 {fmt} cd": ("GKOBiCGStab", {"preconditioner": "BJ", "maxBlockSize": 4},
                                     fmt, "cd") for fmt in ("Gdia", "Xell", "Ell", "Sell")},
}


@pytest.mark.parametrize("case", list(FOAM_CASES))
def test_foam_solve_matches_reference(case):
    solver, pc, fmt, kind = FOAM_CASES[case]
    m = (ref_testing.poisson_ldu((12, 10, 6)) if kind == "poisson"
         else ref_testing.convection_diffusion_ldu((12, 10, 6)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "executor": "cpu", "matrixFormat": fmt, "tolerance": TOL,
           "relTol": 0, "preconditioner": pc, "adaptMinIter": False}
    ref_registry.global_registry.clear()
    x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
    x, perf = foam.solve("p", _port(m), b, ctl)
    assert perf.solver_name == perf_ref.solver_name
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1, (perf, perf_ref)
    assert perf.converged and perf_ref.converged
    a = testing.to_dense_ldu(_port(m)).astype(np.float64)
    true = np.abs(b - a @ x.numpy().astype(np.float64)).sum()
    nf = np.abs(b).sum()
    assert true / nf < 10 * TOL
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4 * np.abs(x_ref).max())
