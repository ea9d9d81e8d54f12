"""The port's Xell format against the reference's: host packing, the spill
tail and its per-row CSR, the value map (exact equality: the same numpy
arithmetic), the plain SpMV and K1 twins against `spmv_xell`, the Pallas
`xell_matvec` and `XellCgKernels.k1` in interpret mode, and the format
ladder `pack_fast`.

The graphs are random (an RCM'd random graph, and an RCM'd kNN mesh over
two destination tiles with c_left > 0): on a stencil the source residue
equals the destination lane, which would hide a wrong bbT index.
Tolerances: elementwise rtol=atol=2e-5 of the output's max (the Pallas
kernels cross their gathers through float32 MXU transposes and add the
spill in another order), the block sum δ rtol 2e-5."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.core import reorder as ref_reorder
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.kernels import xell as ref_xell
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import spmv, xell

torch.set_num_threads(2)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _random_graph(seed, n, k=5):
    """An RCM'd random symmetric graph (kNN-ish degree k) as a reference
    Coo with random float32 values and a dominant diagonal."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), k)
    dst = rng.integers(0, n, size=n * k)
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep], np.arange(n)])
    c = np.concatenate([dst[keep], src[keep], np.arange(n)])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = np.where(r == c, 2.0 * k + 1.0, rng.normal(size=len(r))).astype(np.float32)
    order = np.lexsort((c, r))
    coo = ref_formats.Coo(rows=r[order].astype(np.int32), cols=c[order].astype(np.int32),
                          vals=v[order], shape=(n, n))
    return ref_reorder.permute_coo(coo, ref_reorder.rcm_permutation(coo))


def _knn_coo(n, rcm=True):
    """testing.knn_ldu(n) as a reference Coo (RCM-renumbered by default)."""
    m, perm = testing.knn_ldu(n)
    if rcm:
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        m = testing.renumber_ldu(m, inv)
    c = ldu.ldu_to_coo_host(m, dtype=np.float32)
    return ref_formats.Coo(rows=c.rows, cols=c.cols, vals=c.vals, shape=c.shape)


def _port_coo(c):
    return formats.Coo(rows=np.asarray(c.rows), cols=np.asarray(c.cols),
                       vals=np.asarray(c.vals), shape=tuple(c.shape))


CASES = {
    "graph_spill_low": (lambda: _random_graph(5, 1800), 0.002),
    "graph_spill_high": (lambda: _random_graph(5, 1800), 0.08),
    "stencil": (lambda: ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu((32, 8, 4)),
                                                dtype=np.float32), 0.002),
    "knn_two_tiles": (lambda: _knn_coo(20000), 0.002),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, spill_frac = CASES[request.param]
    coo = make()
    ref = ref_xell.xell_from_coo(coo, spill_frac=spill_frac)
    mat = xell.xell_from_coo(_port_coo(coo), spill_frac=spill_frac)
    rng = np.random.default_rng(13)
    vec = {k: rng.normal(size=coo.shape[0]).astype(np.float32) for k in ("x", "z", "p")}
    return request.param, coo, spill_frac, ref, mat, vec


def _close(got, want, rtol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_layout_and_container_match_reference(case):
    name, coo, spill_frac, ref, mat, _ = case
    rows, cols, n = np.asarray(coo.rows), np.asarray(coo.cols), coo.shape[0]
    ours = xell.xell_layout(rows, cols, n, spill_frac=spill_frac)
    theirs = ref_xell.xell_layout(rows, cols, n, spill_frac=spill_frac)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(theirs, f.name))
    assert (mat.c_left, mat.c_chunks, mat.shape, mat.n_slots) == (
        ref.c_left, ref.c_chunks, ref.shape, ref.n_slots)
    for a, b, dtype in ((mat.vals, ref.vals, torch.float32), (mat.ll, ref.ll, torch.int8),
                        (mat.bbT, ref.bbT, torch.int16)):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(mat.spill, f).numpy(),
                                      np.asarray(getattr(ref.spill, f)))
    back = interop.xell_from_reference(ref)
    for f in ("vals", "ll", "bbT"):
        assert torch.equal(getattr(back, f), getattr(mat, f))
    for f in ("row_ptr", "rows", "cols", "gidx"):
        assert torch.equal(getattr(back.spill_csr, f), getattr(mat.spill_csr, f))
    assert torch.equal(back.spill.vals, mat.spill.vals)
    assert (back.c_left, back.c_chunks, back.shape) == (mat.c_left, mat.c_chunks, mat.shape)
    if name == "graph_spill_high":
        assert mat.spill.vals.shape[0] > 100  # the spill path is exercised
    if name == "knn_two_tiles":
        assert mat.vals.shape[0] == 2 and mat.c_left > 0 and coo.shape[0] % 128


def test_spill_csr_indexes_the_spill(case):
    _, coo, _, ref, mat, _ = case
    sp, n = mat.spill_csr, coo.shape[0]
    rows = mat.spill.rows.numpy().astype(np.int64)
    assert sp.row_ptr.dtype == torch.int32 and sp.row_ptr.shape == (n + 1,)
    np.testing.assert_array_equal(np.diff(sp.row_ptr.numpy()), np.bincount(rows, minlength=n))
    gidx = sp.gidx.numpy()
    np.testing.assert_array_equal(np.sort(gidx), np.arange(len(rows)))
    np.testing.assert_array_equal(sp.rows.numpy(), rows[gidx])
    np.testing.assert_array_equal(sp.cols.numpy(), mat.spill.cols.numpy()[gidx])
    assert np.all(np.diff(sp.rows.numpy()) >= 0)


def test_plain_spmv_matches_reference(case):
    _, coo, _, ref, mat, vec = case
    y = xell.spmv_xell(mat, torch.tensor(vec["x"])).numpy()
    _close(y, ref_xell.spmv_xell(ref, jnp.asarray(vec["x"])))
    _close(y, ref_xell.xell_matvec(ref, interpret=True)(jnp.asarray(vec["x"])))
    ys = ref_spmv.spmv_coo(ref_formats.Coo(rows=coo.rows, cols=coo.cols,
                                           vals=jnp.asarray(coo.vals, jnp.float64),
                                           shape=coo.shape),
                           jnp.asarray(vec["x"], jnp.float64))
    _close(y, ys)


def test_plain_k1_matches_reference(case):
    _, _, _, ref, mat, vec = case
    beta = 0.37
    rk = ref_xell.XellCgKernels.for_matrix(ref, interpret=True)
    pout, q, delta = rk.k1(rk.pack_values(ref), rk.frame(vec["z"]), rk.frame(vec["p"]), beta)
    plan = xell.XellPlan.of(mat)
    p2, q2, d2 = xell.xell_k1_plain(plan, mat.vals, mat.ll, mat.bbT, mat.spill.vals,
                                    torch.tensor(vec["z"]), torch.tensor(vec["p"]),
                                    torch.tensor(np.float32(beta)))
    _close(p2.numpy(), rk.unframe(pout))
    _close(q2.numpy(), rk.unframe(q))
    np.testing.assert_allclose(float(d2), float(delta), rtol=TOL)


def test_wrappers_dispatch_cpu_tensors_to_plain(case):
    _, _, _, ref, mat, vec = case
    plan = xell.XellPlan.of(mat)
    x, z, p = (torch.tensor(vec[k]) for k in ("x", "z", "p"))
    beta = torch.tensor(np.float32(0.6))
    kernels.reset_launches()
    torch.testing.assert_close(xell.xell_spmv(plan, mat.vals, mat.ll, mat.bbT,
                                              mat.spill.vals, x),
                               xell.spmv_xell(mat, x), rtol=0, atol=0)
    torch.testing.assert_close(spmv.matvec(mat)(x), spmv.spmv(mat, x), rtol=0, atol=0)
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    got = kern.k1(data, z, p, beta)
    want = xell.xell_k1_plain(plan, *data, z, p, beta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(kern.apply(data, x), xell.spmv_xell(mat, x), rtol=0, atol=0)
    alpha = torch.tensor(np.float32(0.2))
    x2, r2 = x.clone(), z.clone()
    rho, absr = kern.k2i(alpha, x2, r2, p, z)
    torch.testing.assert_close(r2, z - alpha * z)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions


def test_to_coo_roundtrip(case):
    _, coo, _, _, mat, _ = case
    back = xell.xell_to_coo(mat)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(coo, f)))


@pytest.mark.parametrize("keep_layout", [True, False], ids=["layout_kept", "recomputed"])
def test_value_map_update_equals_fresh_convert(case, keep_layout):
    """The steady-state update (spill values included) equals a fresh
    packing of the new values, and the index tables are carried over.  A
    container that kept its host layout reuses it; without it the map
    recomputes the default packing, as the reference's does — which does
    not match a container packed with another spill budget."""
    _, coo, spill_frac, ref, mat, _ = case
    pc = _port_coo(coo)
    m0 = mat if keep_layout else dataclasses.replace(mat, layout=None)
    if not keep_layout and spill_frac != 0.002:
        with pytest.raises(ValueError, match="sparsity changed"):
            formats.value_map(m0, pc.rows, pc.cols)
        with pytest.raises(ValueError, match="sparsity changed"):
            ref_formats.value_map(ref, coo.rows, coo.cols)
        return
    vm = formats.value_map(m0, pc.rows, pc.cols)
    new = np.random.default_rng(3).normal(size=len(pc.vals)).astype(np.float32)
    up = vm.update(m0, torch.tensor(new))
    fresh = xell.xell_from_coo(formats.Coo(pc.rows, pc.cols, new, pc.shape),
                               spill_frac=spill_frac)
    torch.testing.assert_close(up.vals, fresh.vals, rtol=0, atol=0)
    torch.testing.assert_close(up.spill.vals, fresh.spill.vals, rtol=0, atol=0)
    assert up.ll is mat.ll and up.bbT is mat.bbT and up.spill_csr is mat.spill_csr
    if spill_frac == 0.002:
        ref_vm = ref_formats.value_map(ref, coo.rows, coo.cols)
        np.testing.assert_array_equal(vm.dest.numpy(), np.asarray(ref_vm.dest))


def test_value_map_detects_structure_change():
    a, b = _random_graph(5, 1000), _random_graph(7, 1000)
    mat = xell.xell_from_coo(_port_coo(a))
    with pytest.raises(ValueError, match="sparsity changed"):
        formats.value_map(dataclasses.replace(mat, layout=None), b.rows, b.cols)


def _ref_type(coo):
    m = ref_spmv.pack_fast(np.asarray(coo.rows), np.asarray(coo.cols), np.asarray(coo.vals),
                           coo.shape[0], presorted=True)
    return type(m).__name__


@pytest.mark.parametrize("kind", ["dia", "shuffled_poisson", "knn"])
def test_pack_fast_picks_the_reference_format(kind):
    if kind == "dia":
        c = ldu.ldu_to_coo_host(testing.poisson_ldu((32, 16, 8)), dtype=np.float32)
        coo, want = ref_formats.Coo(c.rows, c.cols, c.vals, c.shape), "Dia"
    elif kind == "shuffled_poisson":
        c = ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu((128, 16, 8)), dtype=np.float32)
        coo, want = ref_formats.Coo(c.rows, c.cols, c.vals, c.shape), "Gdia"
    else:
        coo, want = _knn_coo(1 << 15), "Xell"
    assert _ref_type(coo) == want
    pc = _port_coo(coo)
    m = spmv.pack_fast(pc.rows, pc.cols, pc.vals, pc.shape[0], presorted=True)
    assert type(m).__name__ == want
    x = torch.tensor(np.random.default_rng(1).normal(size=pc.shape[0]).astype(np.float32))
    _close(spmv.spmv(m, x).numpy(), spmv.spmv_coo(pc, x).numpy())
    if want == "Gdia":
        assert m.plane_offsets == (-16, -1, 0, 0, 0, 1, 16)


@pytest.mark.parametrize("n", [20000, 1 << 17])
def test_pack_fast_raises_on_the_ell_landing(n):
    """Past Dia, Gdia and Xell both ladders land on Ell, the same Ell, with
    the reference's RuntimeWarning at n ≥ 32,768 (Xell tried and failed);
    under that Xell is not tried and nothing warns."""
    r = np.arange(n, dtype=np.int64)
    c = (r * 48271 + 11) % n
    r, c = np.concatenate([r, r, np.arange(n)]), np.concatenate([c, (c + 1) % n, np.arange(n)])
    key = r * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = np.ones(len(r), np.float32)
    if n >= 1 << 15:
        with pytest.warns(RuntimeWarning, match="Ell"):
            ref = ref_spmv.pack_fast(r, c, v, n)
    else:
        ref = ref_spmv.pack_fast(r, c, v, n)
    assert isinstance(ref, ref_formats.Ell)
    if n >= 1 << 15:
        with pytest.warns(RuntimeWarning, match="Xell packing failed"):
            got = spmv.pack_fast(r, c, v, n)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = spmv.pack_fast(r, c, v, n)
    assert isinstance(got, formats.Ell)
    want = interop.ell_from_reference(ref)
    assert torch.equal(got.cols, want.cols) and torch.equal(got.vals, want.vals)


@pytest.mark.parametrize("n, bands", [(0, 0), (1, 1), (1921, 1), (2048, 1), (2049, 2),
                                      (3 * 16384 + 129, 25), (1 << 20, 512),
                                      (256 * 256 * 128, 4096)])
def test_band_grid_covers_the_rows_inside_the_padded_tiles(n, bands):
    """The SpMV kernel's grid: one block per 2,048-row band (16 block rows
    of one tile), the last one ragged, and no band past the tiles that the
    packing pads the storage to."""
    assert xell.BAND_ROWS == 16 * xell.LANES == 2048
    assert xell.band_grid(n) == bands
    assert bands * xell.BAND_ROWS >= n
    tiles = max(-(-max(-(-n // xell.LANES), 1) // xell.TB), 1)
    assert bands * xell.BAND_ROWS <= tiles * xell.TB * xell.LANES


def test_fields_of_one_mesh_share_the_xell_packing(monkeypatch):
    """foam.solve on two fields of one kNN mesh (other values) packs the
    Xell layout once, with matrixFormat Xell and by the format ladder alike,
    and the second field gets the container a fresh packing gives.  An
    explicit Xell does not stand for the ladder's pick: the ladder runs
    once on the mesh itself, and on a grid it still picks Dia."""
    calls = []
    real = xell.xell_layout
    monkeypatch.setattr(xell, "xell_layout", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(spmv, "XELL_MIN_ROWS", 1024)
    m, perm = testing.knn_ldu(4096)
    m = testing.renumber_ldu(m, np.argsort(perm))
    m2 = dataclasses.replace(m, upper=np.asarray(m.upper) * 2, diag=np.asarray(m.diag) * 3)
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"executor": "cpu", "tolerance": 1e-6, "relTol": 0, "maxIter": 3}
    xl = {**ctl, "matrixFormat": "Xell"}

    def solver(field, mat, controls):
        foam.solve(field, mat, b, controls)
        return registry.global_registry.get(f"{field}_solver")

    first = solver("pA", m, xl)
    second = solver("pB", m2, xl)
    assert len(calls) == 1 and second.matrix.layout is first.matrix.layout
    fresh = xell.xell_from_coo(second.coo_host())
    for f in ("vals", "ll", "bbT"):
        assert torch.equal(getattr(second.matrix, f), getattr(fresh, f))
    assert len(calls) == 2
    laddered = [solver(f, m2, ctl) for f in ("pC", "pD")]
    assert len(calls) == 3 and all(type(s.matrix) is xell.Xell for s in laddered)
    assert laddered[1].matrix.layout is laddered[0].matrix.layout
    grid = testing.poisson_ldu((16, 16, 8))
    b = np.ones(grid.n, np.float32)
    assert type(solver("gA", grid, xl).matrix) is xell.Xell and len(calls) == 4
    assert type(solver("gB", grid, ctl).matrix) is formats.Dia and len(calls) == 4
