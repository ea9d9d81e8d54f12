"""The gather SpMVs of Coo, Csr, Ell, Sell and Hybrid (the plain twins of
kernels/gather_spmv.py) against the reference's XLA SpMVs on the CPU, the
twins against a float32 replay of their kernels' order, and the slice as a
whole: `foam.solve` with each explicit matrixFormat and the ladder's Ell
landing against the reference's.

Tolerance of a twin against the reference: the two sum a row's products in
different orders, each with at most len_i - 1 roundings, so row i may
differ by 2 · len_i · 2⁻²⁴ · Σ_j |a_ij x_j| (plus 1e-30)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ogl_tpu import foam as ref_foam
from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu_torch import foam, interop, registry, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.foam import solver as solver_mod
from ogl_tpu_torch.kernels import gather_spmv, spmv
from test_torch_formats import PORT, REF, coo_pair, many_widths_dense, random_dense

torch.set_num_threads(2)

FORMATS = list(PORT)


def _x(n, seed=1):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _bound(a, x):
    """Per row, twice the recursive-summation bound of a float32 row sum."""
    terms = np.abs(a.astype(np.float64)) * np.abs(x.astype(np.float64))[None, :]
    lens = np.count_nonzero(a, axis=1)
    return 2 * np.maximum(lens, 1) * 2.0 ** -24 * terms.sum(axis=1) + 1e-30


@pytest.mark.parametrize("n", [1, 13, 203, 517, "many widths"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_twin_matches_reference_spmv(fmt, n):
    a = many_widths_dense() if n == "many widths" else random_dense(n)
    ref, ours = coo_pair(a)
    x = _x(a.shape[0])
    y = spmv.spmv(PORT[fmt](ours), torch.tensor(x)).numpy()
    y_ref = np.asarray(ref_spmv.spmv(REF[fmt](ref), jnp.asarray(x)))
    assert np.all(np.abs(y - y_ref) <= _bound(a, x))
    assert np.all(np.abs(y - a.astype(np.float64) @ x) <= _bound(a, x))


@pytest.mark.parametrize("c, sigma", [(8, 64), (4, 1)])
def test_sell_twin_matches_reference_at_both_slice_heights(c, sigma):
    a = many_widths_dense()
    ref, ours = coo_pair(a)
    x = _x(a.shape[0])
    y = gather_spmv.spmv_sell(formats.coo_to_sell(ours, c, sigma), torch.tensor(x)).numpy()
    y_ref = np.asarray(ref_spmv.spmv_sell(ref_formats.coo_to_sell(ref, c, sigma),
                                          jnp.asarray(x)))
    assert np.all(np.abs(y - y_ref) <= _bound(a, x))


@pytest.mark.parametrize("width", [None, 1, 10000])
def test_hybrid_twin_with_short_all_and_empty_tails(width):
    a = random_dense(203)
    ref, ours = coo_pair(a)
    x = _x(203)
    m = formats.coo_to_hybrid(ours, width)
    y = gather_spmv.spmv_hybrid(m, torch.tensor(x)).numpy()
    y_ref = np.asarray(ref_spmv.spmv_hybrid(ref_formats.coo_to_hybrid(ref, width),
                                            jnp.asarray(x)))
    assert np.all(np.abs(y - y_ref) <= _bound(a, x))


# ---- the twins repeat their kernels' order (float32 replay) ---------------


def _f32_sum(terms):
    acc = np.float32(0.0)
    for t in terms:
        acc = np.float32(acc + np.float32(t))
    return acc


def _replay(fmt, m, x, group=None):
    """y of the CUDA kernel's arithmetic, replayed row by row in float32:
    the documented order of csrc/csr_rows.cuh (at `group` lanes per row,
    None: csr_group), ell_rows.cuh (Ell, and Hybrid's bulk before its tail:
    each row up to its 32-row group's longest row) and sell_rows.cuh (each
    slot up to its slice's longest row)."""
    n = m.shape[0]
    y = np.zeros(n, np.float32)
    if fmt in ("Coo", "Csr"):
        rp, c, v = (t.numpy() for t in (m.row_ptr, m.cols, m.vals))
        g = gather_spmv.csr_group(n, m.nnz) if group is None else group
        for i in range(n):
            idx = np.arange(rp[i], rp[i + 1])
            part = [_f32_sum(np.float32(v[j]) * x[c[j]] for j in idx[lane::g])
                    for lane in range(g)]
            while len(part) > 1:
                half = len(part) // 2
                part = [np.float32(part[k] + part[k + half]) for k in range(half)]
            y[i] = part[0]
    elif fmt in ("Ell", "Hybrid"):
        ell = m if fmt == "Ell" else m.ell
        c, v, w = ell.cols.numpy(), ell.vals.numpy(), ell.warp_slots.numpy()
        for i in range(n):
            terms = [np.float32(v[k, i]) * x[c[k, i]] for k in range(w[i // 32])]
            if fmt == "Hybrid":
                tp, tc, tv = (t.numpy() for t in (m.tail.row_ptr, m.tail.cols, m.tail.vals))
                terms += [np.float32(tv[j]) * x[tc[j]] for j in range(tp[i], tp[i + 1])]
            y[i] = _f32_sum(terms)
    else:
        c, v, rows = m.cols.numpy(), m.vals.numpy(), m.slot_rows.numpy()
        table = formats.sell_table(m.widths, m.n_slices, m.slice_height)
        for (s0, v0, w), ns in zip(table, m.n_slices):
            C = m.slice_height
            for local in range(ns * C):
                if rows[s0 + local] >= n:
                    continue
                e = v0 + local + ns * C * np.arange(int(m.slice_widths[(s0 + local) // C]))
                y[rows[s0 + local]] = _f32_sum(np.float32(v[j]) * x[c[j]] for j in e)
    return y


@pytest.mark.parametrize("fmt", FORMATS)
def test_twin_gives_the_bits_of_its_kernels_order(fmt):
    a = many_widths_dense(200)
    a[50] = np.random.default_rng(4).normal(size=200)  # a row longer than 32
    _, ours = coo_pair(a)
    m = PORT[fmt](ours)
    x = _x(200)
    got = spmv.spmv(m, torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, _replay(fmt, m, x))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_csr_twin_gives_the_bits_of_every_group_size(group):
    a = many_widths_dense(200)
    a[50] = np.random.default_rng(4).normal(size=200)
    _, ours = coo_pair(a)
    m = formats.coo_to_csr(ours)
    x = _x(200)
    got = gather_spmv.spmv_csr(m, torch.tensor(x), group).numpy()
    np.testing.assert_array_equal(got, _replay("Csr", m, x, group))


@pytest.mark.parametrize("n, nnz, group", [(0, 0, 1), (10, 20, 1), (1 << 20, 8526624, 1),
                                           (1 << 20, 7 << 20, 1), (100, 4000, 8),
                                           (100, 900000, 16), (100, 150, 1), (10, 160, 4),
                                           (10, 159, 1), (10, 640, 16)])
def test_csr_group_follows_the_mean_row_length(n, nnz, group):
    """One lane per row under 16 entries per row on mean (the 7-point
    stencil, the kNN-6 mesh's 8.1), then about four entries per lane."""
    assert gather_spmv.csr_group(n, nnz) == group


@pytest.mark.parametrize("fmt", FORMATS)
def test_matvec_is_the_kernel_wrapper_and_refuses_other_devices(fmt):
    """CPU tensors take the twin; a tensor on another device than CPU or
    CUDA ('meta') reaches no twin: the wrapper raises."""
    _, ours = coo_pair(random_dense(64))
    m = PORT[fmt](ours)
    x = torch.tensor(_x(64))
    assert torch.equal(spmv.matvec(m)(x), spmv.spmv(m, x))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        spmv.matvec(m)(torch.empty(64, device="meta"))


def test_host_coo_keeps_the_plain_product():
    a = random_dense(64)
    _, ours = coo_pair(a)
    y = spmv.matvec(ours)(torch.tensor(_x(64))).numpy()
    assert np.all(np.abs(y - a.astype(np.float64) @ _x(64)) <= _bound(a, _x(64)))


# ---- the slice as a whole -------------------------------------------------


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _knn(n=3000, rcm=True):
    m, perm = testing.knn_ldu(n)
    return testing.renumber_ldu(m, np.argsort(perm)) if rcm else m


def _ref_ldu(m):
    return ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                             diag=m.diag, upper=m.upper, lower=m.lower)


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


def _ctl(fmt, pc="none", **extra):
    ctl = {"solver": "GKOCG", "executor": "cpu", "tolerance": 1e-6, "relTol": 0,
           "preconditioner": {"none": "none", "BJ": {"preconditioner": "BJ"}}[pc], **extra}
    if fmt is not None:
        ctl["matrixFormat"] = fmt
    return ctl


def _solve_both(m, b, ctl, field="p"):
    x_ref, perf_ref = ref_foam.solve(field, _ref_ldu(m), b, ctl)
    x, perf = foam.solve(field, m, b, ctl)
    return x.numpy(), perf, np.asarray(x_ref), perf_ref


def _residual(m, x, b):
    coo = ldu.ldu_to_coo_host(m)
    ax = np.zeros(m.n)
    np.add.at(ax, coo.rows, coo.vals * x[coo.cols].astype(np.float64))
    return np.abs(b - ax).sum() / np.abs(b).sum()


CASES = [("GKOCG", "none", {}), ("GKOCG", "BJ", {}), ("GKOCG", "none", {"pipelinedCG": True}),
         ("GKOCG", "BJ", {"pipelinedCG": True}), ("GKOBiCGStab", "BJ", {})]


@pytest.mark.parametrize("solver, pc, extra", CASES,
                         ids=["cg", "cg_bj", "pipe", "pipe_bj", "bicgstab_cd"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_explicit_format_solves_as_the_reference(fmt, solver, pc, extra):
    """±1 iteration and x within 1e-4 of the reference's foam.solve with the
    same controls: CG on the kNN-6 mesh, BiCGStab on convection–diffusion.
    Every format takes the general loop over its SpMV and keeps the plan of
    its loop kernels for CG and BiCGStab (on the CPU the host loop runs, the
    kernels' twin); the pipelined CG keeps none."""
    if solver == "GKOBiCGStab":
        m = testing.convection_diffusion_ldu((16, 16, 8))
    else:
        m = _knn()
    b = _rhs(m.n)
    ctl = _ctl(fmt, pc, solver=solver, **extra)
    x, perf, x_ref, perf_ref = _solve_both(m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert perf.solver_name == perf_ref.solver_name == f"{solver}_{fmt}"
    assert formats.format_name(slv.matrix) == fmt
    assert (slv.kern is not None) == (not extra)
    assert slv.route == {"GKOBiCGStab": "bicgstab"}.get(
        solver, "cg_pipe" if extra else "cg")
    assert perf.converged and perf_ref.converged
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x, x_ref, atol=1e-4)
    assert _residual(m, x, b) < 1e-5


@pytest.mark.parametrize("fmt", FORMATS)
def test_steady_step_updates_values_in_place_of_a_conversion(fmt):
    """A diag-only step uploads one block of two and the RHS, its value
    update equals a fresh conversion of the new coefficients, and its
    solve matches the reference's step ±1 (adaptMinIter off: the check
    frequency it derives from measured timings could differ between the
    packages)."""
    m = _knn()
    b = _rhs(m.n)
    ctl = _ctl(fmt, adaptMinIter=False)
    _solve_both(m, b, ctl)
    m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
    b2 = (b * 1.01 + 0.1).astype(np.float32)
    x2, perf2, x2_ref, perf2_ref = _solve_both(m2, b2, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.last_blocks_uploaded == (1, 2) and slv.last_rhs_uploaded
    fresh = solver_mod._CONVERTERS[fmt](ldu.ldu_to_coo_host(m2, dtype=np.float32))
    assert torch.equal(formats.values_flat(slv.matrix), formats.values_flat(fresh))
    assert abs(perf2.n_iterations - perf2_ref.n_iterations) <= 1
    np.testing.assert_allclose(x2, x2_ref, atol=1e-4)
    assert _residual(m2, x2, b2) < 1e-5


def test_small_unstructured_mesh_lands_on_the_references_ell():
    """The kNN-6 mesh of 3,000 cells in its points' numbering: Dia and Gdia
    reject it and it is under Xell's 32,768 rows, so both ladders land on
    Ell, the same Ell; auto-routed, it solves as the reference's explicit
    Ell solve."""
    m = _knn(rcm=False)
    c = ldu.ldu_to_coo_host(m, dtype=np.float32)
    ref = ref_spmv.pack_fast(c.rows, c.cols, c.vals, m.n, presorted=True)
    ours = spmv.pack_fast(c.rows, c.cols, c.vals, m.n, presorted=True)
    assert isinstance(ref, ref_formats.Ell) and isinstance(ours, formats.Ell)
    want = interop.ell_from_reference(ref)
    assert torch.equal(ours.cols, want.cols) and torch.equal(ours.vals, want.vals)
    b = _rhs(m.n)
    x_ref, perf_ref = ref_foam.solve("p", _ref_ldu(m), b, _ctl("Ell"))
    x, perf = foam.solve("p", m, b, _ctl(None))
    assert perf.solver_name == "GKOCG_Ell" and perf.converged
    assert registry.global_registry.get("p_solver").route == "cg"
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)


def test_merged_routes_take_only_their_formats():
    """The routing fault: `_route` gave the merged CG to any format and
    `_kernel_plan` built a Dia plan for anything not Gdia or Xell.  Now a
    non-Dia/Gdia/Xell matrix takes the general loops, and asking it for a
    merged plan raises."""
    _, ours = coo_pair(random_dense(64))
    cfg = solver_mod.parse_controls({"solver": "GKOCG", "executor": "cpu"})
    pipe = solver_mod.parse_controls({"solver": "GKOCG", "executor": "cpu",
                                      "pipelinedCG": True})
    bi = solver_mod.parse_controls({"solver": "GKOBiCGStab", "executor": "cpu",
                                    "fusedBiCGStab": True})
    for fmt in FORMATS:
        mat = PORT[fmt](ours)
        assert solver_mod._route(cfg, mat) == "cg"
        assert solver_mod._route(pipe, mat) == "cg_pipe"
        assert solver_mod._route(bi, mat) == "bicgstab"
        slv = solver_mod.FoamSolver("p", {"solver": "GKOCG", "executor": "cpu",
                                          "matrixFormat": fmt})
        slv.matrix, slv._n = mat, 64
        with pytest.raises(TypeError, match=f"no merged-CG plan for the {fmt} format"):
            slv._kernel_plan()
    dia = formats.coo_to_dia(formats.coo_from_dense(ref_testing.poisson_dense((4, 4))))
    assert solver_mod._route(cfg, dia) == "cg_fused"


@pytest.mark.parametrize("fmt", FORMATS)
def test_spmv_launches_per_solve_follow_the_route(fmt, monkeypatch):
    """The SpMVs a general route makes on the card (chip_smoke gates them by
    launch counts): CG 2 set-up + 1 per iteration, pipelined CG 3 + 1,
    BiCGStab 2 + 2, plus the criterion's residual-eval timing (9)."""
    calls = []
    call = gather_spmv.GatherSpmv.__call__  # every format: one wrapper per solve
    monkeypatch.setattr(gather_spmv.GatherSpmv, "__call__",
                        lambda self, x: calls.append(1) or call(self, x))
    m = _knn()
    b = _rhs(m.n)
    for field, (extra, setup, per_iter) in {
            "c": ({}, 2, 1), "q": ({"pipelinedCG": True}, 3, 1),
            "u": ({"solver": "GKOBiCGStab"}, 2, 2)}.items():
        calls.clear()
        _, perf = foam.solve(field, m, b, _ctl(fmt, **extra))
        assert len(calls) == setup + per_iter * perf.n_iterations + 9


def test_auto_routing_keeps_the_references_error_at_scale():
    """From 32,768 rows an auto-routed Ell landing is the reference's
    RuntimeError, which now offers the explicit Ell format; pack_fast
    itself warns as the reference's does.  At 131,072 cells a scrambled
    coupling fits neither the Gdia planes nor the Xell window."""
    n = 1 << 17
    i = np.arange(n, dtype=np.int64)
    j = (i * 48271 + 11) % n
    own, nbr = np.minimum(i, j)[i != j], np.maximum(i, j)[i != j]
    key = np.unique(own * n + nbr)
    own, nbr = key // n, key % n
    deg = np.bincount(own, minlength=n) + np.bincount(nbr, minlength=n)
    m = ldu.LduMatrix(n=n, lower_addr=own, upper_addr=nbr, diag=deg + 1.0,
                      upper=np.full(len(own), -1.0))
    with pytest.warns(RuntimeWarning, match="fell to the gather Ell tier"):
        with pytest.raises(RuntimeError, match="set matrixFormat Ell explicitly"):
            foam.solve("p", m, _rhs(n), _ctl(None))
    x, perf = foam.solve("q", m, _rhs(n), _ctl("Ell"))
    assert perf.solver_name == "GKOCG_Ell" and perf.converged
