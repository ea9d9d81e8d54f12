"""The redesigned Sell and CSR SpMVs and the loops on Coo, Csr and Sell, on
the CPU, against the reference (`ogl_tpu`):

* the Sell twin, which stops each slot at its slice's longest row
  (`Sell.slice_widths`), within each row's float32 summation bound of the
  reference's `spmv_sell` (XLA) and bit-equal to the sum over the bucket's
  every lane on finite x (the skipped padding adds exact zeros);
* `slice_widths` and `slice_buckets` of `coo_to_sell`, against the slices'
  row counts, and as the interop bridge reads them back from the
  reference's padding — a row whose only entry is a stored zero on column 0
  included;
* the CG and general-BiCGStab loop kernels' twins on Csr, Coo and Sell
  (`CsrCgKernels`, `SellCgKernels` on CPU tensors) against the reference's
  loops over its XLA SpMV at 10 pinned iterations (relative 1e-4);
* `foam.solve` with `matrixFormat` Coo, Csr and Sell, `none` and `BJ`,
  GKOCG and GKOBiCGStab on a 3,000-cell kNN-6 mesh against
  `ogl_tpu.foam.solve`: iterations ±1, the true residual within 10 × the
  tolerance, the solver keeping the format's plan;
* `why_not` naming a Csr whose SpMV takes more than one lane per row.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ogl_tpu import foam as ref_foam
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.solve.bicgstab import bicgstab as ref_bicgstab
from ogl_tpu.solve.cg import cg as ref_cg
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, interop, registry, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import gather_spmv, spmv
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels, gather_k1_plain
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

cg_mod = importlib.import_module("ogl_tpu_torch.solve.cg")
bicgstab_mod = importlib.import_module("ogl_tpu_torch.solve.bicgstab")

TOL = 1e-6
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)
PORT = {"Coo": formats.coo_to_device, "Csr": formats.coo_to_csr, "Sell": formats.coo_to_sell}
REF = {"Coo": lambda c: c, "Csr": ref_formats.coo_to_csr, "Sell": ref_formats.coo_to_sell}
PLANS = {"Coo": CsrCgKernels, "Csr": CsrCgKernels, "Sell": SellCgKernels}


def _knn_ldu(n=3000):
    m, perm = testing.knn_ldu(n)
    return testing.renumber_ldu(m, np.argsort(perm))


def _many_widths(n=300, seed=3):
    """Rows of 0..24 entries in runs of four, so that slices of 4 rows take
    more than 8 distinct widths and the buckets round them to powers of
    two."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        k = (i // 4) % 25
        a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
    return a


def _mats():
    """name -> (reference Coo, port host Coo)."""
    knn = ldu.ldu_to_coo_host(_knn_ldu(), dtype=np.float32)
    ref_knn = ref_formats.Coo(rows=jnp.asarray(knn.rows), cols=jnp.asarray(knn.cols),
                              vals=jnp.asarray(knn.vals), shape=knn.shape)
    a = _many_widths()
    return {"knn": (ref_knn, knn),
            "many widths": (ref_formats.coo_from_dense(a), formats.coo_from_dense(a))}


MATS = _mats()


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _every_lane(m, x):
    """The Sell SpMV over every lane of each bucket (the twin before the
    slice stops), lane by lane from 0.0."""
    y = torch.zeros(m.shape[0] + 1, dtype=x.dtype)
    C = m.slice_height
    for (s0, v0, w), ns in zip(formats.sell_table(m.widths, m.n_slices, C).tolist(),
                               m.n_slices):
        slots = ns * C
        vb = m.vals[v0:v0 + w * slots].view(w, slots)
        cb = m.cols[v0:v0 + w * slots].view(w, slots).long()
        acc = torch.zeros(slots, dtype=x.dtype)
        for k in range(w):
            acc = acc + vb[k] * x[cb[k]]
        y[m.slot_rows[s0:s0 + slots].long()] = acc
    return y[:-1]


@pytest.mark.parametrize("c", [8, 4])
@pytest.mark.parametrize("name", list(MATS))
def test_sell_twin_stops_at_slice_widths(name, c):
    ref_coo, coo = MATS[name]
    m = formats.coo_to_sell(coo, c)
    bucket_w = torch.tensor(m.widths)[m.slice_buckets.long()]
    assert bool((m.slice_widths <= bucket_w).all())
    if name == "many widths":  # the rounded buckets leave padding to skip
        assert bool((m.slice_widths < bucket_w).any())
    x = np.random.default_rng(3).normal(size=m.shape[0]).astype(np.float32)
    xt = torch.tensor(x)
    y = spmv.spmv(m, xt)
    assert torch.equal(y, _every_lane(m, xt))
    a = formats.to_dense(m).astype(np.float64)
    terms = np.abs(a) @ np.abs(x.astype(np.float64))
    bound = 2 * np.maximum(np.count_nonzero(a, axis=1), 1) * 2.0 ** -24 * terms + 1e-30
    y_ref = np.asarray(ref_spmv.spmv(ref_formats.coo_to_sell(ref_coo, c), jnp.asarray(x)))
    assert np.all(np.abs(y.numpy() - y_ref) <= bound)
    assert np.all(np.abs(y.numpy() - a @ x) <= bound)


def _with_column0_zero_row(a):
    """A host Coo of `a` plus row 5 made of one stored zero on column 0."""
    a = a.copy()
    a[5] = 0.0
    rows, cols = np.nonzero(a)
    rows, cols = np.append(rows, 5), np.append(cols, 0)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    return rows.astype(np.int32), cols.astype(np.int32), a[rows, cols]


@pytest.mark.parametrize("c, sigma", [(8, 64), (4, 1)])
@pytest.mark.parametrize("name", ["knn", "many widths"])
def test_sell_slices_from_conversion_and_from_the_bridge(name, c, sigma):
    """slice_widths: each slice's longest row, at least 1; slice_buckets:
    each slice's bucket.  The bridge reads the same from the reference's
    padding, the row whose only entry is (5, 0) = 0 included; value updates
    carry both."""
    if name == "knn":
        coo = MATS["knn"][1]
        rows, cols, vals = coo.rows, coo.cols, coo.vals
    else:
        rows, cols, vals = _with_column0_zero_row(_many_widths())
    n = int(rows.max()) + 1 if name == "knn" else 300
    coo = formats.Coo(rows=rows, cols=cols, vals=vals, shape=(n, n))
    m = formats.coo_to_sell(coo, c, sigma)
    counts = np.append(np.bincount(rows.astype(np.int64), minlength=n), 0)
    per_slot = counts[m.slot_rows.numpy()].reshape(-1, c)
    np.testing.assert_array_equal(m.slice_widths.numpy(), np.maximum(per_slot.max(axis=1), 1))
    np.testing.assert_array_equal(m.slice_buckets.numpy(),
                                  np.repeat(np.arange(len(m.widths)), m.n_slices))
    assert m.slice_widths.dtype == torch.int32 and m.slice_buckets.dtype == torch.uint8
    ref = ref_formats.coo_to_sell(ref_formats.Coo(
        rows=jnp.asarray(rows), cols=jnp.asarray(cols), vals=jnp.asarray(vals), shape=(n, n)),
        c, sigma)
    bridged = interop.sell_from_reference(ref)
    assert torch.equal(bridged.slice_widths, m.slice_widths)
    assert torch.equal(bridged.slice_buckets, m.slice_buckets)
    new = formats.with_values(m, formats.values_flat(m) * 2.0)
    assert new.slice_widths is m.slice_widths and new.slice_buckets is m.slice_buckets
    vmap = formats.value_map(m, rows, cols)
    assert vmap.update(m, torch.tensor(np.asarray(vals) * 3.0)).slice_widths is m.slice_widths


def _system(fmt):
    """(reference matrix, port matrix, b, invd) of the 3,000-cell kNN-6
    mesh (RCM-numbered; SPD) in `fmt`."""
    ref_coo, coo = MATS["knn"]
    n = coo.shape[0]
    diag = np.zeros(n, np.float32)
    on = coo.rows == coo.cols
    diag[coo.rows[on]] = coo.vals[on]
    b = np.random.default_rng(0).normal(size=n).astype(np.float32)
    return REF[fmt](ref_coo), PORT[fmt](coo), b, (1.0 / diag).astype(np.float32)


def _ref_solve(solver, ref_mat, b, cfg, invd):
    pc = None if invd is None else (lambda r: jnp.asarray(invd) * r)
    ops = ref_ops(lambda v: ref_spmv.spmv(ref_mat, v), len(b), precond=pc)
    res = solver(ops, jnp.asarray(b), jnp.zeros(len(b), jnp.float32), cfg)
    return np.asarray(res.x), int(res.iters)


def _ops(mat, invd):
    return single_device_ops(spmv.matvec(mat), mat.shape[0],
                             precond=None if invd is None else (lambda r: invd * r))


@pytest.mark.parametrize("loop", ["cg", "bicgstab"])
@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("fmt", list(PORT))
def test_loop_twins_match_the_reference_at_pinned_iterations(fmt, pc, loop):
    """The plan's `cg_loop` (from solve/cg.py's set-up) and
    `bicgstab_gen_loop` (through solve/bicgstab.py) on CPU tensors: 10
    iterations, x within rtol 1e-4 of the reference's loop over its XLA
    SpMV."""
    ref_mat, mat, b, invd_np = _system(fmt)
    invd = None if pc == "none" else torch.tensor(invd_np)
    kern = PLANS[fmt].for_matrix(mat)
    assert type(kern) is PLANS[fmt]
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    params = stopping.StoppingParams.of(PINNED)
    if loop == "cg":
        x = torch.zeros_like(bt)
        r = bt - kern.apply(data, x)
        z = r if invd is None else invd * r
        nf = stopping.initial_norm_factor(_ops(mat, invd), r, x, bt)
        iters, *_ = kern.cg_loop(data, x, r, torch.sum(r * z), torch.sum(torch.abs(r)), nf,
                                 params, invd=invd, z=None if invd is None else z)
        solver = ref_cg
    else:
        res = bicgstab_mod.bicgstab(_ops(mat, invd), bt, torch.zeros_like(bt), params, kern,
                                    data, invd)
        x, iters = res.x, res.iters
        solver = ref_bicgstab
    x_ref, it_ref = _ref_solve(solver, ref_mat, b, PINNED, None if invd is None else invd_np)
    assert iters == it_ref == 10
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4, atol=1e-4 * np.abs(x_ref).max())


@pytest.mark.parametrize("fmt", ["Csr", "Sell"])
def test_plan_k1_is_the_twins_k1(fmt):
    """On CPU tensors the plan's K1 is `gather_k1_plain` on its matrix, bit
    for bit (the loop kernel's K1 phase rounds as this twin does); the plan
    refuses another sparsity."""
    _, mat, b, _ = _system(fmt)
    kern = PLANS[fmt].for_matrix(mat)
    data = kern.pack_values(mat)
    z, p = torch.tensor(b), torch.tensor(b[::-1].copy())
    beta = torch.tensor(0.37)
    for got, want in zip(kern.k1(data, z, p, beta), gather_k1_plain(mat, z, p, beta)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sparsity"):
        kern.pack_values(PORT[fmt](formats.coo_from_dense(np.eye(5, dtype=np.float32))))


def _residual(m, x, b):
    coo = ldu.ldu_to_coo_host(m)
    ax = np.zeros(m.n)
    np.add.at(ax, coo.rows, coo.vals * x[coo.cols].astype(np.float64))
    return np.abs(b - ax).sum() / np.abs(b).sum()


@pytest.mark.parametrize("solver", ["GKOCG", "GKOBiCGStab"])
@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("fmt", list(PORT))
def test_foam_solve_on_the_format_keeps_its_plan_and_matches_the_reference(fmt, pc, solver):
    m = _knn_ldu()
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "executor": "cpu", "tolerance": TOL, "relTol": 0,
           "matrixFormat": fmt,
           "preconditioner": {"none": "none", "BJ": {"preconditioner": "BJ"}}[pc]}
    ref_m = ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                              diag=m.diag, upper=m.upper, lower=m.lower)
    _, perf_ref = ref_foam.solve("p", ref_m, b, ctl)
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert type(slv.kern) is PLANS[fmt]
    assert perf.solver_name == perf_ref.solver_name == f"{solver}_{fmt}"
    assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1
    assert _residual(m, x.numpy(), b) <= 10 * TOL


def test_why_not_names_a_csr_of_long_rows():
    """From CSR_GROUP_FROM entries per row on mean the CSR SpMV takes G > 1
    lanes per row: Csr and Coo keep the host loop, why_not says why, and the
    plan refuses the matrix; Sell takes its loop kernel on the same rows."""
    n, width = 64, gather_spmv.CSR_GROUP_FROM
    rows = np.repeat(np.arange(n), width)
    cols = (rows + np.tile(np.arange(width), n)) % n
    order = np.lexsort((cols, rows))
    coo = formats.Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                      vals=np.ones(n * width, np.float32), shape=(n, n))
    for conv, name in ((formats.coo_to_csr, "Csr"), (formats.coo_to_device, "Coo")):
        m = conv(coo)
        assert gather_spmv.csr_group(n, m.nnz) > 1
        for why_not in (cg_mod.why_not, bicgstab_mod.why_not):
            reason = why_not(m, "none")
            assert name in reason and "lanes per row" in reason
        with pytest.raises(ValueError, match="lanes per row"):
            CsrCgKernels.for_matrix(m)
    sell = formats.coo_to_sell(coo)
    assert cg_mod.why_not(sell, "BJ") is None and bicgstab_mod.why_not(sell, "none") is None
