"""The redesigned Ell row body and the loops on Ell and Hybrid, on the CPU:

* `Ell.warp_slots`, the longest row of each 32-row group, against the row
  counts (kNN-6 meshes, and a matrix of ragged rows whose last warp is
  partial), carried by `with_values` and the value map, and read back from
  the reference's padding by the interop bridge;
* the twins `spmv_ell`/`spmv_hybrid`, which stop each row at its group's
  count, bit-equal to a sum over every slot on finite x (the skipped
  padding adds exact zeros), and within each row's summation bound of the
  reference's `spmv_ell`/`spmv_hybrid` (XLA);
* the CG loop kernel's twin on Ell and Hybrid (`EllCgKernels.cg_loop` on
  CPU tensors: `cg_loop_plain` over the plan's K1) against solve/cg.py's
  host route and the reference's CG over its Ell SpMV on the same kNN
  system: ±1 iteration, x within 1e-4 (the merged order sums ρ and ‖r‖₁
  from K2's r', the host loop from r: the values agree, the rounding of the
  reductions does not);
* the general-BiCGStab loop's twin on Ell and Hybrid against the
  reference's BiCGStab on a kNN mesh: ±1 iteration and x within 1e-3
  free-running (one checked iteration apart is what a float32 BiCGStab
  stop can move), x within rtol 1e-4 at 10 pinned iterations;
* `why_not` of both routes and the foam solver's plan selection.
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
from ogl_tpu_torch.kernels import amg_loop, gather_spmv, spmv
from ogl_tpu_torch.kernels.ell import EllCgKernels, ell_k1_plain
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

cg_mod = importlib.import_module("ogl_tpu_torch.solve.cg")
bicgstab_mod = importlib.import_module("ogl_tpu_torch.solve.bicgstab")

PORT = {"Ell": formats.coo_to_ell, "Hybrid": formats.coo_to_hybrid}
REF = {"Ell": ref_formats.coo_to_ell, "Hybrid": ref_formats.coo_to_hybrid}
FROM_REF = {"Ell": interop.ell_from_reference, "Hybrid": interop.hybrid_from_reference}
FREE = StoppingConfig(tolerance=1e-6, rel_tol=0.0, max_iter=400)
GATED = StoppingConfig(tolerance=1e-6, rel_tol=0.0, min_iter=4, max_iter=400, frequency=3)
PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)


def _knn_coo(n, rcm=True):
    m, perm = testing.knn_ldu(n)
    if rcm:
        m = testing.renumber_ldu(m, np.argsort(perm))
    return ldu.ldu_to_coo_host(m, dtype=np.float32)


def _ragged_dense(n=203):
    """Rows of 0 to 40 entries in runs that vary from one 32-row group to
    the next (the last group partial: 203 = 6 · 32 + 11); a diagonal on
    every row but the empty ones."""
    rng = np.random.default_rng(5)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        k = (i * 13 + (i // 32) * 7) % 41
        a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
    return a


def _dense_coo(a):
    return ref_formats.coo_from_dense(a), formats.coo_from_dense(a)


def _mats():
    """name -> (reference Coo, port Coo)."""
    knn = _knn_coo(3000)
    ref_knn = ref_formats.Coo(rows=jnp.asarray(knn.rows), cols=jnp.asarray(knn.cols),
                              vals=jnp.asarray(knn.vals), shape=knn.shape)
    return {"knn": (ref_knn, knn), "ragged": _dense_coo(_ragged_dense())}


MATS = _mats()


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _ell_of(m):
    return m.ell if isinstance(m, formats.Hybrid) else m


def _all_slots(m, x):
    """The SpMV over every slot (the twins before the warp counts): Ell
    slot by slot from 0.0, then a Hybrid's tail entries in row order."""
    ell = _ell_of(m)
    y = torch.zeros(m.shape[0], dtype=x.dtype)
    for k in range(ell.row_width):
        y = y + ell.vals[k] * x[ell.cols[k].long()]
    if isinstance(m, formats.Hybrid):
        rp = m.tail.row_ptr.long()
        rows = torch.repeat_interleave(torch.arange(m.shape[0]), rp.diff())
        pos = torch.arange(rows.numel()) - rp[rows]
        y = gather_spmv._add_in_steps(y, rows, pos, m.tail.vals * x[m.tail.cols.long()])
    return y


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("fmt", list(PORT))
def test_warp_slots_are_each_groups_longest_row(fmt, name):
    """warp_slots[g] is the longest row (cut at the Ell width) of rows
    32g .. 32g + 31; value updates carry it, and the interop bridge reads
    the same counts back from the reference's padding."""
    ref_coo, coo = MATS[name]
    m = PORT[fmt](coo)
    ell = _ell_of(m)
    n, k = m.shape[0], ell.row_width
    counts = np.minimum(np.bincount(np.asarray(coo.rows, np.int64), minlength=n), k)
    want = [counts[g:g + 32].max() for g in range(0, n, 32)]
    assert ell.warp_slots.dtype == torch.int32 and ell.warp_slots.tolist() == want
    assert int(ell.warp_slots.max()) == k
    if fmt == "Ell":  # a Hybrid's bulk, at its 80th-percentile width, fills every group
        assert int(ell.warp_slots.min()) < k
    new = formats.with_values(m, formats.values_flat(m) * 2.0)
    assert _ell_of(new).warp_slots is ell.warp_slots
    vmap = formats.value_map(m, coo.rows, coo.cols)
    updated = testing.entries_update(vmap, m, torch.tensor(np.asarray(coo.vals) * 3.0))
    assert _ell_of(updated).warp_slots is ell.warp_slots
    assert torch.equal(_ell_of(formats.cast_values(m, torch.float64)).warp_slots,
                       ell.warp_slots)
    bridged = _ell_of(FROM_REF[fmt](REF[fmt](ref_coo)))
    assert torch.equal(bridged.warp_slots, ell.warp_slots)


def _stored_zero_diagonal():
    """(rows, cols, vals) of a 40 x 40 matrix, row-major: row 0 has an
    explicit zero inside it (not stored), row 33 the entry (33, 20) and a
    stored zero on its diagonal, last in its row — which the bridge cannot
    tell from padding."""
    a = np.zeros((40, 40), np.float32)
    a[0, :5] = [1.0, 2.0, 0.0, 4.0, 5.0]
    a[33, 20] = 1.0
    rows, cols = np.nonzero(a)
    rows = np.append(rows, 33)
    cols = np.append(cols, 33)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], a[rows, cols][order]


def test_interop_reads_rows_from_the_padding_alone():
    """Row 0 ends in an entry above its own column: its 4 slots.  Row 33's
    last entry (column 20) lies below its own, so the slot after it could be
    a stored zero on the diagonal (here it is one): the bridge counts it, 2
    slots, where counting 1 would drop that entry once its value changes."""
    rows, cols, vals = _stored_zero_diagonal()
    ref = ref_formats.coo_to_ell(ref_formats.Coo(
        rows=jnp.asarray(rows), cols=jnp.asarray(cols), vals=jnp.asarray(vals),
        shape=(40, 40)))
    assert interop.ell_from_reference(ref).warp_slots.tolist() == [4, 2]


@pytest.mark.parametrize("fmt", list(PORT))
def test_bridged_matrix_keeps_a_stored_zero_diagonal_after_a_value_update(fmt):
    """Bridge a reference Ell (Hybrid, width 2: row 0 goes on in the tail),
    then make the stored-zero diagonal 5 by `with_values`: the twin, the
    plan's SpMV and K1 equal to_dense(m) @ x and the reference's SpMV on the
    same values."""
    rows, cols, vals = _stored_zero_diagonal()
    ref_coo = ref_formats.Coo(rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                              vals=jnp.asarray(vals), shape=(40, 40))
    ref = ref_formats.coo_to_ell(ref_coo) if fmt == "Ell" else ref_formats.coo_to_hybrid(
        ref_coo, 2)
    m = FROM_REF[fmt](ref)
    flat = formats.values_flat(m).clone()
    ell = _ell_of(m)
    slot = int(np.flatnonzero(ell.cols[:, 33].numpy() == 33)[0])  # its first own-column slot
    flat[slot * 40 + 33] = 5.0
    m = formats.with_values(m, flat)
    new_vals = np.where((rows == 33) & (cols == 33), 5.0, vals).astype(np.float32)
    ref_flat = np.asarray(ref_formats.values_flat(ref)).copy()
    ref_flat[33 * ell.row_width + slot] = 5.0  # the reference's (n, K) Ell storage
    ref_new = ref_formats.with_values(
        ref, jnp.asarray(ref_flat.reshape(ref.vals.shape) if fmt == "Ell" else ref_flat))
    x = np.linspace(0.5, 2.0, 40).astype(np.float32)
    dense = formats.to_dense(m).astype(np.float64)
    want = np.zeros((40, 40))
    np.add.at(want, (rows, cols), new_vals)
    np.testing.assert_array_equal(dense, want)
    y_ref = np.asarray(ref_spmv.spmv(ref_new, jnp.asarray(x)))
    kern = EllCgKernels.for_matrix(m)
    data = kern.pack_values(m)
    xt = torch.tensor(x)
    for y in (spmv.spmv(m, xt), kern.spmv(data, xt), kern.k1(data, xt, torch.zeros(40), 0.0)[1]):
        np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-6)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-6)
    assert float(y_ref[33]) == 1.0 * x[20] + 5.0 * x[33]


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("fmt", list(PORT))
def test_twins_equal_every_slots_sum_and_the_reference(fmt, name):
    """The twins stop at the group's count: bit-equal to the sum over every
    slot on finite x (the padding past the count adds zeros), and within
    each row's float32 summation bound of the reference's XLA SpMV."""
    ref_coo, coo = MATS[name]
    m = PORT[fmt](coo)
    x = np.random.default_rng(3).normal(size=m.shape[0]).astype(np.float32)
    y = spmv.spmv(m, torch.tensor(x))
    assert torch.equal(y, _all_slots(m, torch.tensor(x)))
    a = formats.to_dense(m).astype(np.float64)
    terms = np.abs(a) @ np.abs(x.astype(np.float64))
    bound = 2 * np.maximum(np.count_nonzero(a, axis=1), 1) * 2.0 ** -24 * terms + 1e-30
    y_ref = np.asarray(ref_spmv.spmv(REF[fmt](ref_coo), jnp.asarray(x)))
    assert np.all(np.abs(y.numpy() - y_ref) <= bound)
    assert np.all(np.abs(y.numpy() - a @ x) <= bound)


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


@pytest.mark.parametrize("cfg", [FREE, GATED], ids=["free", "frequency3_minIter4"])
@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("fmt", list(PORT))
def test_cg_loop_twin_matches_host_cg_and_the_reference(fmt, pc, cfg):
    ref_mat, mat, b, invd_np = _system(fmt)
    invd = None if pc == "none" else torch.tensor(invd_np)
    params = stopping.StoppingParams.of(cfg)
    bt = torch.tensor(b)
    host = cg_mod.cg(_ops(mat, invd), bt, torch.zeros_like(bt), params)
    kern = EllCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    x = torch.zeros_like(bt)
    r = bt - kern.apply(data, x)
    z = r if invd is None else invd * r
    nf = stopping.initial_norm_factor(_ops(mat, invd), r, x, bt)
    iters, rn, _, conv = kern.cg_loop(data, x, r, torch.sum(r * z), torch.sum(torch.abs(r)),
                                      nf, params, invd=invd, z=None if invd is None else z)
    x_ref, it_ref = _ref_solve(ref_cg, ref_mat, b, cfg, None if invd is None else invd_np)
    assert bool(conv) and float(rn) < 1e-6
    assert abs(iters - host.iters) <= cfg.frequency and abs(iters - it_ref) <= cfg.frequency
    np.testing.assert_allclose(x.numpy(), host.x.numpy(), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-4)


def test_cg_loop_twin_is_the_k1_of_the_ell_twin():
    """On CPU tensors the plan's K1 is `ell_k1_plain` on its matrix, bit for
    bit (the loop kernel's K1 phase rounds as this twin does)."""
    _, mat, b, _ = _system("Hybrid")
    kern = EllCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    z, p = torch.tensor(b), torch.tensor(b[::-1].copy())
    beta = torch.tensor(0.37)
    for got, want in zip(kern.k1(data, z, p, beta), ell_k1_plain(mat, z, p, beta)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("fmt", list(PORT))
def test_bicgstab_loop_twin_matches_the_reference(fmt, pc):
    ref_mat, mat, b, invd_np = _system(fmt)
    invd = None if pc == "none" else torch.tensor(invd_np)
    kern = EllCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    for cfg in (FREE, PINNED):
        res = bicgstab_mod.bicgstab(_ops(mat, invd), bt, torch.zeros_like(bt),
                                    stopping.StoppingParams.of(cfg), kern, data, invd)
        x_ref, it_ref = _ref_solve(ref_bicgstab, ref_mat, b, cfg,
                                   None if invd is None else invd_np)
        if cfg is PINNED:
            assert res.iters == it_ref == 10
            np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(x_ref).max())
        else:
            assert bool(res.converged) and abs(res.iters - it_ref) <= 1
            np.testing.assert_allclose(res.x.numpy(), x_ref, atol=1e-3)


def test_bicgstab_plan_on_the_cpu_runs_the_twin_over_the_plan():
    """`EllCgKernels.bicgstab_gen_loop` on CPU tensors: the host loop's
    twin over the plan's SpMV, the same iterate as solve/bicgstab.py."""
    _, mat, b, invd_np = _system("Ell")
    kern = EllCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    invd = torch.tensor(invd_np)
    bt = torch.tensor(b)
    params = stopping.StoppingParams.of(FREE)
    host = bicgstab_mod.bicgstab(_ops(mat, invd), bt, torch.zeros_like(bt), params)
    x = torch.zeros_like(bt)
    ops = _ops(mat, invd)
    r = bt - ops.matvec(x)
    rhat = r.clone()
    nf = stopping.initial_norm_factor(ops, r, x, bt)
    iters, *_ = kern.bicgstab_gen_loop(data, x, r, rhat, torch.sum(rhat * r),
                                       torch.sum(torch.abs(r)), nf, params, invd)
    assert iters == host.iters and torch.equal(x, host.x)


def test_cg_loop_refuses_half_a_jacobi_set_up():
    _, mat, b, invd_np = _system("Ell")
    kern = EllCgKernels.for_matrix(mat)
    x = torch.zeros(len(b))
    with pytest.raises(ValueError, match="invd and z"):
        kern.cg_loop(kern.pack_values(mat), x, x.clone(), *(torch.ones(()),) * 3,
                     stopping.StoppingParams.of(FREE), invd=torch.tensor(invd_np))
    with pytest.raises(ValueError, match="sparsity"):
        kern.pack_values(PORT["Hybrid"](MATS["knn"][1]))


def test_why_not_admits_ell_and_hybrid_with_none_and_bj():
    """Ell, Hybrid and Sell with `none` and `BJ` take their loop kernels; the
    ragged rows (20 entries on mean) as Csr or Coo keep the host loop, since
    their SpMV takes more than one lane per row, and why_not says so."""
    _, coo = MATS["ragged"]
    for fmt in ("Ell", "Hybrid", "Sell"):
        m = PORT[fmt](coo) if fmt in PORT else formats.coo_to_sell(coo)
        for why_not in (cg_mod.why_not, bicgstab_mod.why_not):
            assert why_not(m, "none") is None and why_not(m, "BJ") is None
            assert "Multigrid" in why_not(m, "Multigrid")
    for conv, name in ((formats.coo_to_csr, "Csr"), (formats.coo_to_device, "Coo"),):
        m = conv(coo)
        for why_not in (cg_mod.why_not, bicgstab_mod.why_not):
            assert name in why_not(m, "none") and "lanes per row" in why_not(m, "none")
    dia = formats.coo_to_dia(formats.coo_from_dense(np.eye(4, dtype=np.float32)))
    assert "Dia" in cg_mod.why_not(dia, "none") and bicgstab_mod.why_not(dia, "none") is None


CONTROLS = {
    "cg Ell none": ({"matrixFormat": "Ell"}, EllCgKernels),
    "cg Hybrid BJ": ({"matrixFormat": "Hybrid", "preconditioner": {"preconditioner": "BJ"}},
                     EllCgKernels),
    "bicgstab Ell BJ": ({"solver": "GKOBiCGStab", "matrixFormat": "Ell",
                         "preconditioner": {"preconditioner": "BJ"}}, EllCgKernels),
    "bicgstab Hybrid none": ({"solver": "GKOBiCGStab", "matrixFormat": "Hybrid"},
                             EllCgKernels),
    "cg Ell landing": ({}, EllCgKernels),
    "cg Coo": ({"matrixFormat": "Coo"}, CsrCgKernels),
    "cg Csr BJ": ({"matrixFormat": "Csr", "preconditioner": {"preconditioner": "BJ"}},
                  CsrCgKernels),
    "bicgstab Sell": ({"solver": "GKOBiCGStab", "matrixFormat": "Sell"}, SellCgKernels),
    "pipelined Ell": ({"matrixFormat": "Ell", "pipelinedCG": True}, None),
    "pipelined Hybrid BJ": ({"matrixFormat": "Hybrid", "pipelinedCG": True,
                             "preconditioner": {"preconditioner": "BJ"}}, None),
}


@pytest.mark.parametrize("case", list(CONTROLS))
def test_foam_solver_takes_the_ell_plan_where_its_loops_run(case):
    """Ell and Hybrid (explicit, or the ladder's Ell landing) with `none` or
    `BJ` on GKOCG and GKOBiCGStab keep the plan EllCgKernels, Coo and Csr
    CsrCgKernels, Sell SellCgKernels; the pipelined CG keeps none.  The
    routes and names are the reference's, and the CPU solve (the twins)
    matches its iterations ±1."""
    extra, plan = CONTROLS[case]
    m, _ = testing.knn_ldu(3000)
    if "landing" not in case:
        m = testing.renumber_ldu(m, np.argsort(testing.knn_ldu(3000)[1]))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "executor": "cpu", "tolerance": 1e-6, "relTol": 0,
           "preconditioner": "none", **extra}
    x, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.kern is None if plan is None else type(slv.kern) is plan
    ref_m = ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                              diag=m.diag, upper=m.upper, lower=m.lower)
    ref_ctl = {**ctl, "matrixFormat": "Ell"} if "landing" in case else ctl
    _, perf_ref = ref_foam.solve("p", ref_m, b, ref_ctl)
    fmt = extra.get("matrixFormat", "Ell")
    assert perf.solver_name == f"{ctl['solver']}_{fmt}"
    assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1


def test_multigrid_on_ell_stays_refused():
    """GKOCG + Multigrid on an Ell matrix once raised (ROADMAP.md A11, done):
    it now solves in the reference's iterations ±1 (float32 smoother
    packing), and the Ell CG loop kernel still refuses it — its phases apply
    identity or scalar Jacobi only.  The solver keeps the Ell plan for the
    AMG loop kernel instead (kernels/amg_loop.py, its Ell outer variant,
    which the hierarchy qualifies for); on the CPU the general CG's host
    loop runs, over the Ell SpMV's twin."""
    m, perm = testing.knn_ldu(3000)
    m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "executor": "cpu", "matrixFormat": "Ell", "tolerance": 1e-6,
           "relTol": 0, "preconditioner": {"preconditioner": "Multigrid",
                                           "precision": "float32"}}
    _, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert slv.route == "cg" and type(slv.kern) is EllCgKernels
    assert cg_mod.why_not(slv.matrix, "Multigrid") == "preconditioner Multigrid"
    assert amg_loop.why_not(slv._precond_op, slv.kern) is None
    ref_m = ref_ldu.LduMatrix(n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
                              diag=m.diag, upper=m.upper, lower=m.lower)
    _, perf_ref = ref_foam.solve("p", ref_m, b, ctl)
    assert perf.solver_name == "GKOCG_Ell"
    assert perf.converged and abs(perf.n_iterations - perf_ref.n_iterations) <= 1
