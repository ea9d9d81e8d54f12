"""The device V-cycle's plain twins (ogl_tpu_torch/kernels/amg_loop.py) on
the CPU: against the port's host route, against the reference's foam
solves, the predicate that picks the loop, and the level table.

Tolerances.  Twin against host route: the same plain functions in the same
order (the twin only runs the cycle after the check that would stop, whose
pass the host route discards), so iterations are equal and x, the final and
the initial residual bit-equal.  Twin against `ogl_tpu.foam.solve`: ±1
iteration with `precision float32` (a stop decision can flip on one ulp
of float32 sums taken in another order) and atol 1e-4 on x, as
tests/test_torch_amg.py; with the default bfloat16 smoother packing at
most 2 iterations more than the reference, whose CPU cycle is float32, and
the true residual below 1e-5 of ‖b‖₁."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import testing as ref_testing
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import amg_loop
from ogl_tpu_torch.kernels.dia_spmv import dia_spmv_plain
from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.precond import amg, amg_of
from ogl_tpu_torch.solve import cg_fused, ir, stopping
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor
from ogl_tpu_torch.solve.krylov import single_device_ops

torch.set_num_threads(2)

TOL = 1e-6
CFG = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0, max_iter=1000,
                              frequency=1)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _system(dims, aggregation, smoother_dtype, **kw):
    """(kern, data, b, op): the Poisson Dia of `dims`, its plan and packed
    data, a seeded b and the AMG op built from the same COO."""
    coo = ldu.ldu_to_coo_host(testing.poisson_ldu(dims), dtype=np.float32)
    mat = formats.coo_to_dia(coo)
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    b = torch.tensor(np.random.default_rng(0).normal(size=mat.shape[0]).astype(np.float32))
    op = amg.amg(coo, aggregation=aggregation, smoother_dtype=smoother_dtype, **kw)
    return kern, kern.pack_values(mat), b, op


def _twin(name, kern, data, b, op, cfg=CFG):
    """The loop wrapper on CPU tensors (its plain twin) from the set-up of
    solve/cg_fused.py: (x, iterations, final and initial residual)."""
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    nf = merged_norm_factor(kern, data, r, x, b)
    loop = amg_loop.amg_cg_loop if name == "cg" else amg_loop.amg_ir_loop
    kernels.reset_launches()
    it, rn, init_rn, conv = loop(kern, data, op, x, r, torch.sum(torch.abs(r)), nf, cfg)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    return x, it, rn, init_rn, conv


def _host_route(name, kern, data, b, op, cfg=CFG):
    """Today's host route: the merged CG with the cycle as z = M(r), or IR
    over the Dia SpMV, both over the plain kernels on CPU tensors."""
    if name == "cg":
        return cg_fused(kern, data, b, torch.zeros_like(b), cfg, precond=op)
    ops = single_device_ops(lambda v: dia_spmv_plain(data, kern.offsets, v), kern.n, precond=op)
    return ir(ops, b, torch.zeros_like(b), cfg)


# a box grid, a grid with odd axes (grid_restrict pads them), a natural
# hierarchy whose last aggregate is partial (17 x 13 x 11 = 2,431 rows)
HIERARCHIES = [((16, 16, 16), "auto"), ((17, 13, 11), "auto"), ((17, 13, 11), "natural")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,aggregation", HIERARCHIES, ids=str)
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_twin_matches_host_route(name, dims, aggregation, dtype):
    kern, data, b, op = _system(dims, aggregation, dtype)
    assert amg_loop.qualifies(op)
    if aggregation == "natural":
        assert op.state[0].natural and op.state[0].n % op.state[0].width != 0
    else:
        assert op.state[0].grid is not None
    x, it, rn, init_rn, conv = _twin(name, kern, data, b, op)
    host = _host_route(name, kern, data, b, op)
    assert bool(conv) and bool(host.converged) and it == host.iters
    torch.testing.assert_close(x, host.x, rtol=0, atol=0)
    torch.testing.assert_close(rn, host.final_res_norm, rtol=0, atol=0)
    torch.testing.assert_close(init_rn, host.init_res_norm, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["cg", "ir"])
def test_twin_pinned_and_gated_checks_match_host_route(name):
    """minIter/frequency gating and maxIter: the twin leaves where the host
    loop does and reports the same residuals."""
    kern, data, b, op = _system((12, 10, 9), "auto", torch.bfloat16)
    for cfg in (stopping.StoppingParams(0.0, 0.0, 7, 7, 1),
                stopping.StoppingParams(TOL, 0.0, 3, 1000, 4),
                stopping.StoppingParams(TOL, 1e-3, 0, 1000, 2)):
        x, it, rn, init_rn, _ = _twin(name, kern, data, b, op, cfg)
        host = _host_route(name, kern, data, b, op, cfg)
        assert it == host.iters
        torch.testing.assert_close(x, host.x, rtol=0, atol=0)
        torch.testing.assert_close(rn, host.final_res_norm, rtol=0, atol=0)


def _controls(solver, precision):
    ctl = {"executor": "cpu", "matrixFormat": "Dia", "tolerance": TOL, "relTol": 0,
           "adaptMinIter": False, "solver": "GKOCG" if solver == "cg" else "GKOMultigrid"}
    if solver == "cg":
        ctl["preconditioner"] = "Multigrid"
    # the Multigrid defaults of the foam front end (aggregation auto, rate 8);
    # "default" packs the smoother coefficients in bfloat16
    return ctl, PrecondConfig(name="Multigrid", value_precision=(
        "float32" if precision == "float32" else "default"))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(32, 16, 8), (17, 13, 11)], ids=str)
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_twin_matches_reference_solve(name, dims, precision):
    m = ref_testing.poisson_ldu(dims)
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl, pc = _controls(name, precision)
    x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
    coo = ldu.ldu_to_coo_host(interop.ldu_from_arrays(m.n, m.lower_addr, m.upper_addr, m.diag,
                                                      m.upper), dtype=np.float32)
    mat = formats.coo_to_dia(coo)
    kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    op = amg_of(pc, coo, "cpu")
    assert amg_loop.qualifies(op)
    x, it, rn, _, conv = _twin(name, kern, kern.pack_values(mat), torch.tensor(b), op)
    assert bool(conv) and perf_ref.converged and float(rn) < TOL
    if precision == "float32":
        assert abs(it - perf_ref.n_iterations) <= 1
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
    else:
        assert it <= perf_ref.n_iterations + 2
        a = ref_testing.poisson_dense(dims)
        assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5


# the unstructured meshes of tests/test_torch_amg_levels.py: the kNN-6 graph
# of 4,096 cells (Ell levels; RCM-numbered: natural runs of 8, the last
# level Dia) and the shuffled Poisson grid (16, 16, 32) (a Gdia fine level,
# then Ell, then Dia)
_MESHES: dict = {}


def _mesh(name):
    if name not in _MESHES:
        if name == "knn":
            m, perm = testing.knn_ldu(4096)
            _MESHES[name] = testing.renumber_ldu(m, np.argsort(perm))
        else:
            _MESHES[name] = testing.shuffled_poisson_ldu((16, 16, 32))
    return _MESHES[name]


def _outer_plan(fmt, coo):
    """(plan, packed values) of the outer matrix `fmt` of `coo` on the CPU,
    the plan foam/solver.py takes for it."""
    from ogl_tpu_torch.kernels import gdia, xell
    from ogl_tpu_torch.kernels.ell import EllCgKernels
    from ogl_tpu_torch.kernels.fused import GdiaCgKernels
    from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels

    if fmt == "Dia":
        mat = formats.coo_to_dia(coo)
        kern = CgKernels(mat.shape[0], mat.offsets, "cpu")
    elif fmt == "Gdia":
        mat = gdia.gdia_from_coo(coo)
        kern = GdiaCgKernels(mat.shape[0], mat.plane_offsets, "cpu")
    elif fmt == "Xell":
        mat = xell.xell_from_coo(coo)
        kern = xell.XellCgKernels.for_matrix(mat)
    else:
        conv = {"Csr": formats.coo_to_csr, "Coo": formats.coo_to_device, "Ell": formats.coo_to_ell,
                "Hybrid": formats.coo_to_hybrid, "Sell": formats.coo_to_sell}[fmt]
        mat = conv(coo)
        plan = {"Csr": CsrCgKernels, "Coo": CsrCgKernels, "Ell": EllCgKernels,
                "Hybrid": EllCgKernels, "Sell": SellCgKernels}[fmt]
        kern = plan.for_matrix(mat)
    return kern, kern.pack_values(mat)


@pytest.mark.parametrize("kw,why", [
    ({"cycle": "w"}, "cycle w"),
    ({"cycle": "f"}, "cycle f"),
    ({"aggregation": "pgm"}, "aggregation pgm"),
    ({"coarse_solver": "cg"}, "coarseSolver cg"),
    ({"smooth_iters": 0}, "smootherSweeps 0"),
    ({"max_levels": 0}, "a one-level hierarchy"),
    ({}, None),
    ({"aggregation": "natural"}, None),
    ({"smooth_iters": 1}, None),
    ({"mesh": "knn"}, None),
    ({"mesh": "shuffled"}, None),
    ({"mesh": "knn", "aggregation": "pgm"}, "aggregation pgm"),
    ({"mesh": "knn", "outer": "Csr"}, None),
    ({"mesh": "knn", "outer": "Coo"}, None),
    ({"mesh": "knn", "outer": "Ell"}, None),
    ({"mesh": "knn", "outer": "Hybrid"}, None),
    ({"mesh": "shuffled", "outer": "Gdia"}, None),
    ({"outer": "Dia"}, None),
    ({"mesh": "knn", "outer": "Dia"}, "a Dia outer over Gdia or Ell levels"),
    ({"mesh": "shuffled", "outer": "Dia"}, "a Dia outer over Gdia or Ell levels"),
    ({"mesh": "knn", "outer": "Xell"}, "the outer plan XellCgKernels"),
    ({"mesh": "knn", "outer": "Sell"}, "the outer plan SellCgKernels"),
    ({"mesh": "knn", "aggregation": "pgm", "outer": "Xell"}, "aggregation pgm"),
], ids=str)
def test_the_predicate_names_what_keeps_the_host_cycle(kw, why):
    """The first reason found, or None: on the Poisson grid (Dia levels), on
    the kNN mesh (Ell levels) and the shuffled grid (a Gdia level), without
    and with an outer plan (on those meshes a Dia outer is a banded plan of
    their size: its variants hold Dia levels only)."""
    kw = {"aggregation": "auto", **kw}
    mesh, outer = kw.pop("mesh", None), kw.pop("outer", None)
    if mesh is None:
        _, _, _, op = _system((12, 10, 8), smoother_dtype=torch.bfloat16, **kw)
        coo = ldu.ldu_to_coo_host(testing.poisson_ldu((12, 10, 8)), dtype=np.float32)
    else:
        coo = ldu.ldu_to_coo_host(_mesh(mesh), dtype=np.float32)
        op = amg.amg(coo, width=8, smoother_dtype=torch.bfloat16, **kw)
        kinds = {type(lv.mat).__name__ for lv in op.state[:-1]}
        assert kinds & ({"Ell"} if mesh == "knn" else {"Gdia"})
    if outer == "Dia" and mesh is not None:
        kern = CgKernels(coo.shape[0], (-1, 0, 1), "cpu")
    else:
        kern = None if outer is None else _outer_plan(outer, coo)[0]
    got = amg_loop.why_not(op, kern)
    assert (got is None) if why is None else got.startswith(why)
    assert amg_loop.qualifies(op, kern) == (why is None)


def test_takes_loop_needs_the_dia_plan_a_card_and_an_amg_op():
    """An outer plan of OUTER_PLANS itself (Dia, Gdia, Ell and Hybrid, Csr
    and Coo; not a subclass, not Xell or Sell), a CUDA tensor and an AmgOp
    that qualifies; a Dia plan only over Dia levels."""
    kern, data, b, op = _system((12, 10, 8), "auto", torch.bfloat16)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert not amg_loop.takes_loop(kern, op, b)  # CPU tensors: the host route
    assert amg_loop.takes_loop(kern, op, on_card)
    assert not amg_loop.takes_loop(kern, None, on_card)
    assert not amg_loop.takes_loop(kern, lambda r: r, on_card)

    class HostLoop(CgKernels):
        pass

    assert not amg_loop.takes_loop(HostLoop(kern.n, kern.offsets, "cpu"), op, on_card)
    coo = ldu.ldu_to_coo_host(_mesh("knn"), dtype=np.float32)
    knn_op = amg.amg(coo, width=8, aggregation="auto", smoother_dtype=torch.bfloat16)
    pgm_op = amg.amg(coo, width=8, aggregation="pgm", smoother_dtype=torch.bfloat16)
    for fmt in ("Csr", "Coo", "Ell", "Hybrid", "Xell", "Sell"):
        plan = _outer_plan(fmt, coo)[0]
        assert amg_loop.takes_loop(plan, knn_op, on_card) == (type(plan) in amg_loop.OUTER_PLANS)
        assert amg_loop.takes_loop(plan, knn_op, on_card) == (fmt not in ("Xell", "Sell"))
        assert not amg_loop.takes_loop(plan, pgm_op, on_card)
    assert not amg_loop.takes_loop(CgKernels(coo.shape[0], (-1, 0, 1), "cpu"), knn_op, on_card)
    with pytest.raises(ValueError, match="cycle w"):
        _, _, _, w = _system((12, 10, 8), "auto", torch.bfloat16, cycle="w")
        _twin("cg", kern, data, b, w)


def test_level_table_describes_the_hierarchy():
    _, _, _, op = _system((17, 13, 11), "auto", torch.bfloat16)
    tab = amg_loop.table_of(op)
    assert amg_loop.table_of(op) is tab and op.loop_table is tab
    assert tab.variant == amg_loop.VARIANT_BF16 and tab.n_levels == len(op.state)
    rows = tab.table.tolist()
    assert tab.table.shape == (len(op.state), amg_loop.FIELDS)
    for i, (lv, row) in enumerate(zip(op.state, rows)):
        assert row[3] == lv.n and row[4] == lv.inv_diag.data_ptr()
        if lv.nc:  # a smoothing level: coefficients, offsets, grid dims
            assert row[0] == lv.data_s.data_ptr() and row[2] == len(lv.mat.offsets)
            assert row[1] == lv.kern.plan.offsets_dev.data_ptr()
            assert row[9] == amg_loop.KIND_GRID and tuple(row[11:17]) == lv.grid
            assert row[5] and row[6] and (row[7] != 0) == (i > 0)
            assert row[17] == int(lv.n % 4 == 0)
        else:
            assert row[9] == amg_loop.KIND_COARSE and row[8] == lv.coarse_inv.data_ptr()
            assert row[17] == int(lv.n % 4 == 0) and row[7] != 0
    _, _, _, nat = _system((17, 13, 11), "natural", torch.float32)
    row = amg_loop.table_of(nat).table[0].tolist()
    assert amg_loop.table_of(nat).variant == 0
    assert row[9] == amg_loop.KIND_NATURAL and row[10] == nat.state[0].width


def test_level_table_is_rebuilt_with_the_hierarchy():
    """caching 0: a changed operator rebuilds the hierarchy, and the table
    of the new op points at the new hierarchy's tensors; an unchanged one
    keeps both."""
    m = testing.poisson_ldu((12, 10, 8))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"executor": "cpu", "tolerance": TOL, "relTol": 0, "solver": "GKOMultigrid"}
    tables = []
    for _ in range(2):
        foam.solve("p", m, b, ctl)
        op = registry.global_registry.get("p_solver")._precond_op
        tables.append((op, amg_loop.table_of(op)))
        m = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
    (op0, t0), (op1, t1) = tables
    assert op1 is not op0 and t1 is not t0 and op1.loop_table is t1
    assert int(t1.table[0, 4]) == op1.state[0].inv_diag.data_ptr() != int(t0.table[0, 4])
    foam.solve("p", dataclasses.replace(m, diag=np.asarray(m.diag) / 1.01), b, ctl)
    assert registry.global_registry.get("p_solver")._precond_op.loop_table is t1


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_phase_tool_names_every_barrier(name, sweeps):
    """python -m ogl_tpu_torch.amg_phases stamps the start and every grid
    barrier of csrc/amg_loop.cuh: one name per barrier of the kernel's
    phases — per cycle 2 s (levels − 1) + 1, and per CG iteration K1 and
    K2n, per IR iteration the residual."""
    from ogl_tpu_torch import amg_phases
    from ogl_tpu_torch.kernels import _build

    src = (_build.CSRC / "amg_loop.cuh").read_text()
    stamped = amg_phases.stamped_source(src)
    assert stamped.count("stamp();") == src.count("grid.sync();") + 1
    _, _, _, op = _system((16, 16, 16), "auto", torch.bfloat16, smooth_iters=sweeps)
    per_cycle = 2 * sweeps * (len(op.state) - 1) + 1
    names = amg_phases.phase_names(op, name == "ir", 3)
    want = 3 * (per_cycle + 1) if name == "ir" else 3 * per_cycle + 3 * 2
    assert len(names) == want
    assert names.count("K1") == (0 if name == "ir" else 3)


# ---- the device loop's twins over Gdia and Ell levels (slice 23) ----------------

UNSTRUCTURED = {"kNN Csr": ("knn", "Csr"), "kNN Ell": ("knn", "Ell"),
                "shuffled Gdia": ("shuffled", "Gdia")}


def _unstructured_twin(name, kern, data, b, op, cfg=CFG):
    """The loop wrapper on CPU tensors from the set-up of the routes: (x,
    iterations, final residual, converged)."""
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    nf = merged_norm_factor(kern, data, r, x, b)
    loop = amg_loop.amg_cg_loop if name == "cg" else amg_loop.amg_ir_loop
    kernels.reset_launches()
    it, rn, _, conv = loop(kern, data, op, x, r, torch.sum(torch.abs(r)), nf, cfg)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    return x, it, rn, conv


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(UNSTRUCTURED))
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_twin_on_unstructured_levels_matches_host_route_and_reference(name, case, precision):
    """The loop's twin on the kNN-6 mesh (Csr and Ell outer, Ell levels) and
    the shuffled grid (Gdia outer, a Gdia fine level) against the port's
    host route on the same plan — the merged CG (Gdia) and Richardson over
    the plan's SpMV: the same functions in the same order, so the same
    iterations and bits; the general CG (Csr, Ell): its reductions in
    another order, ±1 iteration — and against `ogl_tpu.foam.solve`, with the
    tolerances of tests/test_torch_amg_levels.py: ±1 iteration with
    `precision float32`, from 1 below to 2 above with the default bfloat16
    packing, the true residual below 1e-4 of ‖b‖₁."""
    import scipy.sparse as sp

    from ogl_tpu_torch.solve.cg import cg

    mesh, fmt = UNSTRUCTURED[case]
    m = _mesh(mesh)
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    kern, data = _outer_plan(fmt, coo)
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    op = amg.amg(coo, max_levels=9, min_coarse_rows=10, aggregation="auto", width=8,
                 smoother_dtype=dtype)
    assert amg_loop.qualifies(op, kern)
    b_np = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    b = torch.tensor(b_np)
    x, it, rn, conv = _unstructured_twin(name, kern, data, b, op)
    assert bool(conv) and float(rn) < TOL
    x0 = torch.zeros_like(b)
    if name == "ir":
        host = ir(single_device_ops(functools.partial(kern.spmv, data), kern.n, precond=op),
                  b, x0, CFG)
    elif fmt == "Gdia":
        host = cg_fused(kern, data, b, x0, CFG, precond=op)
    else:
        host = cg(single_device_ops(functools.partial(kern.spmv, data), kern.n, precond=op),
                  b, x0, CFG, kern, data, precond=op)
    assert bool(host.converged)
    if name == "ir" or fmt == "Gdia":
        assert it == host.iters
        torch.testing.assert_close(x, host.x, rtol=0, atol=0)
    else:
        assert abs(it - host.iters) <= 1
        torch.testing.assert_close(x, host.x, rtol=0, atol=1e-4 * max(1.0, float(x.abs().max())))
    pc = {"preconditioner": "Multigrid" if name == "cg" else "none", "aggregation": "auto"}
    if precision == "float32":
        pc["precision"] = "float32"
    ctl = {"executor": "cpu", "solver": "GKOCG" if name == "cg" else "GKOMultigrid",
           "matrixFormat": fmt, "tolerance": TOL, "relTol": 0, "adaptMinIter": False,
           "preconditioner": pc}
    _, perf_ref = ref_foam.solve(f"ref_{name}_{case}_{precision}", m, b_np, ctl)
    assert perf_ref.converged
    if precision == "float32":
        assert abs(it - perf_ref.n_iterations) <= 1
    else:
        assert perf_ref.n_iterations - 1 <= it <= perf_ref.n_iterations + 2
    c = ldu.ldu_to_coo_host(m, dtype=np.float64)
    a = sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows), np.asarray(c.cols))),
                      shape=c.shape)
    assert np.abs(b_np - a @ x.numpy().astype(np.float64)).sum() / np.abs(b_np).sum() < 1e-4


@pytest.mark.parametrize("solver,fmt,mesh", [("GKOCG", "Csr", "knn"), ("GKOCG", "Ell", "knn"),
                                             ("GKOMultigrid", "Ell", "knn"),
                                             ("GKOMultigrid", "Gdia", "shuffled"),
                                             ("GKOCG", "Sell", "knn"),
                                             ("GKOMultigrid", "Xell", "knn")], ids=str)
def test_foam_keeps_the_outer_plan_the_loop_takes(solver, fmt, mesh):
    """foam.solve keeps, for GKOCG + Multigrid on the general CG's formats
    and for GKOMultigrid, the plan of the AMG loop's outer format (Csr, Ell,
    Gdia), and none for the formats the loop lacks (Sell, Xell), which keep
    the host cycle; on the CPU every route runs its host loop."""
    m = _mesh(mesh)
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    pc = {"preconditioner": "Multigrid" if solver == "GKOCG" else "none", "aggregation": "auto"}
    ctl = {"executor": "cpu", "solver": solver, "matrixFormat": fmt, "tolerance": TOL,
           "relTol": 0, "adaptMinIter": False, "preconditioner": pc}
    _, perf = foam.solve("p", m, b, ctl)
    slv = registry.global_registry.get("p_solver")
    assert perf.converged
    if fmt in ("Sell", "Xell"):
        assert slv.kern is None or type(slv.kern) not in amg_loop.OUTER_PLANS
        assert amg_loop.why_not(slv._precond_op, slv.kern) is not None or slv.kern is None
    else:
        assert type(slv.kern) in amg_loop.OUTER_PLANS
        assert amg_loop.why_not(slv._precond_op, slv.kern) is None
