"""The port's kernels on an NVIDIA GPU against their plain PyTorch twins,
and the foam path on the card against the same solve on the CPU.

Every test here needs a CUDA device and carries the `cuda` marker; without
one it skips (decided in the fixture, never at import).  On a machine with
a card and without jax, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax, which these tests do not
use).  Tolerances: elementwise outputs may differ by the fused
multiply-adds the compilers form (a few ulp); block sums are summed in
another order than torch.sum's (rtol 1e-4)."""

import functools

import numpy as np
import pytest
import torch

from ogl_tpu_torch import bench, foam, kernels, registry, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv, dia_spmv_plain
from ogl_tpu_torch.kernels import device_time, gdia, roofline, xell
from ogl_tpu_torch.kernels.fused import (CgKernels, GdiaCgKernels, bicgstab_loop_plain,
                                         cg_loop_plain, cg_pipe_loop_plain, k1_plain, k1b_plain,
                                         k2_plain, k2i_plain, k2n_plain, ka_plain, kb_pipe_plain,
                                         kb_update_plain, kresid_plain, ksweep_plain)
from ogl_tpu_torch.kernels import amg_loop
from ogl_tpu_torch.precond import amg
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.solve import bicgstab, bicgstab_fused, cg_pipelined_fused, stopping
from ogl_tpu_torch.solve.krylov import single_device_ops
from ogl_tpu_torch.solve.cg_fused import cg_fused, merged_norm_factor
from ogl_tpu_torch.solve.ir import ir_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    registry.global_registry.clear()
    yield torch.device("cuda")
    registry.global_registry.clear()


def _banded(n, offsets, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn((len(offsets), n), generator=g)
    for k, off in enumerate(offsets):  # zero outside [0, n), as Dia stores it
        i = torch.arange(n)
        data[k, (i + off < 0) | (i + off >= n)] = 0.0
    return data.to(device)


def _poisson(dims, device):
    m = testing.poisson_ldu(dims)
    return formats.coo_to_dia(ldu.ldu_to_coo_host(m, dtype=np.float32), device)


def _vec(n, seed, device, lo=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    v = torch.rand(n, generator=g) * 0.1 + lo if lo is not None else torch.randn(n, generator=g)
    return v.to(device)


def _close(got, want, rtol=1e-5):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


CASES = [("poisson", (32, 16, 8)), ("banded", 1000), ("banded", 257)]


def _case(case, device):
    kind, size = case
    if kind == "poisson":
        mat = _poisson(size, device)
        return mat.data, mat.offsets
    offsets = (-300, -5, -1, 0, 1, 5, 300) if size > 600 else (-5, -1, 0, 1, 5)
    return _banded(size, offsets, 1, device), offsets


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dia_spmv_kernel_matches_plain(dev, case):
    data, offsets = _case(case, dev)
    n = data.shape[1]
    plan = DiaPlan(n, offsets, dev)
    x = _vec(n, 2, dev)
    kernels.reset_launches()
    y = dia_spmv(plan, data, x)
    torch.cuda.synchronize()
    assert kernels.launches["dia_spmv"] == 1
    _close(y, dia_spmv_plain(data, offsets, x))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k1_kernel_matches_plain(dev, case):
    data, offsets = _case(case, dev)
    n = data.shape[1]
    kern = CgKernels(n, offsets, dev)
    z, p = _vec(n, 3, dev), _vec(n, 4, dev)
    beta = torch.tensor(0.37, device=dev)
    kernels.reset_launches()
    pw, q, delta = kern.k1(data, z, p, beta)
    torch.cuda.synchronize()
    assert kernels.launches["cg_k1"] == 1
    pw2, q2, d2 = k1_plain(data, offsets, z, p, beta)
    _close(pw, pw2)
    _close(q, q2)
    torch.testing.assert_close(delta, d2, rtol=1e-4, atol=1e-4 * float(d2.abs()))
    # apply: K1 with z and p aliased to one buffer, beta = 0
    _close(kern.apply(data, z), dia_spmv_plain(data, offsets, z))


@pytest.mark.parametrize("n", [1000, 4096, 70001])
def test_k2_kernels_match_plain(dev, n):
    kern = CgKernels(n, (0,), dev)
    alpha = torch.tensor(-0.21, device=dev)
    p, q, invd = _vec(n, 5, dev), _vec(n, 6, dev), _vec(n, 7, dev, lo=0.1)
    for jacobi in (True, False):
        xs = [_vec(n, 8, dev) for _ in range(2)]
        rs = [_vec(n, 9, dev) for _ in range(2)]
        zs = [torch.empty(n, device=dev) for _ in range(2)]
        kernels.reset_launches()
        if jacobi:
            got = kern.k2(alpha, xs[0], rs[0], p, q, invd, zs[0])
            want = k2_plain(alpha, xs[1], rs[1], p, q, invd, zs[1])
            _close(zs[0], zs[1])
        else:
            got = kern.k2i(alpha, xs[0], rs[0], p, q)
            want = k2i_plain(alpha, xs[1], rs[1], p, q)
        torch.cuda.synchronize()
        assert kernels.launches["cg_k2" if jacobi else "cg_k2i"] == 1
        _close(xs[0], xs[1])
        _close(rs[0], rs[1])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [343, 1000, 4097, 1 << 20])
def test_k2_kernel_branches_match_plain(dev, n, offset):
    """Both branches of the CUDA K2: float4 (n % 4 == 0, every stream
    16-byte aligned) and scalar (n % 4 != 0, or every stream one float off
    an aligned base)."""
    kern = CgKernels(n, (0,), dev)
    alpha = torch.tensor(-0.31, device=dev)

    def vec(seed, lo=None):
        return _vec(n + offset, seed, dev, lo)[offset:]

    p, q, invd = vec(5), vec(6), vec(7, lo=0.1)
    x0, r0, z0 = vec(8), vec(9), vec(10)
    x, r, z = x0.clone(), r0.clone(), z0.clone()
    kernels.reset_launches()
    got = kern.k2(alpha, x0, r0, p, q, invd, z0)
    want = k2_plain(alpha, x, r, p, q, invd, z)
    torch.cuda.synchronize()
    assert kernels.launches["cg_k2"] == 1 and sum(kernels.launches.values()) == 1
    for g, w in ((x0, x), (r0, r), (z0, z)):
        _close(g, w)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097])
def test_k2i_kernel_branches_match_plain(dev, n, offset):
    """Both branches of the K2i kernel: float4 (n % 4 == 0, every stream
    16-byte aligned) and scalar (n = 1 mod 4, or every stream one float off
    an aligned base)."""
    kern = CgKernels(n, (0,), dev)
    alpha = torch.tensor(0.29, device=dev)

    def vec(seed):
        return _vec(n + offset, seed, dev)[offset:]

    p, q = vec(5), vec(6)
    x0, r0 = vec(8), vec(9)
    x, r = x0.clone(), r0.clone()
    kernels.reset_launches()
    got = kern.k2i(alpha, x0, r0, p, q)
    want = k2i_plain(alpha, x, r, p, q)
    torch.cuda.synchronize()
    assert kernels.launches["cg_k2i"] == 1
    _close(x0, x)
    _close(r0, r)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)


def test_wrappers_raise_on_bad_operands(dev):
    n = 512
    kern = CgKernels(n, (-1, 0, 1), dev)
    data = _banded(n, (-1, 0, 1), 0, dev)
    x = _vec(n, 1, dev)
    beta = torch.tensor(0.5, device=dev)
    with pytest.raises(TypeError, match="0-d float32"):
        kern.k1(data, x, x, 0.5)
    with pytest.raises(TypeError, match="float32"):
        kern.k1(data.double(), x, x, beta)
    with pytest.raises(ValueError, match="contiguous"):
        kern.k1(data, x, torch.randn(2 * n, device=dev)[::2], beta)
    with pytest.raises(ValueError, match="shape"):
        kern.k2i(beta, x, x[:-1], x, x)
    with pytest.raises(ValueError, match="is on"):
        dia_spmv(kern.plan, data.cpu(), x)


@pytest.mark.parametrize("pc", ["none", "BJ"])
def test_foam_solve_on_card_matches_cpu(dev, pc):
    m = testing.poisson_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "matrixFormat": "Dia", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False,
           "preconditioner": pc if pc == "none" else {"preconditioner": "BJ"}}
    x_cpu, perf_cpu = foam.FoamSolver("p", {**ctl, "executor": "cpu"}).solve(m, b)
    kernels.reset_launches()
    x, perf = foam.FoamSolver("p", {**ctl, "executor": "cuda"}).solve(m, b)
    assert x.device.type == "cuda"
    assert kernels.launches["cg_k1"] > 0 and kernels.launches["dia_spmv"] > 0
    # the whole loop is one launch: no K2 or K2i, and K1 only in the set-up
    assert kernels.launches["cg_loop"] == 1 and kernels.launches["cg_k1"] == 2
    assert kernels.launches["cg_k2"] == kernels.launches["cg_k2i"] == 0
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


# ---- the persistent CG loop ------------------------------------------------

# 7x7x7: n below one block of the loop (512 rows); 10x10x10: two blocks;
# 17x241: n = 1 (mod 4), the K2i phase's scalar branch; 128x128x64: the
# slices' 1M cells (chip_smoke.py also checks 8.4M)
LOOP_GRIDS = [(7, 7, 7), (10, 10, 10), (17, 241, 1), (128, 128, 64)]
LOOP_TOL = 1e-6


def _loop_setup(dims, dev):
    mat = bench._poisson_dia(dims, dev)
    n = mat.shape[0]
    kern = CgKernels(n, mat.offsets, dev)
    b = _vec(n, 11, dev)
    return kern, kern.pack_values(mat), b


def _loop_state(kern, data, b, invd=None):
    """The set-up of solve/cg_fused.py from a zero guess: (x, r, ρ, ‖r‖₁,
    nf) and z = invd ⊙ r (None with identity)."""
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    z = None if invd is None else invd * r
    return (x, r, torch.sum(r * (r if z is None else z)), torch.sum(torch.abs(r)),
            merged_norm_factor(kern, data, r, x, b)), z


def _check_loop(kern, data, b, invd, plain_k1, k1_counter, mv64, loop_counter="cg_loop"):
    """The loop kernel against its plain twin (over `plain_k1`) pinned at 30
    iterations and free-running to LOOP_TOL: three launches repeat their
    count and iterate exactly; each launches the loop (`loop_counter`) once
    and `k1_counter` twice (the set-up's r0 and norm factor), nothing else."""
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                   max_iter=2000, frequency=1)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=30, max_iter=30,
                                     frequency=1)
    for cfg in (pinned, free):
        (x_p, *state_p), z_p = _loop_state(kern, data, b, invd)
        it_p, rn_p, _, conv_p = cg_loop_plain(plain_k1, x_p, *state_p, cfg, invd, z_p)
        runs = []
        for _ in range(3):  # the kernel repeats its own count and iterate exactly
            kernels.reset_launches()
            (x, *state), z = _loop_state(kern, data, b, invd)
            runs.append((x, *kern.cg_loop(data, x, *state, cfg, invd=invd, z=z)))
            torch.cuda.synchronize()
            # one loop launch; K1 only for the set-up's two applies
            assert kernels.launches[loop_counter] == 1 and kernels.launches[k1_counter] == 2
            assert sum(kernels.launches.values()) == 3
        x, it, rn, _, conv = runs[0]
        assert all(run[1] == it and torch.equal(run[0], x) for run in runs[1:])
        if cfg is pinned:
            assert it == it_p == 30 and not conv
            _close(x, x_p)
        else:
            assert bool(conv) and bool(conv_p) and abs(it - it_p) <= 1
            assert float(rn) < LOOP_TOL
            r64 = b.double() - mv64(x.double())
            assert float(r64.abs().sum() / state[-1].double()) <= 10 * LOOP_TOL
            torch.testing.assert_close(x, x_p, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dims", LOOP_GRIDS, ids=str)
def test_cg_loop_matches_plain(dev, dims):
    kern, data, b = _loop_setup(dims, dev)
    _check_loop(kern, data, b, None, functools.partial(k1_plain, data, kern.offsets), "cg_k1",
                lambda v: dia_spmv_plain(data.double(), kern.offsets, v))


def _sym_graph(n, width, seed=3):
    """A symmetric, diagonally dominant random graph: each row couples to
    three rows within `width` above it (and they back), so its Gdia planes
    span a few block-row offsets and n need not be a multiple of 128."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), 3)
    j = i + rng.integers(1, width + 1, size=i.size)
    keep = j < n
    i, j = i[keep], j[keep]
    v = -rng.random(i.size).astype(np.float32)
    rows, cols, vals = (np.concatenate(t) for t in ((i, j), (j, i), (v, v)))
    diag = np.bincount(rows, weights=-vals, minlength=n).astype(np.float32) + 1.0
    rows, cols = np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag])
    _, idx = np.unique(rows * n + cols, return_index=True)
    return formats.Coo(rows=rows[idx].astype(np.int32), cols=cols[idx].astype(np.int32),
                       vals=vals[idx].astype(np.float32), shape=(n, n))


# the loop's three other variants: Dia with Jacobi on LOOP_GRIDS' edge sizes;
# Gdia on the shuffled grid (128 rows: below one block; 4,096; 1M) and on a
# random graph of 1,001 rows (n = 1 mod 4 and not a multiple of 128)
LOOP_VARIANT_CASES = [("Dia BJ", (7, 7, 7)), ("Dia BJ", (17, 241, 1)),
                      ("Dia BJ", (128, 128, 64)), ("Gdia none", (8, 8, 2)),
                      ("Gdia none", 1001), ("Gdia none", (128, 128, 64)),
                      ("Gdia BJ", (16, 16, 16)), ("Gdia BJ", 1001), ("Gdia BJ", (128, 128, 64))]


@pytest.mark.parametrize("route,size", LOOP_VARIANT_CASES, ids=str)
def test_cg_loop_variants_match_plain(dev, route, size):
    if route == "Dia BJ":
        kern, data, b = _loop_setup(size, dev)
        invd = 1.0 / data[kern.offsets.index(0)]
        _check_loop(kern, data, b, invd, functools.partial(k1_plain, data, kern.offsets),
                    "cg_k1", lambda v: dia_spmv_plain(data.double(), kern.offsets, v))
        return
    coo = (_sym_graph(size, 200) if isinstance(size, int) else
           ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu(size), dtype=np.float32))
    mat = gdia.gdia_from_coo(coo, max_planes=gdia.MAX_PLANES, device=dev)
    n = mat.shape[0]
    kern = GdiaCgKernels(n, mat.plane_offsets, dev)
    data = kern.pack_values(mat)
    b = _vec(n, 11, dev)
    diag = torch.zeros(n, device=dev).index_put_(
        (torch.tensor(coo.rows[coo.rows == coo.cols].astype(np.int64), device=dev),),
        torch.tensor(coo.vals[coo.rows == coo.cols], device=dev))
    invd = 1.0 / diag if route.endswith("BJ") else None
    plain_k1 = functools.partial(gdia.gdia_k1_plain, *data, mat.plane_offsets)
    _check_loop(kern, data, b, invd, plain_k1, "gdia_k1",
                lambda v: gdia.gdia_spmv_plain(data[0].double(), data[1], mat.plane_offsets, v))


def test_cg_fused_takes_the_loop_on_the_card(dev):
    """cg_fused routes identity and Jacobi on a Dia plan to the one launch;
    a plan that is not the Dia CgKernels itself keeps the host loop."""
    kern, data, b = _loop_setup((32, 16, 8), dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=1000, frequency=1)
    kernels.reset_launches()
    res = cg_fused(kern, data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["cg_loop"] == 1 and kernels.launches["cg_k2i"] == 0
    assert res.iters > 0 and bool(res.converged)
    assert res.final_res_norm.device.type == "cpu"
    kernels.reset_launches()
    invd = 1.0 / data[kern.offsets.index(0)]
    res_bj = cg_fused(kern, data, b, torch.zeros_like(b), cfg, invd=invd)
    assert kernels.launches["cg_loop"] == 1 and kernels.launches["cg_k2"] == 0
    assert res_bj.iters > 0 and bool(res_bj.converged)

    class HostLoop(CgKernels):
        pass

    host = HostLoop(kern.n, kern.offsets, dev)
    kernels.reset_launches()
    res_h = cg_fused(host, data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["cg_loop"] == 0 and kernels.launches["cg_k2i"] == res_h.iters
    assert abs(res_h.iters - res.iters) <= 1
    torch.testing.assert_close(res_h.x, res.x, rtol=0, atol=1e-3)


def test_cg_loop_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks is refused by the cooperative
    launch; the wrapper raises, falls back to nothing, and the next launch
    is unaffected."""
    kern, data, b = _loop_setup((128, 128, 64), dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=5, frequency=1)
    (x, *state), _ = _loop_state(kern, data, b)
    kern.cg_loop(data, x, *state, cfg)
    co_resident = kern._loop_blocks[0]
    assert 0 < co_resident < -(-kern.n // 512)
    kern._loop_blocks[0] = 4 * co_resident
    kernels.reset_launches()
    (x, *state), _ = _loop_state(kern, data, b)
    with pytest.raises(RuntimeError, match="cg_loop: CUDA error"):
        kern.cg_loop(data, x, *state, cfg)
    assert kernels.launches["cg_loop"] == 0
    kern._loop_blocks[0] = co_resident
    assert kern.cg_loop(data, x, *state, cfg)[0] == 5


@pytest.mark.parametrize("n", [4097, 16384])
def test_k2n_kernel_matches_plain(dev, n):
    kern = CgKernels(n, (0,), dev)
    alpha = torch.tensor(0.43, device=dev)
    p, q = _vec(n, 5, dev), _vec(n, 6, dev)
    xs = [_vec(n, 8, dev) for _ in range(2)]
    rs = [_vec(n, 9, dev) for _ in range(2)]
    kernels.reset_launches()
    got = kern.k2n(alpha, xs[0], rs[0], p, q)
    want = k2n_plain(alpha, xs[1], rs[1], p, q)
    torch.cuda.synchronize()
    assert kernels.launches["cg_k2n"] == 1
    _close(xs[0], xs[1])
    _close(rs[0], rs[1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


# an odd banded level, and the 16,384-row level of the 1M-cell hierarchy
SMOOTHER_CASES = [("banded", 1001), ("poisson", (32, 32, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", SMOOTHER_CASES, ids=str)
def test_smoother_kernels_match_plain(dev, case, dtype):
    data, offsets = _case(case, dev)
    n = data.shape[1]
    kern = CgKernels(n, offsets, dev)
    data = data.to(dtype)
    x, b, invd = _vec(n, 2, dev), _vec(n, 3, dev), _vec(n, 4, dev, lo=0.1)
    kernels.reset_launches()
    sweep = kern.ksweep(data, x, b, invd, 0.9)
    resid = kern.kresid(data, x, b)
    torch.cuda.synchronize()
    assert kernels.launches["amg_sweep"] == 1 and kernels.launches["amg_resid"] == 1
    # the plain versions read the same (bfloat16) data widened to float32
    _close(sweep, ksweep_plain(data, offsets, x, b, invd, 0.9))
    _close(resid, kresid_plain(data, offsets, x, b))
    out = torch.empty_like(x)
    assert kern.kresid(data, x, b, out=out) is out
    _close(out, resid, rtol=0)


def test_smoother_wrappers_raise_on_bad_operands(dev):
    n = 513
    kern = CgKernels(n, (-1, 0, 1), dev)
    data = _banded(n, (-1, 0, 1), 0, dev)
    x, b, invd = _vec(n, 1, dev), _vec(n, 2, dev), _vec(n, 3, dev, lo=0.1)
    with pytest.raises(ValueError, match="overlaps"):
        kern.ksweep(data, x, b, invd, 0.9, out=x)
    with pytest.raises(ValueError, match="overlaps"):
        kern.kresid(data, x, b, out=x)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        kern.ksweep(data.double(), x, b, invd, 0.9)
    with pytest.raises(TypeError, match="float32"):
        kern.kresid(data, x.double(), b)
    with pytest.raises(TypeError, match="float32"):
        kern.k2n(torch.tensor(0.5, device=dev), x, b.double(), x, x)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOMultigrid"])
def test_foam_amg_on_card_matches_cpu(dev, solver):
    m = testing.poisson_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "matrixFormat": "Dia", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False}
    if solver == "GKOCG":
        ctl["preconditioner"] = "Multigrid"
    x_cpu, perf_cpu = foam.FoamSolver("p", {**ctl, "executor": "cpu"}).solve(m, b)
    kernels.reset_launches()
    x, perf = foam.FoamSolver("p", {**ctl, "executor": "cuda"}).solve(m, b)
    assert x.device.type == "cuda"
    # the whole solve is one launch of the device V-cycle's loop; K1 twice
    # for the set-up; the SpMV in the residual-eval timing; no standalone
    # smoother or K2n launch
    loop = "amg_cg_loop" if solver == "GKOCG" else "amg_ir_loop"
    assert kernels.launches[loop] == 1 and kernels.launches["cg_k1"] == 2
    assert kernels.launches["dia_spmv"] > 0
    assert kernels.launches["amg_sweep"] == kernels.launches["amg_resid"] == 0
    assert kernels.launches["cg_k2n"] == 0
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOMultigrid"])
def test_foam_amg_host_cycle_on_card_matches_cpu(dev, solver):
    """cycle w keeps the host-launched cycle on the card: the standalone
    smoother kernels (and K2n for GKOCG), no loop launch."""
    m = testing.poisson_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    pc = {"preconditioner": "Multigrid", "cycle": "w"}
    ctl = {"solver": solver, "matrixFormat": "Dia", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, "preconditioner": pc if solver == "GKOCG" else
           {"preconditioner": "none", "cycle": "w"}}
    x_cpu, perf_cpu = foam.FoamSolver("p", {**ctl, "executor": "cpu"}).solve(m, b)
    kernels.reset_launches()
    x, perf = foam.FoamSolver("p", {**ctl, "executor": "cuda"}).solve(m, b)
    assert kernels.launches["amg_cg_loop"] == kernels.launches["amg_ir_loop"] == 0
    assert kernels.launches["amg_sweep"] > 0 and kernels.launches["amg_resid"] > 0
    if solver == "GKOCG":
        assert kernels.launches["cg_k2n"] > 0
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


# ---- the device V-cycle (csrc/amg_loop.cuh) ---------------------------------

# odd axes (n = 2,431: rows, not quads; grid_restrict's padding), a box
# grid (quads), a natural hierarchy with a partial last aggregate (8 rows
# each, and 16: more fine rows than the lanes of a transfer's group), a
# 2-D grid of one plane, and the slices' 1M cells
AMG_LOOP_CASES = [((17, 13, 11), "auto"), ((16, 16, 16), "auto"), ((17, 13, 11), "natural"),
                  ((17, 13, 11), "natural16"), ((37, 29, 1), "auto"), ((128, 128, 64), "auto")]
AMG_LOOP_PINNED = 10
# x after AMG_LOOP_PINNED pinned iterations against the twin: the restrict
# sums, the coarse product and the partial sums add in another order
AMG_LOOP_RTOL = 1e-4


def _amg_setup(dims, aggregation, dtype, dev):
    coo = ldu.ldu_to_coo_host(testing.poisson_ldu(dims), dtype=np.float32)
    mat = formats.coo_to_dia(coo, dev)
    kern = CgKernels(mat.shape[0], mat.offsets, dev)
    natural = aggregation.startswith("natural")  # "natural16": runs of 16 rows
    width = int(aggregation[len("natural"):] or 8) if natural else 8
    op = amg.amg(coo, dev, aggregation="natural" if natural else aggregation,
                 smoother_dtype=dtype, width=width)
    assert amg_loop.qualifies(op)
    return kern, kern.pack_values(mat), _vec(mat.shape[0], 11, dev), op


def _amg_state(kern, data, b):
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    return x, r, torch.sum(torch.abs(r)), merged_norm_factor(kern, data, r, x, b)


def _amg_twin(name, kern, data, op, state, cfg):
    cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                              sweeps=op.smooth_iters)
    if name == "cg":
        k1 = functools.partial(k1_plain, data, kern.offsets)
        return amg_loop.amg_cg_loop_plain(k1, *state, cfg, cycle)
    apply = functools.partial(dia_spmv_plain, data, kern.offsets)
    return amg_loop.amg_ir_loop_plain(apply, *state, cfg, cycle)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,aggregation", AMG_LOOP_CASES, ids=str)
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_amg_loop_matches_plain(dev, name, dims, aggregation, dtype):
    """Each loop variant against its plain twin on the card, pinned and
    free-running: three launches repeat their count and iterate exactly;
    each launches the loop once and K1 twice (the set-up's r0 and norm
    factor), nothing else."""
    kern, data, b, op = _amg_setup(dims, aggregation, dtype, dev)
    loop = amg_loop.amg_cg_loop if name == "cg" else amg_loop.amg_ir_loop
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=AMG_LOOP_PINNED,
                                     max_iter=AMG_LOOP_PINNED, frequency=1)
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0, max_iter=1000,
                                   frequency=1)
    for cfg in (pinned, free):
        state_p = _amg_state(kern, data, b)
        it_p, rn_p, _, conv_p = _amg_twin(name, kern, data, op, state_p, cfg)
        runs = []
        for _ in range(3):
            kernels.reset_launches()
            state = _amg_state(kern, data, b)
            runs.append((state[0], *loop(kern, data, op, *state, cfg)))
            torch.cuda.synchronize()
            assert kernels.launches[f"amg_{name}_loop"] == 1 and kernels.launches["cg_k1"] == 2
            assert sum(kernels.launches.values()) == 3
        x, it, rn, _, conv = runs[0]
        assert all(run[1] == it and torch.equal(run[0], x) for run in runs[1:])
        if cfg is pinned:
            assert it == it_p == AMG_LOOP_PINNED and not conv
            _close(x, state_p[0], rtol=AMG_LOOP_RTOL)
            torch.testing.assert_close(rn, rn_p.cpu(), rtol=AMG_LOOP_RTOL, atol=0)
        else:
            assert bool(conv) and bool(conv_p) and abs(it - it_p) <= 1
            assert float(rn) < LOOP_TOL
            r64 = b.double() - dia_spmv_plain(data.double(), kern.offsets, x.double())
            assert float(r64.abs().sum() / state[-1].double()) <= 10 * LOOP_TOL
            torch.testing.assert_close(x, state_p[0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["cg", "ir"])
def test_amg_routes_take_the_loop_on_the_card(dev, name):
    """cg_fused and ir_fused take the loop for a qualifying hierarchy on the
    Dia plan itself; a plan that is not CgKernels itself, and a w-cycle,
    keep the host-launched cycle."""
    kern, data, b, op = _amg_setup((32, 32, 16), "auto", torch.bfloat16, dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=1000, frequency=1)

    def solve(k, pc):
        if name == "cg":
            return cg_fused(k, data, b, torch.zeros_like(b), cfg, precond=pc)
        return ir_fused(k, data, b, torch.zeros_like(b), cfg, pc)

    kernels.reset_launches()
    res = solve(kern, op)
    assert kernels.launches[f"amg_{name}_loop"] == 1 and kernels.launches["amg_sweep"] == 0
    assert bool(res.converged) and res.final_res_norm.device.type == "cpu"

    class HostLoop(CgKernels):
        pass

    host = HostLoop(kern.n, kern.offsets, dev)
    w = amg.cycle_op(op.state, "w", op.relax, op.smooth_iters, op.coarse_solver_iters)
    for k, pc in ((host, op), (kern, w)):
        kernels.reset_launches()
        res_h = solve(k, pc)
        assert kernels.launches[f"amg_{name}_loop"] == 0 and kernels.launches["amg_sweep"] > 0
        assert bool(res_h.converged)
    torch.testing.assert_close(solve(host, op).x, res.x, rtol=0, atol=1e-3)


def test_amg_loop_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks is refused by the cooperative
    launch; the wrapper raises, falls back to nothing, and the next launch
    is unaffected."""
    kern, data, b, op = _amg_setup((128, 128, 64), "auto", torch.bfloat16, dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=3, max_iter=3,
                                  frequency=1)
    amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)
    key = (kern.device.index, amg_loop.VARIANT_BF16, amg_loop.table_of(op).smem)
    co_resident = amg_loop._grids[key]
    assert 0 < co_resident < -(-kern.n // 512) // 4
    amg_loop._grids[key] = 4 * co_resident
    kernels.reset_launches()
    try:
        with pytest.raises(RuntimeError, match="amg_cg_loop: CUDA error"):
            amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)
        assert kernels.launches["amg_cg_loop"] == 0
    finally:
        amg_loop._grids[key] = co_resident
    assert amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)[0] == 3


def test_amg_loop_wrappers_raise_on_bad_operands(dev):
    kern, data, b, op = _amg_setup((16, 16, 16), "auto", torch.bfloat16, dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=10, frequency=1)
    w = amg.cycle_op(op.state, "w", op.relax, op.smooth_iters, op.coarse_solver_iters)
    x, r, absr, nf = _amg_state(kern, data, b)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="cycle w"):
        amg_loop.amg_cg_loop(kern, data, w, x, r, absr, nf, cfg)
    with pytest.raises(TypeError, match="float32"):
        amg_loop.amg_ir_loop(kern, data, op, x.double(), r, absr, nf, cfg)
    with pytest.raises(TypeError, match="0-d float32"):
        amg_loop.amg_cg_loop(kern, data, op, x, r, absr.reshape(1), nf, cfg)
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [343, 1000, 4097, 1 << 20])
def test_smoother_kernel_branches_match_plain(dev, n, offset, dtype):
    """Row quads (n % 4 == 0, every stream aligned) and one thread per row
    (n % 4 != 0, or x, b, invd and out one float off), against the plain
    versions, with diagonals whose offsets are not multiples of 4."""
    offsets = (-300, -5, -1, 0, 1, 5, 300) if n > 600 else (-49, -7, -1, 0, 1, 7, 49)
    kern = CgKernels(n, offsets, dev)
    data = _banded(n, offsets, 1, dev).to(dtype)

    def buf(seed, lo=None):
        return torch.cat([torch.zeros(offset, device=dev), _vec(n, seed, dev, lo)])[offset:]

    x, b, invd, out = buf(2), buf(3), buf(4, lo=0.1), buf(5)
    kernels.reset_launches()
    sweep = kern.ksweep(data, x, b, invd, 0.9, out=out)
    resid = kern.kresid(data, x, b)
    torch.cuda.synchronize()
    assert kernels.launches["amg_sweep"] == 1 and kernels.launches["amg_resid"] == 1
    _close(sweep, ksweep_plain(data, offsets, x, b, invd, 0.9))
    _close(resid, kresid_plain(data, offsets, x, b))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097])
def test_k2n_kernel_branches_match_plain(dev, n, offset):
    """The CUDA K2n's float4 branch and its row branch (n % 4 != 0, or the
    streams one float off) against k2n_plain."""
    kern = CgKernels(n, (0,), dev)
    alpha = torch.tensor(-0.37, device=dev)

    def buf(seed):
        return torch.cat([torch.zeros(offset, device=dev), _vec(n, seed, dev)])[offset:]

    p, q = buf(5), buf(6)
    xs = [buf(8) for _ in range(2)]
    rs = [buf(9) for _ in range(2)]
    kernels.reset_launches()
    got = kern.k2n(alpha, xs[0], rs[0], p, q)
    want = k2n_plain(alpha, xs[1], rs[1], p, q)
    torch.cuda.synchronize()
    assert kernels.launches["cg_k2n"] == 1
    _close(xs[0], xs[1])
    _close(rs[0], rs[1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


# ---- the unstructured path: Gdia and Xell kernels -------------------------


def _knn_coo(n):
    """The RCM'd kNN graph of testing.knn_ldu(n) as a float32 Coo."""
    m, perm = testing.knn_ldu(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return ldu.ldu_to_coo_host(testing.renumber_ldu(m, inv), dtype=np.float32)


# n = 20000 is not a multiple of 128 and spans two Xell tiles (c_left > 0)
GDIA_CASES = [("knn", 20000), ("shuffled_poisson", (128, 16, 8))]


@pytest.mark.parametrize("case", GDIA_CASES, ids=str)
def test_gdia_kernels_match_plain(dev, case):
    kind, size = case
    if kind == "knn":
        mat = gdia.gdia_from_coo(_knn_coo(size), max_planes=4096, device=dev)
    else:
        coo = ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu(size), dtype=np.float32)
        mat = gdia.gdia_from_coo(coo, device=dev)
    n = mat.shape[0]
    plan = gdia.GdiaPlan.of(mat)
    x, z, p = _vec(n, 2, dev), _vec(n, 3, dev), _vec(n, 4, dev)
    beta = torch.tensor(0.37, device=dev)
    kernels.reset_launches()
    y = gdia.gdia_spmv(plan, mat.vals, mat.lidx, x)
    pw, q, delta = gdia.gdia_k1(plan, mat.vals, mat.lidx, z, p, beta)
    torch.cuda.synchronize()
    assert kernels.launches["gdia_spmv"] == 1 and kernels.launches["gdia_k1"] == 1
    _close(y, gdia.gdia_spmv_plain(mat.vals, mat.lidx, mat.plane_offsets, x))
    pw2, q2, d2 = gdia.gdia_k1_plain(mat.vals, mat.lidx, mat.plane_offsets, z, p, beta)
    _close(pw, pw2)
    _close(q, q2)
    torch.testing.assert_close(delta, d2, rtol=1e-4, atol=1e-4 * float(d2.abs()))
    kern = GdiaCgKernels(n, mat.plane_offsets, dev)  # apply: z and p aliased, beta 0
    _close(kern.apply(kern.pack_values(mat), x), y)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [100, 1001, 5003, 1 << 20])
def test_gdia_k1_edges_match_plain(dev, n, offset):
    """The row-quad K1: n below one block of 1,024 rows, n not a multiple of
    128 nor of 4 (a ragged last quad), z and p aligned (float4 path) or one
    float off (scalar path).  The row body rounds each product and sum as
    the plain version does, in plane order, so p', q and the SpMV's rows
    are the plain versions' bits."""
    mat = gdia.gdia_from_coo(_sym_graph(n, 200), max_planes=gdia.MAX_PLANES, device=dev)
    plan = gdia.GdiaPlan.of(mat)
    z, p = (_vec(n + offset, seed, dev)[offset:] for seed in (3, 4))
    beta = torch.tensor(-0.41, device=dev)
    kernels.reset_launches()
    pw, q, delta = gdia.gdia_k1(plan, mat.vals, mat.lidx, z, p, beta)
    torch.cuda.synchronize()
    assert kernels.launches["gdia_k1"] == 1 and sum(kernels.launches.values()) == 1
    pw2, q2, d2 = gdia.gdia_k1_plain(mat.vals, mat.lidx, mat.plane_offsets, z, p, beta)
    assert torch.equal(pw, pw2) and torch.equal(q, q2)
    torch.testing.assert_close(delta, d2, rtol=1e-4, atol=1e-4 * float(d2.abs()))
    y = gdia.gdia_spmv(plan, mat.vals, mat.lidx, z)
    assert torch.equal(y, gdia.gdia_spmv_plain(mat.vals, mat.lidx, mat.plane_offsets, z))
    _close(GdiaCgKernels(n, mat.plane_offsets, dev).apply((mat.vals, mat.lidx), z), y)


@pytest.mark.parametrize("spill_frac", [0.002, 0.08])
def test_xell_kernels_match_plain(dev, spill_frac):
    mat = xell.xell_from_coo(_knn_coo(20000), spill_frac=spill_frac, device=dev)
    n = mat.shape[0]
    assert n % 128 and mat.c_left > 0 and mat.spill.vals.shape[0] > 0
    plan = xell.XellPlan.of(mat)
    data = (mat.vals, mat.ll, mat.bbT, mat.spill.vals)
    x, z, p = _vec(n, 2, dev), _vec(n, 3, dev), _vec(n, 4, dev)
    beta = torch.tensor(0.37, device=dev)
    kernels.reset_launches()
    y = xell.xell_spmv(plan, *data, x)
    pw, q, delta = xell.xell_k1(plan, *data, z, p, beta)
    torch.cuda.synchronize()
    assert kernels.launches["xell_spmv"] == 1 and kernels.launches["xell_k1"] == 1
    _close(y, xell.xell_spmv_plain(plan, *data, x))
    pw2, q2, d2 = xell.xell_k1_plain(plan, *data, z, p, beta)
    _close(pw, pw2)
    _close(q, q2)
    torch.testing.assert_close(delta, d2, rtol=1e-4, atol=1e-4 * float(d2.abs()))
    kern = xell.XellCgKernels.for_matrix(mat)
    _close(kern.apply(kern.pack_values(mat), x), y)
    # no spill: the kernels take a NULL spill table
    nospill = xell.xell_from_coo(_knn_coo(20000), spill_frac=0.0, device=dev)
    assert nospill.spill.vals.shape[0] == 0
    plan0 = xell.XellPlan.of(nospill)
    data0 = (nospill.vals, nospill.ll, nospill.bbT, nospill.spill.vals)
    _close(xell.xell_spmv(plan0, *data0, x), xell.xell_spmv_plain(plan0, *data0, x))
    _close(xell.xell_spmv(plan0, *data0, x), y)


def _xell_graph(n, hubs, width=1500, k=4, seed=1):
    """A random graph whose sources lie within `width` rows of their
    destination (a window of a few chunks), diagonally dominant, with 48
    extra entries in each of the `hubs` rows: those rows spill."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), k)
    hsrc = np.repeat(np.asarray(hubs, np.int64), 48)
    src = np.concatenate([src, hsrc])
    dst = np.clip(src + rng.integers(-width, width + 1, size=src.size), 0, n - 1)
    r = np.concatenate([src, np.arange(n)])
    c = np.concatenate([dst, np.arange(n)])
    _, idx = np.unique(r * n + c, return_index=True)  # row-major, no duplicates
    r, c = r[idx], c[idx]
    v = np.where(r == c, 8.0, rng.normal(size=r.size)).astype(np.float32)
    return formats.Coo(rows=r.astype(np.int32), cols=c.astype(np.int32), vals=v, shape=(n, n))


# the SpMV kernel's edges: n = 1 (mod 128) below one band of 2,048 rows and
# over four tiles (the last band ragged, c_left > 0); K above the 4-slot
# shared ring; spill rows at band edges, and no spill at all
XELL_EDGE_CASES = {
    "short": (1921, (0, 1919, 1920), {}),
    "tiles": (3 * 16384 + 129, (0, 2047, 2048, 16383, 16384, 32767, 49152, 49280), {}),
    "tiles_nospill": (3 * 16384 + 129, (2047, 16384, 49280), {"spill_frac": 0.0, "k_max": 64}),
}


@pytest.mark.parametrize("name", list(XELL_EDGE_CASES))
def test_xell_spmv_edges_match_plain(dev, name):
    n, hubs, pack = XELL_EDGE_CASES[name]
    mat = xell.xell_from_coo(_xell_graph(n, hubs), device=dev, **pack)
    plan = xell.XellPlan.of(mat)
    assert n % 128 == 1 and mat.n_slots > 4
    sp_rows = set(mat.spill.rows.cpu().tolist())
    if name == "tiles":
        assert mat.c_left > 0 and {0, 2047, 2048, 16383, 16384, n - 1} <= sp_rows
    if name == "tiles_nospill":
        assert not sp_rows
    data = (mat.vals, mat.ll, mat.bbT, mat.spill.vals)
    x = _vec(n, 2, dev)
    kernels.reset_launches()
    y = xell.xell_spmv(plan, *data, x)
    torch.cuda.synchronize()
    assert kernels.launches["xell_spmv"] == 1 and y.shape == (n,)
    _close(y, xell.xell_spmv_plain(plan, *data, x))
    # the band K1 computes the same product at beta 0
    _close(xell.XellCgKernels(plan).apply(data, x), y)


# ---- the Xell K1 in bands and the Xell CG loop ----------------------------


# the band K1's matrices: the kNN mesh over two tiles (c_left > 0, the last
# band ragged; spill 0.2% and 8%), XELL_EDGE_CASES' graphs (below one band
# with n % 4 = 1; four tiles with spill rows at band edges; no spill, K
# above the ring), and the shuffled grid at 655,360 rows (320 bands)
XELL_BAND_CASES = {
    "knn": lambda: (_knn_coo(20000), {}),
    "knn_spill_high": lambda: (_knn_coo(20000), {"spill_frac": 0.08}),
    "short": lambda: (_xell_graph(*XELL_EDGE_CASES["short"][:2]), {}),
    "tiles": lambda: (_xell_graph(*XELL_EDGE_CASES["tiles"][:2]), {}),
    "tiles_nospill": lambda: (_xell_graph(*XELL_EDGE_CASES["tiles_nospill"][:2]),
                              XELL_EDGE_CASES["tiles_nospill"][2]),
    "shuffled": lambda: (ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu((128, 128, 40)),
                                             dtype=np.float32), {}),
}
# the Xell loops' matrices: the kNN mesh (SPD) over two tiles with spill 0.2%
# and 8% and without spill, over four tiles (n = 1 mod 128, n % 4 = 1) and
# below one band (n % 4 = 1), and the shuffled grid (more bands than the
# loops' co-resident blocks).  XELL_EDGE_CASES' graphs made SPD are unfit:
# their hub rows make the twins alone move x by 2e-4 (CG, 30 iterations) and
# 2e-2 (BiCGStab `none`, 10 iterations) when b moves by one ulp
XELL_LOOP_CASES = {
    "knn": XELL_BAND_CASES["knn"],
    "knn_spill_high": XELL_BAND_CASES["knn_spill_high"],
    "knn_nospill": lambda: (_knn_coo(20000), {"spill_frac": 0.0}),
    "knn_tiles": lambda: (_knn_coo(3 * 16384 + 129), {}),
    "knn_short": lambda: (_knn_coo(1921), {}),
    "shuffled": XELL_BAND_CASES["shuffled"],
}


def _xell_band_case(name, dev, cases=XELL_BAND_CASES):
    """(matrix on `dev`, its diagonal on `dev`) of cases[name]."""
    coo, pack = cases[name]()
    mat = xell.xell_from_coo(coo, device=dev, **pack)
    on = np.asarray(coo.rows) == np.asarray(coo.cols)
    diag = np.zeros(coo.shape[0], np.float32)
    diag[np.asarray(coo.rows)[on]] = np.asarray(coo.vals)[on]
    return mat, torch.tensor(diag, device=dev)


def _cpu_plan(plan):
    """The same XellPlan with its spill CSR on the CPU (the twins' CPU run)."""
    sp = plan.spill
    return xell.XellPlan(plan.n, plan.n_tiles, plan.n_slots, plan.c_left,
                         xell.SpillCsr(*(t.cpu() for t in (sp.row_ptr, sp.rows, sp.cols,
                                                           sp.gidx))))


@pytest.mark.parametrize("alias", [False, True], ids=["z,p", "z is p"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("name", list(XELL_BAND_CASES))
def test_xell_k1_bands_match_plain_on_cpu_copies(dev, name, offset, alias):
    """The band K1 (and the SpMV over the same band body) against their plain
    twins run on CPU copies of the same tensors: p', q and y bit-equal (every
    product and sum rounded as the twins' ops round, the spill added in row
    order as the CPU's index_add adds it), δ within the block sums' rtol.
    offset 1: z and p 4 bytes off 16-byte alignment (the row-by-row store);
    z is p: the two sources alias (XellCgKernels.apply)."""
    mat, _ = _xell_band_case(name, dev)
    plan, n = xell.XellPlan.of(mat), mat.shape[0]
    if name.startswith("knn"):
        assert mat.c_left > 0 and n % xell.BAND_ROWS and mat.spill.vals.shape[0] > 0
    data = (mat.vals, mat.ll, mat.bbT, mat.spill.vals)
    z = _vec(n + 1, 3, dev)[offset:offset + n]
    p = z if alias else _vec(n + 1, 4, dev)[offset:offset + n]
    beta = torch.tensor(0.37, device=dev)
    kernels.reset_launches()
    pw, q, delta = xell.xell_k1(plan, *data, z, p, beta)
    y = xell.xell_spmv(plan, *data, z.contiguous())
    torch.cuda.synchronize()
    assert kernels.launches["xell_k1"] == 1 and kernels.launches["xell_spmv"] == 1
    cpu = _cpu_plan(plan)
    host = tuple(t.cpu() for t in data)
    pw2, q2, d2 = xell.xell_k1_plain(cpu, *host, z.cpu(), p.cpu(), beta.cpu())
    assert torch.equal(pw.cpu(), pw2) and torch.equal(q.cpu(), q2)
    torch.testing.assert_close(delta.cpu(), d2, rtol=1e-4, atol=1e-4 * float(d2.abs()))
    assert torch.equal(y.cpu(), xell.xell_spmv_plain(cpu, *host, z.cpu()))


def _xell_loop_setup(name, pc, dev):
    mat, diag = _xell_band_case(name, dev, XELL_LOOP_CASES)
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    return kern, data, _vec(kern.n, 11, dev), (1.0 / diag if pc == "BJ" else None)


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("name", list(XELL_LOOP_CASES))
def test_xell_cg_loop_matches_plain(dev, name, pc):
    """The Xell loop kernel against cg_loop_plain over the plain K1, pinned
    and free-running (_check_loop): one xell_cg_loop launch per solve, the
    band K1 twice for the set-up."""
    kern, data, b, invd = _xell_loop_setup(name, pc, dev)
    plain_k1 = functools.partial(xell.xell_k1_plain, kern.plan, *data)
    _check_loop(kern, data, b, invd, plain_k1, "xell_k1",
                lambda v: xell.xell_spmv_plain(kern.plan, *data, v), loop_counter="xell_cg_loop")


def test_cg_fused_takes_the_xell_loop_on_the_card(dev):
    """cg_fused routes identity and Jacobi on an Xell plan to the one launch;
    a plan that is not XellCgKernels itself keeps the host loop over the
    band K1 and K2i."""
    kern, data, b, invd = _xell_loop_setup("knn", "BJ", dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=1000, frequency=1)
    runs = {}
    for pc, iv in (("none", None), ("BJ", invd)):
        kernels.reset_launches()
        runs[pc] = cg_fused(kern, data, b, torch.zeros_like(b), cfg, invd=iv)
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {"xell_cg_loop": 1,
                                                                    "xell_k1": 2}
        assert runs[pc].iters > 0 and bool(runs[pc].converged)
        assert runs[pc].final_res_norm.device.type == "cpu"

    class HostLoop(xell.XellCgKernels):
        pass

    kernels.reset_launches()
    res_h = cg_fused(HostLoop(kern.plan), data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["xell_cg_loop"] == 0 and kernels.launches["cg_k2i"] == res_h.iters
    assert abs(res_h.iters - runs["none"].iters) <= 1
    torch.testing.assert_close(res_h.x, runs["none"].x, rtol=0, atol=1e-3)


def test_xell_cg_loop_grid_and_refused_launch(dev):
    """The occupancy query (with the ring) gives a grid the cooperative launch
    accepts, here walking 320 bands on fewer blocks; four times that grid is
    refused: the wrapper raises, counts nothing, leaves no error behind, and
    the next launch is unaffected."""
    kern, data, b, _ = _xell_loop_setup("shuffled", "none", dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)
    co_resident = kern.loop_blocks(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert co_resident % sms == 0 and 0 < co_resident < xell.band_grid(kern.n)
    (x, *state), _ = _loop_state(kern, data, b)
    assert kern.cg_loop(data, x, *state, cfg)[0] == 5
    kern._loop_blocks[0] = 4 * co_resident
    kernels.reset_launches()
    (x, *state), _ = _loop_state(kern, data, b)
    with pytest.raises(RuntimeError, match="xell_cg_loop: CUDA error"):
        kern.cg_loop(data, x, *state, cfg)
    assert kernels.launches["xell_cg_loop"] == 0
    torch.cuda.synchronize()
    kern._loop_blocks[0] = co_resident
    assert kern.cg_loop(data, x, *state, cfg)[0] == 5


def test_xell_cg_loop_raises_on_bad_operands(dev):
    kern, data, b, invd = _xell_loop_setup("knn_short", "BJ", dev)
    (x, *state), z = _loop_state(kern, data, b, invd)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=2,
                                  frequency=1)
    with pytest.raises(TypeError, match="float32"):
        kern.cg_loop(data, x, *state, cfg, invd=invd.double(), z=z)
    with pytest.raises(ValueError, match="shape"):
        kern.cg_loop(data, x, *state, cfg, invd=invd, z=z[:-1].clone())
    with pytest.raises(TypeError, match="0-d float32"):
        kern.cg_loop(data, x, state[0], 1.0, state[2], state[3], cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        kern.cg_loop(data, x.cpu(), *state, cfg)
    with pytest.raises(ValueError, match="invd and z"):
        kern.cg_loop(data, x, *state, cfg, invd=invd)


def test_unstructured_wrappers_raise_on_bad_operands(dev):
    coo = _knn_coo(20000)
    g = gdia.gdia_from_coo(coo, max_planes=4096, device=dev)
    m = xell.xell_from_coo(coo, device=dev)
    gp, xp = gdia.GdiaPlan.of(g), xell.XellPlan.of(m)
    x = _vec(g.shape[0], 1, dev)
    xd = (m.vals, m.ll, m.bbT, m.spill.vals)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gdia.gdia_spmv(gp, g.vals, g.lidx, x.cpu())
    with pytest.raises(ValueError, match="is on"):
        xell.xell_spmv(xp, m.vals.cpu(), *xd[1:], x)
    with pytest.raises(TypeError, match="float32"):
        gdia.gdia_spmv(gp, g.vals, g.lidx, x.double())
    with pytest.raises(TypeError, match="int8"):
        gdia.gdia_spmv(gp, g.vals, g.lidx.int(), x)
    with pytest.raises(TypeError, match="int16"):
        xell.xell_spmv(xp, m.vals, m.ll, m.bbT.int(), m.spill.vals, x)
    with pytest.raises(TypeError, match="0-d float32"):
        xell.xell_k1(xp, *xd, x, x, 0.5)
    with pytest.raises(ValueError, match="shape"):
        xell.xell_spmv(xp, *xd, x[:-1])


@pytest.mark.parametrize("fmt", ["Gdia", "Xell"])
def test_foam_unstructured_on_card_matches_cpu(dev, fmt):
    """Auto-routing on the card: the shuffled grid takes Gdia (with BJ), the
    kNN graph at 32,768 cells Xell (with none); each launches its format's
    kernels and runs its loop as one launch."""
    if fmt == "Gdia":
        m, pc = testing.shuffled_poisson_ldu((32, 32, 16)), {"preconditioner": "BJ"}
    else:
        m, perm = testing.knn_ldu(1 << 15)
        m, pc = testing.renumber_ldu(m, np.argsort(perm)), "none"
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "tolerance": 1e-6, "relTol": 0, "adaptMinIter": False,
           "preconditioner": pc}
    x_cpu, perf_cpu = foam.FoamSolver("p", {**ctl, "executor": "cpu"}).solve(m, b)
    kernels.reset_launches()
    x, perf = foam.FoamSolver("p", {**ctl, "executor": "cuda"}).solve(m, b)
    assert x.device.type == "cuda" and perf.solver_name == f"GKOCG_{fmt}"
    name = fmt.lower()
    assert kernels.launches[f"{name}_k1"] > 0 and kernels.launches[f"{name}_spmv"] > 0
    if fmt == "Gdia":  # BJ on Gdia: one loop launch, K1 only in the set-up
        assert kernels.launches["cg_loop"] == 1 and kernels.launches["gdia_k1"] == 2
        assert kernels.launches["cg_k2"] == 0
    else:  # none on Xell: one launch of the Xell loop, K1 only in the set-up
        assert kernels.launches["xell_cg_loop"] == 1 and kernels.launches["xell_k1"] == 2
        assert kernels.launches["cg_k2i"] == 0
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


# ---- slice 4: the pipelined-CG and merged-BiCGStab kernels ----------------


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_ka_kernel_matches_plain(dev, case, jacobi):
    data, offsets = _case(case, dev)
    n = data.shape[1]
    kern = CgKernels(n, offsets, dev)
    r, invd = _vec(n, 3, dev), _vec(n, 4, dev, lo=0.1) if jacobi else None
    kernels.reset_launches()
    w, *sums = kern.ka(data, r, invd)
    torch.cuda.synchronize()
    assert kernels.launches["cg_ka"] == 1
    w2, *sums2 = ka_plain(data, offsets, r, invd)
    _close(w, w2)
    for g, want in zip(sums, sums2):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4 * float(want.abs()))


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("n", [1000, 70001])
def test_kb_pipe_kernel_matches_plain(dev, n, jacobi):
    kern = CgKernels(n, (0,), dev)
    alpha, beta = torch.tensor(-0.21, device=dev), torch.tensor(0.63, device=dev)
    w, invd = _vec(n, 5, dev), _vec(n, 6, dev, lo=0.1) if jacobi else None
    got = [_vec(n, seed, dev) for seed in (7, 8, 9, 10)]  # p, s, x, r
    want = [t.clone() for t in got]
    kernels.reset_launches()
    kern.kb_pipe(w, *got, alpha, beta, invd)
    kb_pipe_plain(w, *want, alpha, beta, invd)
    torch.cuda.synchronize()
    assert kernels.launches["cg_kb_pipe"] == 1
    for g, want_t in zip(got, want):
        _close(g, want_t)


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "BJ"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097, 4099])
def test_kb_pipe_kernel_branches_match_plain(dev, n, offset, jacobi):
    """Each branch of the CUDA KB_pipe: float4 (every stream 16-byte
    aligned; n % 4 != 0 takes its last quad row by row) and rows (every
    stream one float off an aligned base)."""
    kern = CgKernels(n, (0,), dev)
    alpha, beta = torch.tensor(0.41, device=dev), torch.tensor(-0.37, device=dev)

    def vec(seed, lo=None):
        return _vec(n + offset, seed, dev, lo)[offset:]

    w, invd = vec(5), vec(6, lo=0.1) if jacobi else None
    got = [vec(seed) for seed in (7, 8, 9, 10)]  # p, s, x, r
    want = [t.clone() for t in got]
    kernels.reset_launches()
    kern.kb_pipe(w, *got, alpha, beta, invd)
    kb_pipe_plain(w, *want, alpha, beta, invd)
    torch.cuda.synchronize()
    assert kernels.launches["cg_kb_pipe"] == 1 and sum(kernels.launches.values()) == 1
    for g, want_t in zip(got, want):
        _close(g, want_t)


# ---- the persistent pipelined-CG loop --------------------------------------


def _pipe_state(kern, data, b):
    """The set-up of solve/cg_pipe_fused.py from a zero guess: (x, r, nf)."""
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    return x, r, merged_norm_factor(kern, data, r, x, b)


def _check_pipe_loop(kern, data, b, invd):
    """The pipelined loop kernel against its plain twin (over the plain KA
    and KB_pipe) pinned at 30 iterations and free-running to LOOP_TOL: three
    launches repeat their count and iterate exactly; each launches the loop
    once and K1 twice (the set-up's r0 and norm factor), nothing else."""
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                   max_iter=2000, frequency=1)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=30, max_iter=30,
                                     frequency=1)
    plain_ka = functools.partial(ka_plain, data, kern.offsets)
    for cfg in (pinned, free):
        x_p, r_p, nf_p = _pipe_state(kern, data, b)
        it_p, rn_p, _, conv_p = cg_pipe_loop_plain(plain_ka, kb_pipe_plain, x_p, r_p, nf_p, cfg,
                                                   invd)
        runs = []
        for _ in range(3):  # the kernel repeats its own count and iterate exactly
            kernels.reset_launches()
            x, r, nf = _pipe_state(kern, data, b)
            runs.append((x, *kern.cg_pipe_loop(data, x, r, nf, cfg, invd)))
            torch.cuda.synchronize()
            assert kernels.launches["cg_pipe_loop"] == 1 and kernels.launches["cg_k1"] == 2
            assert sum(kernels.launches.values()) == 3
        x, it, rn, _, conv = runs[0]
        assert all(run[1] == it and torch.equal(run[0], x) for run in runs[1:])
        if cfg is pinned:
            assert it == it_p == 30 and not conv
            _close(x, x_p)
        else:
            assert bool(conv) and bool(conv_p) and abs(it - it_p) <= 1
            assert float(rn) < LOOP_TOL
            r64 = b.double() - dia_spmv_plain(data.double(), kern.offsets, x.double())
            assert float(r64.abs().sum() / nf.double()) <= 10 * LOOP_TOL
            torch.testing.assert_close(x, x_p, rtol=0, atol=1e-3)


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("dims", LOOP_GRIDS, ids=str)
def test_cg_pipe_loop_matches_plain(dev, dims, pc):
    kern, data, b = _loop_setup(dims, dev)
    invd = 1.0 / data[kern.offsets.index(0)] if pc == "BJ" else None
    _check_pipe_loop(kern, data, b, invd)


def test_cg_pipelined_fused_takes_the_loop_on_the_card(dev):
    """cg_pipelined_fused runs identity and Jacobi on the Dia plan as the one
    launch, with no KA or KB_pipe; a plan that is not CgKernels itself keeps
    the host loop over KA and KB_pipe."""
    kern, data, b = _loop_setup((32, 16, 8), dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=1000, frequency=1)
    results = {}
    for pc, invd in (("none", None), ("BJ", 1.0 / data[kern.offsets.index(0)])):
        kernels.reset_launches()
        res = cg_pipelined_fused(kern, data, b, torch.zeros_like(b), cfg, invd=invd)
        assert kernels.launches["cg_pipe_loop"] == 1 and kernels.launches["cg_k1"] == 2
        assert kernels.launches["cg_ka"] == kernels.launches["cg_kb_pipe"] == 0
        assert res.iters > 0 and bool(res.converged)
        assert res.final_res_norm.device.type == "cpu"
        results[pc] = res

    class HostLoop(CgKernels):
        pass

    host = HostLoop(kern.n, kern.offsets, dev)
    kernels.reset_launches()
    res_h = cg_pipelined_fused(host, data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["cg_pipe_loop"] == 0
    assert kernels.launches["cg_kb_pipe"] == res_h.iters
    assert kernels.launches["cg_ka"] == res_h.iters + 1  # the last one's check stops
    assert abs(res_h.iters - results["none"].iters) <= 1
    torch.testing.assert_close(res_h.x, results["none"].x, rtol=0, atol=1e-3)


def test_cg_pipe_loop_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks is refused by the cooperative
    launch; the wrapper raises, falls back to nothing, and the next launch
    is unaffected."""
    kern, data, b = _loop_setup((128, 128, 64), dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=5, frequency=1)
    kern.cg_pipe_loop(data, *_pipe_state(kern, data, b), cfg)
    co_resident = kern._pipe_loop_blocks[0]
    assert 0 < co_resident < -(-kern.n // 512)
    kern._pipe_loop_blocks[0] = 4 * co_resident
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="cg_pipe_loop: CUDA error"):
        kern.cg_pipe_loop(data, *_pipe_state(kern, data, b), cfg)
    assert kernels.launches["cg_pipe_loop"] == 0
    kern._pipe_loop_blocks[0] = co_resident
    assert kern.cg_pipe_loop(data, *_pipe_state(kern, data, b), cfg)[0] == 5


@pytest.mark.parametrize("b_is_c", [False, True], ids=["b,c", "b is c"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_k1b_kernel_matches_plain(dev, case, b_is_c):
    data, offsets = _case(case, dev)
    n = data.shape[1]
    kern = CgKernels(n, offsets, dev)
    a, b, rhat = _vec(n, 3, dev), _vec(n, 4, dev), _vec(n, 5, dev)
    c = b if b_is_c else _vec(n, 6, dev)
    ca, cb = torch.tensor(0.43, device=dev), torch.tensor(-0.29, device=dev)
    kernels.reset_launches()
    w, q, *sums = kern.k1b(data, a, b, c, rhat, ca, cb)
    torch.cuda.synchronize()
    assert kernels.launches["bicgstab_k1b"] == 1
    w2, q2, *sums2 = k1b_plain(data, offsets, a, b, c, rhat, ca, cb)
    _close(w, w2)
    _close(q, q2)
    for g, want in zip(sums, sums2):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4 * float(want.abs()))
    out = (torch.empty_like(a), torch.empty_like(a))
    w3, q3, *_ = kern.k1b(data, a, b, c, rhat, ca, cb, out=out)
    assert w3 is out[0] and q3 is out[1]
    _close(q3, q, rtol=0)


@pytest.mark.parametrize("n", [1000, 70001])
def test_kb_update_kernel_matches_plain(dev, n):
    kern = CgKernels(n, (0,), dev)
    alpha, omega = torch.tensor(0.37, device=dev), torch.tensor(-0.61, device=dev)
    p, s, t, rhat = (_vec(n, seed, dev) for seed in (5, 6, 7, 8))
    xs = [_vec(n, 9, dev) for _ in range(2)]
    rs = [torch.empty(n, device=dev) for _ in range(2)]
    kernels.reset_launches()
    got = kern.kb_update(xs[0], p, s, t, rhat, alpha, omega, rs[0])
    want = kb_update_plain(xs[1], p, s, t, rhat, alpha, omega, rs[1])
    torch.cuda.synchronize()
    assert kernels.launches["bicgstab_kb_update"] == 1
    _close(xs[0], xs[1])
    _close(rs[0], rs[1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)


# offsets of every residue mod 4, so the row-quad K1B takes each shift of its
# source quads, and sources beyond both ends of the rows
K1B_OFFSETS = (-300, -7, -6, -1, 0, 1, 2, 5, 301)


def _offset_data(n, offset, dev):
    """Banded Dia data (K1B_OFFSETS), contiguous, starting `offset` floats
    past an aligned base."""
    data = _banded(n, K1B_OFFSETS, 2, dev)
    flat = torch.empty(data.numel() + offset, device=dev)
    view = flat[offset:].view(data.shape)
    return view.copy_(data)


@pytest.mark.parametrize("b_is_c", [False, True], ids=["b,c", "b is c"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097, 4099])
def test_k1b_kernel_branches_match_plain(dev, n, offset, b_is_c):
    """Each branch of the K1B kernel: row quads (n % 4 == 0, every stream
    16-byte aligned; the sources of each diagonal from one or two aligned
    quads) and rows (n % 4 != 0, or every stream one float off an aligned
    base), each with b and c distinct and one tensor, into new buffers and
    into `out`."""
    kern = CgKernels(n, K1B_OFFSETS, dev)
    data = _offset_data(n, offset, dev)

    def vec(seed):
        return _vec(n + offset, seed, dev)[offset:]

    a, b, rhat = vec(3), vec(4), vec(5)
    c = b if b_is_c else vec(6)
    ca, cb = torch.tensor(-0.43, device=dev), torch.tensor(0.29, device=dev)
    kernels.reset_launches()
    w, q, *sums = kern.k1b(data, a, b, c, rhat, ca, cb)
    out = (vec(7), vec(8))
    w3, q3, *sums3 = kern.k1b(data, a, b, c, rhat, ca, cb, out=out)
    torch.cuda.synchronize()
    assert kernels.launches["bicgstab_k1b"] == 2 and sum(kernels.launches.values()) == 2
    w2, q2, *sums2 = k1b_plain(data, K1B_OFFSETS, a, b, c, rhat, ca, cb)
    assert w3 is out[0] and q3 is out[1]
    for got_w, got_q, got_sums in ((w, q, sums), (w3, q3, sums3)):
        _close(got_w, w2)
        _close(got_q, q2)
        for g, want in zip(got_sums, sums2):
            torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4 * float(want.abs()))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097, 4099])
def test_kb_update_kernel_branches_match_plain(dev, n, offset):
    """Each branch of the CUDA KB_update: float4 (every stream 16-byte
    aligned; n % 4 != 0 takes its last quad row by row) and rows (every
    stream one float off an aligned base)."""
    kern = CgKernels(n, (0,), dev)
    alpha, omega = torch.tensor(-0.23, device=dev), torch.tensor(0.71, device=dev)

    def vec(seed):
        return _vec(n + offset, seed, dev)[offset:]

    p, s, t, rhat = (vec(seed) for seed in (5, 6, 7, 8))
    xs, rs = [vec(9) for _ in range(2)], [vec(10) for _ in range(2)]
    kernels.reset_launches()
    got = kern.kb_update(xs[0], p, s, t, rhat, alpha, omega, rs[0])
    want = kb_update_plain(xs[1], p, s, t, rhat, alpha, omega, rs[1])
    torch.cuda.synchronize()
    assert kernels.launches["bicgstab_kb_update"] == 1 and sum(kernels.launches.values()) == 1
    _close(xs[0], xs[1])
    _close(rs[0], rs[1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs()))


# ---- the persistent merged-BiCGStab loop -------------------------------------

# Poisson: n below one block (343, rows), 1,000 (row quads), 4,097 (rows), 1M;
# convection-diffusion: 2,048, 1,105 (n = 1 mod 4: rows) and 1M
BICGSTAB_LOOP_CASES = [("poisson", (7, 7, 7)), ("poisson", (10, 10, 10)),
                       ("poisson", (17, 241, 1)), ("poisson", (128, 128, 64)),
                       ("convection_diffusion", (16, 16, 8)),
                       ("convection_diffusion", (17, 13, 5)),
                       ("convection_diffusion", (128, 128, 64))]


def _bicgstab_setup(system, dims, dev):
    m = (testing.poisson_ldu(dims) if system == "poisson"
         else testing.convection_diffusion_ldu(dims))
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(m, dtype=np.float32), dev)
    kern = CgKernels(mat.shape[0], mat.offsets, dev)
    return kern, kern.pack_values(mat), _vec(mat.shape[0], 11, dev)


def _bicgstab_state(kern, data, b):
    """The set-up of solve/bicgstab_fused.py from a zero guess: x and (r,
    r̂, ρ, ‖r‖₁, nf)."""
    x = torch.zeros_like(b)
    r = b - kern.apply(data, x)
    return x, (r, r.clone(), torch.sum(r * r), torch.sum(torch.abs(r)),
               merged_norm_factor(kern, data, r, x, b))


@pytest.mark.parametrize("system,dims", BICGSTAB_LOOP_CASES, ids=str)
def test_bicgstab_loop_matches_plain(dev, system, dims):
    """The loop kernel against its plain twin (over the plain K1B and
    KB_update) pinned at 10 iterations (x rtol 1e-4: float32 BiCGStab
    amplifies another summation order; the normalised residual rtol 1e-4
    and atol 1e-6 x the initial one, since the rounding of the float32
    recurrence residual scales with r0, not with the current r) and, on
    convection-diffusion, free-running to LOOP_TOL (±1 iteration, x atol
    1e-3, the float64 residual within 10 x LOOP_TOL): three launches repeat
    their count and iterate exactly; each launches the loop once and K1
    twice (the set-up's r0 and norm factor), nothing else."""
    kern, data, b = _bicgstab_setup(system, dims, dev)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0, max_iter=2000,
                                   frequency=1)
    plain_k1b = functools.partial(k1b_plain, data, kern.offsets)
    for cfg in (pinned, free) if system == "convection_diffusion" else (pinned,):
        x_p, state_p = _bicgstab_state(kern, data, b)
        it_p, rn_p, _, conv_p = bicgstab_loop_plain(plain_k1b, kb_update_plain, x_p, *state_p,
                                                    cfg)
        runs = []
        for _ in range(3):  # the kernel repeats its own count and iterate exactly
            kernels.reset_launches()
            x, state = _bicgstab_state(kern, data, b)
            runs.append((x, *kern.bicgstab_loop(data, x, *state, cfg)))
            torch.cuda.synchronize()
            assert kernels.launches["bicgstab_loop"] == 1 and kernels.launches["cg_k1"] == 2
            assert sum(kernels.launches.values()) == 3
        x, it, rn, init_rn, conv = runs[0]
        assert all(run[1] == it and torch.equal(run[0], x) for run in runs[1:])
        if cfg is pinned:
            assert it == it_p == 10 and not conv
            _close(x, x_p, rtol=1e-4)
            torch.testing.assert_close(rn, rn_p.cpu(), rtol=1e-4, atol=1e-6 * float(init_rn))
        else:
            assert bool(conv) and bool(conv_p) and abs(it - it_p) <= 1
            assert float(rn) < LOOP_TOL
            r64 = b.double() - dia_spmv_plain(data.double(), kern.offsets, x.double())
            assert float(r64.abs().sum() / state[-1].double()) <= 10 * LOOP_TOL
            torch.testing.assert_close(x, x_p, rtol=0, atol=1e-3)


def test_bicgstab_fused_takes_the_loop_on_the_card(dev):
    """bicgstab_fused on the Dia plan runs its whole loop as the one launch,
    with no K1B or KB_update; a plan that is not CgKernels itself keeps the
    host loop over K1B and KB_update."""
    kern, data, b = _bicgstab_setup("convection_diffusion", (32, 32, 16), dev)
    cfg = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0,
                                  max_iter=1000, frequency=1)
    kernels.reset_launches()
    res = bicgstab_fused(kern, data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["bicgstab_loop"] == 1 and kernels.launches["cg_k1"] == 2
    assert kernels.launches["bicgstab_k1b"] == kernels.launches["bicgstab_kb_update"] == 0
    assert res.iters > 0 and bool(res.converged)
    assert res.final_res_norm.device.type == "cpu"

    class HostLoop(CgKernels):
        pass

    host = HostLoop(kern.n, kern.offsets, dev)
    kernels.reset_launches()
    res_h = bicgstab_fused(host, data, b, torch.zeros_like(b), cfg)
    assert kernels.launches["bicgstab_loop"] == 0
    assert kernels.launches["bicgstab_kb_update"] == res_h.iters
    assert kernels.launches["bicgstab_k1b"] == 2 * res_h.iters
    assert abs(res_h.iters - res.iters) <= 1
    torch.testing.assert_close(res_h.x, res.x, rtol=0, atol=1e-3)


def test_bicgstab_loop_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks is refused by the cooperative
    launch; the wrapper raises, falls back to nothing, leaves no error
    behind, and the next launch is unaffected."""
    kern, data, b = _bicgstab_setup("poisson", (128, 128, 64), dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)
    x, state = _bicgstab_state(kern, data, b)
    kern.bicgstab_loop(data, x, *state, cfg)
    co_resident = kern._bicgstab_loop_blocks[0]
    assert 0 < co_resident < -(-kern.n // 512)
    kern._bicgstab_loop_blocks[0] = 4 * co_resident
    kernels.reset_launches()
    x, state = _bicgstab_state(kern, data, b)
    with pytest.raises(RuntimeError, match="bicgstab_loop: CUDA error"):
        kern.bicgstab_loop(data, x, *state, cfg)
    assert kernels.launches["bicgstab_loop"] == 0
    torch.cuda.synchronize()  # no error left behind for the next call to find
    kern._bicgstab_loop_blocks[0] = co_resident
    assert kern.bicgstab_loop(data, x, *state, cfg)[0] == 5
    torch.cuda.synchronize()


def test_slice4_wrappers_raise_on_bad_operands(dev):
    n = 513
    kern = CgKernels(n, (-1, 0, 1), dev)
    data = _banded(n, (-1, 0, 1), 0, dev)
    a, b, rhat = _vec(n, 1, dev), _vec(n, 2, dev), _vec(n, 3, dev)
    ca = torch.tensor(0.5, device=dev)
    with pytest.raises(ValueError, match="overlaps"):  # K1B's output over an input
        kern.k1b(data, a, b, b, rhat, ca, ca, out=(b, torch.empty_like(a)))
    with pytest.raises(ValueError, match="overlaps"):
        kern.k1b(data, a, b, b, rhat, ca, ca, out=(torch.empty_like(a), a[1:]))
    with pytest.raises(TypeError, match="0-d float32"):
        kern.k1b(data, a, b, b, rhat, 0.5, ca)
    with pytest.raises(TypeError, match="float32"):
        kern.ka(data, a, b.double())
    with pytest.raises(ValueError, match="shape"):
        kern.kb_pipe(a, b, rhat, a, b[:-1], ca, ca)
    with pytest.raises(TypeError, match="0-d float32"):
        kern.kb_update(a, b, rhat, a, b, ca, 0.5, torch.empty_like(a))


# name -> (solver, controls, preconditioner, kernels launched, kernels never
# launched): the pipelined CG and the merged BiCGStab run their whole loop
# as one launch
SLICE4_SOLVES = {
    "pipelined-none": ("GKOCG", {"pipelinedCG": True}, "none", ("cg_pipe_loop",),
                       ("cg_ka", "cg_kb_pipe")),
    "pipelined-BJ": ("GKOCG", {"pipelinedCG": True}, {"preconditioner": "BJ"},
                     ("cg_pipe_loop",), ("cg_ka", "cg_kb_pipe")),
    "bicgstab-BJ": ("GKOBiCGStab", {}, {"preconditioner": "BJ"},
                    ("dia_spmv", "bicgstab_gen_loop"), ("bicgstab_loop",)),
    "bicgstab-fused": ("GKOBiCGStab", {"fusedBiCGStab": True}, "none", ("bicgstab_loop",),
                       ("bicgstab_k1b", "bicgstab_kb_update")),
}


@pytest.mark.parametrize("name", list(SLICE4_SOLVES))
def test_foam_slice4_on_card_matches_cpu(dev, name):
    """The pipelined CG on the Poisson system and BiCGStab on the asymmetric
    convection-diffusion system (on which float32 BiCGStab converges
    smoothly), on the card against the same solve on the CPU."""
    solver, extra, pc, launched, never = SLICE4_SOLVES[name]
    m = (testing.poisson_ldu((32, 32, 16)) if solver == "GKOCG"
         else testing.convection_diffusion_ldu((32, 32, 16)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "matrixFormat": "Dia", "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, "preconditioner": pc, **extra}
    x_cpu, perf_cpu = foam.FoamSolver("p", {**ctl, "executor": "cpu"}).solve(m, b)
    kernels.reset_launches()
    x, perf = foam.FoamSolver("p", {**ctl, "executor": "cuda"}).solve(m, b)
    assert x.device.type == "cuda"
    assert all(kernels.launches[k] > 0 for k in launched)
    assert all(kernels.launches[k] == 0 for k in never)
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


# ---- the Dia SpMV in row quads and the general-BiCGStab loop ---------------


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [4096, 4097, 4099, 1 << 20])
def test_dia_spmv_branches_are_exact(dev, n, offset):
    """Each branch of the Dia SpMV: row quads (n % 4 == 0, data, x and y
    16-byte aligned; a diagonal's sources from one or two aligned quads,
    every residue of the offsets mod 4) and rows (n % 4 != 0, or every
    stream one float off an aligned base).  Each product and sum is rounded
    as the plain version rounds it, so the two are equal."""
    plan = DiaPlan(n, K1B_OFFSETS, dev)
    data = _offset_data(n, offset, dev)
    x = _vec(n + offset, 3, dev)[offset:]
    kernels.reset_launches()
    y = dia_spmv(plan, data, x)
    torch.cuda.synchronize()
    assert kernels.launches["dia_spmv"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(y, dia_spmv_plain(data, K1B_OFFSETS, x))


def _shuffled(n, seed=0):
    """A permutation of 0..n-1 inside each run of 128 (the last run may be
    shorter)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([lo + rng.permutation(min(128, n - lo)) for lo in range(0, n, 128)])


def _gen_system(system, dims, fmt, dev):
    """(plan, data, matrix, b, invd): the Poisson or convection-diffusion
    system of `dims` as Dia, or renumbered inside each run of 128 rows as
    Gdia."""
    m = (testing.poisson_ldu(dims) if system == "poisson"
         else testing.convection_diffusion_ldu(dims))
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    if fmt == "Gdia":
        inv = np.empty(m.n, np.int64)
        inv[_shuffled(m.n)] = np.arange(m.n)
        rows, cols = inv[np.asarray(coo.rows)], inv[np.asarray(coo.cols)]
        order = np.lexsort((cols, rows))
        coo = formats.Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                          vals=np.asarray(coo.vals)[order], shape=coo.shape)
        mat = gdia.gdia_from_coo(coo, device=dev)
        kern = GdiaCgKernels(m.n, mat.plane_offsets, dev)
    else:
        mat = formats.coo_to_dia(coo, dev)
        kern = CgKernels(m.n, mat.offsets, dev)
    diag = np.zeros(m.n, np.float32)
    on = np.asarray(coo.rows) == np.asarray(coo.cols)
    diag[np.asarray(coo.rows)[on]] = np.asarray(coo.vals)[on]
    invd = torch.tensor(1.0 / diag, device=dev)
    return kern, kern.pack_values(mat), mat, _vec(m.n, 11, dev), invd


def _gen_solve(kern, data, mat, b, invd, cfg, loop=True):
    """solve/bicgstab.py from a zero guess: with the plan's loop kernel, or
    (loop=False) the host loop over the plain SpMV on the card — the twin's
    operations in the twin's order."""
    mv = spmv.matvec(mat) if loop else (lambda v: spmv.spmv(mat, v))
    ops = single_device_ops(mv, kern.n, precond=None if invd is None else (lambda r: invd * r))
    return bicgstab(ops, b, torch.zeros_like(b), cfg, *((kern, data, invd) if loop else ()))


# Dia: n below one block (343, rows), 1,000 (row quads), 4,097 (rows), 1M;
# convection-diffusion 2,048, 1,105 (rows) and 1M.  Gdia: the same systems
# renumbered (1,105: a last partial quad)
GEN_LOOP_CASES = [("Dia", "poisson", (7, 7, 7)), ("Dia", "poisson", (10, 10, 10)),
                  ("Dia", "poisson", (17, 241, 1)), ("Dia", "poisson", (128, 128, 64)),
                  ("Dia", "convection_diffusion", (16, 16, 8)),
                  ("Dia", "convection_diffusion", (17, 13, 5)),
                  ("Dia", "convection_diffusion", (128, 128, 64)),
                  ("Gdia", "poisson", (16, 16, 8)), ("Gdia", "convection_diffusion", (16, 16, 8)),
                  ("Gdia", "convection_diffusion", (17, 13, 5)),
                  ("Gdia", "convection_diffusion", (128, 128, 64))]


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("fmt,system,dims", GEN_LOOP_CASES, ids=str)
def test_bicgstab_gen_loop_matches_plain(dev, fmt, system, dims, pc):
    """The loop kernel against its plain twin on the card (the host loop of
    solve/bicgstab.py over the plain SpMV) pinned at 10 iterations (x rtol
    1e-4; the normalised residual rtol 1e-4, atol 1e-6 x the initial one)
    and, on convection-diffusion, free-running to LOOP_TOL (±1 iteration, x
    atol 1e-3, the float64 residual within 10 x LOOP_TOL).  Three launches
    repeat their count and iterate exactly; each solve launches the loop
    once and the format's SpMV twice (the set-up's r0 and norm factor),
    nothing else."""
    kern, data, mat, b, invd = _gen_system(system, dims, fmt, dev)
    invd = invd if pc == "BJ" else None
    spmv_name = "gdia_spmv" if fmt == "Gdia" else "dia_spmv"
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0, max_iter=2000,
                                   frequency=1)
    for cfg in (pinned, free) if system == "convection_diffusion" else (pinned,):
        twin = _gen_solve(kern, data, mat, b, invd, cfg, loop=False)
        runs = []
        for _ in range(3):
            kernels.reset_launches()
            runs.append(_gen_solve(kern, data, mat, b, invd, cfg))
            torch.cuda.synchronize()
            assert kernels.launches["bicgstab_gen_loop"] == 1
            assert kernels.launches[spmv_name] == 2 and sum(kernels.launches.values()) == 3
        res = runs[0]
        assert all(r.iters == res.iters and torch.equal(r.x, res.x) for r in runs[1:])
        if cfg is pinned:
            assert res.iters == twin.iters == 10 and not bool(res.converged)
            _close(res.x, twin.x, rtol=1e-4)
            torch.testing.assert_close(res.final_res_norm, twin.final_res_norm.cpu(),
                                       rtol=1e-4, atol=1e-6 * float(res.init_res_norm))
        else:
            assert bool(res.converged) and bool(twin.converged)
            assert abs(res.iters - twin.iters) <= 1 and float(res.final_res_norm) < LOOP_TOL
            x64 = res.x.double()
            ax = (dia_spmv_plain(mat.data.double(), mat.offsets, x64) if fmt == "Dia" else
                  gdia.gdia_spmv_plain(mat.vals.double(), mat.lidx, mat.plane_offsets, x64))
            # the norm factor of a zero guess is ||b||_1 (+ SMALL)
            assert float((b.double() - ax).abs().sum() / b.double().abs().sum()) <= (
                10 * LOOP_TOL)
            torch.testing.assert_close(res.x, twin.x, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fmt", ["Dia", "Gdia", "Xell"])
@pytest.mark.parametrize("pc", ["none", {"preconditioner": "BJ"}], ids=["none", "BJ"])
def test_gkobicgstab_takes_the_gen_loop_on_the_card(dev, pc, fmt):
    """GKOBiCGStab (`fusedBiCGStab` false, route "bicgstab") on a Dia, a
    Gdia or an Xell matrix with `none` or `BJ`: each solve on its resident
    state is one loop launch and the set-up's two SpMVs — no SpMV inside the
    loop — and equals the same solve on the CPU ±1 iteration."""
    m = testing.convection_diffusion_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOBiCGStab", "matrixFormat": fmt, "tolerance": 1e-6, "relTol": 0,
           "adaptMinIter": False, "preconditioner": pc}
    x_cpu, perf_cpu = foam.FoamSolver("u", {**ctl, "executor": "cpu"}).solve(m, b)
    slv = foam.FoamSolver("u", {**ctl, "executor": "cuda"})
    x, perf = slv.solve(m, b)
    assert slv.route == "bicgstab" and type(slv.kern) is {
        "Dia": CgKernels, "Gdia": GdiaCgKernels, "Xell": xell.XellCgKernels}[fmt]
    spmv_name = f"{fmt.lower()}_spmv"
    kernels.reset_launches()
    again = slv._redispatch()
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launches.items() if v} == {"bicgstab_gen_loop": 1,
                                                                spmv_name: 2}
    assert again.iters == perf.n_iterations and torch.equal(again.x, x)
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=0, atol=1e-3)


def test_gkobicgstab_host_loop_cases_on_the_card(dev):
    """Multigrid keeps the host loop (why_not names it, the solver keeps no
    plan), and so does a subclassed plan handed to solve/bicgstab.py: two
    SpMV launches per iteration, no loop launch."""
    m = testing.convection_diffusion_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    for extra in ({"preconditioner": "Multigrid"},):
        slv = foam.FoamSolver("u", {"solver": "GKOBiCGStab", "executor": "cuda",
                                    "tolerance": 1e-6, "relTol": 0, "adaptMinIter": False,
                                    **extra})
        _, perf = slv.solve(m, b)
        assert slv.kern is None and perf.converged
        kernels.reset_launches()
        slv._redispatch()
        torch.cuda.synchronize()
        assert kernels.launches["bicgstab_gen_loop"] == 0
        spmvs = kernels.launches["dia_spmv"] + kernels.launches["xell_spmv"]
        assert spmvs >= 2 * perf.n_iterations

    class Sub(CgKernels):
        pass

    kern, data, mat, bd, _ = _gen_system("convection_diffusion", (16, 16, 8), "Dia", dev)
    sub = Sub(kern.n, mat.offsets, dev)
    ops = single_device_ops(spmv.matvec(mat), kern.n)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)
    kernels.reset_launches()
    res = bicgstab(ops, bd, torch.zeros_like(bd), cfg, sub, data)
    torch.cuda.synchronize()
    assert res.iters == 5 and kernels.launches["bicgstab_gen_loop"] == 0
    assert kernels.launches["dia_spmv"] == 2 + 2 * 5  # r0 and the norm factor, 2 per iteration


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("name", list(XELL_LOOP_CASES))
def test_bicgstab_gen_loop_xell_matches_plain(dev, name, pc):
    """The loop kernel's Xell variants against the twin on the card (the host
    loop of solve/bicgstab.py over the plain Xell SpMV) pinned at 10
    iterations (x rtol 1e-4, the normalised residual rtol 1e-4): three
    launches repeat their count and iterate exactly; each solve launches
    the loop once and the Xell SpMV twice (the set-up's r0 and norm
    factor), nothing else."""
    kern, data, b, invd = _xell_loop_setup(name, pc, dev)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    pcf = None if invd is None else (lambda r: invd * r)
    plain = single_device_ops(lambda v: xell.xell_spmv_plain(kern.plan, *data, v), kern.n,
                              precond=pcf)
    twin = bicgstab(plain, b, torch.zeros_like(b), pinned)
    ops = single_device_ops(functools.partial(kern.spmv, data), kern.n, precond=pcf)
    runs = []
    for _ in range(3):
        kernels.reset_launches()
        runs.append(bicgstab(ops, b, torch.zeros_like(b), pinned, kern, data, invd))
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {"bicgstab_gen_loop": 1,
                                                                    "xell_spmv": 2}
    res = runs[0]
    assert all(r.iters == res.iters and torch.equal(r.x, res.x) for r in runs[1:])
    assert res.iters == twin.iters == 10 and not bool(res.converged)
    _close(res.x, twin.x, rtol=1e-4)
    torch.testing.assert_close(res.final_res_norm, twin.final_res_norm.cpu(), rtol=1e-4,
                               atol=1e-6 * float(res.init_res_norm))


def test_bicgstab_gen_loop_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks is refused by the cooperative
    launch; the wrapper raises, falls back to nothing, leaves no error
    behind, and the next launch is unaffected."""
    kern, data, mat, b, _ = _gen_system("poisson", (128, 128, 64), "Dia", dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)
    assert _gen_solve(kern, data, mat, b, None, cfg).iters == 5
    co_resident = kern._gen_loop_blocks[0]
    assert 0 < co_resident < -(-kern.n // 512)
    kern._gen_loop_blocks[0] = 4 * co_resident
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="bicgstab_gen_loop: CUDA error"):
        _gen_solve(kern, data, mat, b, None, cfg)
    assert kernels.launches["bicgstab_gen_loop"] == 0
    torch.cuda.synchronize()  # no error left behind for the next call to find
    kern._gen_loop_blocks[0] = co_resident
    assert _gen_solve(kern, data, mat, b, None, cfg).iters == 5
    torch.cuda.synchronize()


def test_bicgstab_gen_loop_raises_on_bad_operands(dev):
    kern, data, mat, b, invd = _gen_system("poisson", (10, 10, 10), "Dia", dev)
    x, r = torch.zeros_like(b), b.clone()
    one = torch.ones((), device=dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=2,
                                  frequency=1)
    with pytest.raises(TypeError, match="float32"):
        kern.bicgstab_gen_loop(data, x, r, r.clone(), one, one, one, cfg, invd=invd.double())
    with pytest.raises(ValueError, match="shape"):
        kern.bicgstab_gen_loop(data, x, r, r[:-1].clone(), one, one, one, cfg)
    with pytest.raises(TypeError, match="0-d float32"):
        kern.bicgstab_gen_loop(data, x, r, r.clone(), 1.0, one, one, cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        kern.bicgstab_gen_loop(data.cpu(), x.cpu(), r, r.clone(), one, one, one, cfg)


# ---- slice 5: the read-peak plane sum and the measurement path -------------


@pytest.mark.parametrize("n", [1, 255, 257, 8_388_608])
@pytest.mark.parametrize("nd", [1, 7, 9])
def test_plane_sum_kernel_matches_plain(dev, nd, n):
    g = torch.Generator(device=dev).manual_seed(nd)
    d = torch.randn((nd, n), generator=g, device=dev)
    c = torch.tensor(-0.37, device=dev)
    kernels.reset_launches()
    y = roofline.plane_sum(c, d)
    torch.cuda.synchronize()
    assert kernels.launches["read_peak"] == 1 and y.shape == (n,)
    # the kernel rounds the product and each sum on its own, as the plain
    # version's separate ops do; the tolerance allows a last-bit difference
    _close(y, roofline.plane_sum_plain(c, d))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 1001, 1002, 1003, 1004, 65539, 1 << 20])
@pytest.mark.parametrize("nd", [1, 7, 9])
def test_plane_sum_edges_are_exact(dev, nd, n, offset):
    """Both branches of the kernel (float4 when n % 4 == 0 and the planes
    are 16-byte aligned, scalar otherwise, here also for a base one float
    off) round as the plain version: error 0, with c != 1 and nd above the
    kernel's 8 planes in flight."""
    g = torch.Generator(device=dev).manual_seed(n + nd)
    flat = torch.randn(nd * n + offset, generator=g, device=dev)
    d = flat[offset:].view(nd, n)
    c = torch.tensor(-0.37, device=dev)
    kernels.reset_launches()
    y = roofline.plane_sum(c, d)
    torch.cuda.synchronize()
    assert kernels.launches["read_peak"] == 1
    assert torch.equal(y, roofline.plane_sum_plain(c, d))


def test_plane_sum_wrapper_raises_on_bad_operands(dev):
    d = torch.randn((7, 513), device=dev)
    c = torch.tensor(1.0, device=dev)
    with pytest.raises(TypeError, match="float32"):
        roofline.plane_sum(c, d.double())
    with pytest.raises(TypeError, match="nd >= 1"):
        roofline.plane_sum(c, d[0])
    with pytest.raises(ValueError, match="contiguous"):
        roofline.plane_sum(c, d[:, ::2])
    with pytest.raises(TypeError, match="0-d float32"):
        roofline.plane_sum(c.cpu(), d)


def test_measure_chained_replays_the_chain(dev):
    """The captured graph's output equals an eager chain of the same length
    (the same kernels on the same inputs), and the measured rate of the Dia
    SpMV beyond the L2 stays under the published peak."""
    mat = bench._poisson_dia((32, 16, 8), dev)
    data = mat.data / 12.0  # spectral radius <= 1: the chain stays finite
    plan = DiaPlan.of(mat)

    def mv(v, data):
        return dia_spmv(plan, data, v)

    x0 = _vec(mat.shape[0], 1, dev)
    graph, _, out = roofline._capture_chain(mv, x0, 8, (data,))
    graph.replay()
    torch.cuda.synchronize()
    want = x0
    for _ in range(8):
        want = mv(want, data)
    assert torch.equal(out, want)
    big = bench._poisson_dia(bench.GRID_8M, dev)
    big_plan = DiaPlan.of(big)
    r = roofline.measure_chained(lambda v, data: dia_spmv(big_plan, data, v),
                                 torch.ones(big.shape[0], device=dev), iters=256,
                                 operands=(big.data,), bytes_moved=roofline.spmv_bytes(big))
    assert r.peak_gbps == roofline.hbm_peak_gbps(dev)
    assert 0 < r.gbps <= 1.05 * r.peak_gbps


def test_device_busy_seconds_and_the_read_peaks(dev):
    mat = bench._poisson_dia((64, 64, 32), dev)
    plan = DiaPlan.of(mat)
    x = torch.ones(mat.shape[0], device=dev)
    busy = device_time.device_busy_seconds(lambda: [dia_spmv(plan, mat.data, x)
                                                    for _ in range(20)])
    assert busy > 0
    per = roofline.measure_device_chained(lambda v, d: dia_spmv(plan, d, v), x, 20,
                                          operands=(mat.data,))
    assert 0 < per < busy
    published = roofline.hbm_peak_gbps(dev)
    for gbps in (roofline.measure_read_peak(chain_len=200),
                 roofline.measure_read_peak_device(iters=200)):
        assert 0 < gbps <= 1.05 * published


def test_time_device_solve_on_the_card(dev):
    m = testing.poisson_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    x, perf = foam.solve("p", m, b, {"solver": "GKOCG", "executor": "cuda",
                                     "tolerance": 1e-6, "relTol": 0})
    slv = registry.global_registry.get("p_solver")
    assert slv.time_device_solve() > 0
    again = slv._redispatch()
    assert again.iters == perf.n_iterations and torch.equal(again.x, x)


# ---- the gather SpMVs of Coo, Csr, Ell, Sell and Hybrid (slice 14) ----------

GATHER_PORT = {"Coo": formats.coo_to_device, "Csr": formats.coo_to_csr,
               "Ell": formats.coo_to_ell, "Sell": formats.coo_to_sell,
               "Hybrid": formats.coo_to_hybrid}
GATHER_LAUNCH = {"Coo": "csr_spmv", "Csr": "csr_spmv", "Ell": "ell_spmv",
                 "Sell": "sell_spmv", "Hybrid": "hybrid_spmv"}
# the CG loop kernel's variant each format's GKOCG `none`/`BJ` solve launches
GATHER_CG_LOOP = {"Coo": "csr_cg_loop", "Csr": "csr_cg_loop", "Ell": "ell_cg_loop",
                  "Sell": "sell_cg_loop", "Hybrid": "ell_cg_loop"}


def _gather_dense(kind):
    """Seeded float32 test matrices: 'random' (empty rows, a dense row, n
    not a multiple of 8 or 64), 'long' (rows of 33..200 entries), 'widths'
    (slices of more than 8 distinct widths, so Sell rounds them to powers of
    two), 'buckets' (rows of 0..255 entries), 'one' (n = 1)."""
    rng = np.random.default_rng(0)
    if kind == "one":
        return np.array([[2.5]], np.float32)
    if kind == "long":
        n = 301
        a = np.zeros((n, n), np.float32)
        for i in range(n):
            k = 33 + (i * 7) % 168
            a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
        return a
    if kind == "widths":
        n = 300
        a = np.zeros((n, n), np.float32)
        for i in range(n):
            k = (i // 4) % 25
            a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
        return a
    if kind == "buckets":  # rows of 0..255 entries: nine Sell buckets at (1, 1)
        n = 600
        a = np.zeros((n, n), np.float32)
        for i in range(n):
            k = (i * 37) % 256
            a[i, rng.choice(n, size=k, replace=False)] = rng.normal(size=k)
        return a
    n = 517
    a = (rng.random((n, n)) < 0.04) * rng.normal(size=(n, n))
    a[n // 2] = rng.normal(size=n)
    a[2] = a[7] = 0.0
    return a.astype(np.float32)


def _gather_mat(fmt, coo, dev, **kw):
    return GATHER_PORT[fmt](coo, device=dev, **kw)


def _gather_check(fmt, m, dev):
    """The kernel on the card against its twin on CPU copies: the same
    bits; one launch counted."""
    x = _vec(m.shape[0], 3, dev)
    before = kernels.launches[GATHER_LAUNCH[fmt]]
    y = spmv.matvec(m)(x)
    torch.cuda.synchronize()
    assert kernels.launches[GATHER_LAUNCH[fmt]] == before + 1
    m_cpu = _to_cpu(m)
    assert torch.equal(y.cpu(), spmv.spmv(m_cpu, x.cpu()))


def _to_cpu(m):
    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if hasattr(v, "__dataclass_fields__"):
            return _to_cpu(v)
        return v

    import dataclasses as dc
    return dc.replace(m, **{f.name: cpu(getattr(m, f.name)) for f in dc.fields(m)})


@pytest.mark.parametrize("kind", ["random", "long", "widths", "one"])
@pytest.mark.parametrize("fmt", list(GATHER_PORT))
def test_gather_spmv_matches_its_twin_bit_for_bit(dev, fmt, kind):
    coo = formats.coo_from_dense(_gather_dense(kind))
    m = _gather_mat(fmt, coo, dev)
    if fmt == "Sell" and kind == "widths":
        assert len(m.widths) <= 8 and all(w & (w - 1) == 0 for w in m.widths)
    _gather_check(fmt, m, dev)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "long"])
def test_csr_spmv_at_every_group_size(dev, group, kind):
    from ogl_tpu_torch.kernels import gather_spmv

    m = formats.coo_to_csr(formats.coo_from_dense(_gather_dense(kind)), device=dev)
    x = _vec(m.shape[0], 3, dev)
    y = gather_spmv.csr_spmv(m, x, group)
    assert torch.equal(y.cpu(), gather_spmv.csr_spmv(_to_cpu(m), x.cpu(), group))


@pytest.mark.parametrize("kind, c, sigma", [("widths", 8, 64), ("widths", 4, 1),
                                           ("buckets", 1, 1)])
def test_sell_spmv_over_its_bucket_table(dev, kind, c, sigma):
    """Slice heights 8, 4 and 1; at (1, 1) the rows of 0..255 entries take
    nine power-of-two buckets, all in one launch."""
    coo = formats.coo_from_dense(_gather_dense(kind))
    m = formats.coo_to_sell(coo, c, sigma, device=dev)
    if kind == "buckets":
        assert len(m.widths) == 9
    _gather_check("Sell", m, dev)


@pytest.mark.parametrize("width", [1, 10000, None])
def test_hybrid_spmv_all_tail_empty_tail_and_default(dev, width):
    coo = formats.coo_from_dense(_gather_dense("random"))
    m = formats.coo_to_hybrid(coo, width, device=dev)
    assert (m.tail.nnz == 0) == (width == 10000)
    _gather_check("Hybrid", m, dev)


@pytest.mark.parametrize("fmt", list(GATHER_PORT))
def test_gather_spmv_on_zero_rows(dev, fmt):
    """n = 0: the wrapper launches nothing on the card and returns an empty
    y (the C entry point returns at once), and still counts its call."""
    e_i = torch.zeros(0, dtype=torch.int32, device=dev)
    e_f = torch.zeros(0, dtype=torch.float32, device=dev)
    ptr = torch.zeros(1, dtype=torch.int32, device=dev)
    csr = formats.Csr(row_ptr=ptr, cols=e_i, vals=e_f, shape=(0, 0))
    ell = formats.Ell(cols=e_i.view(1, 0), vals=e_f.view(1, 0), shape=(0, 0), warp_slots=e_i)
    m = {"Coo": formats.DeviceCoo(row_ptr=ptr, cols=e_i, vals=e_f, shape=(0, 0)), "Csr": csr,
         "Ell": ell, "Hybrid": formats.Hybrid(ell=ell, tail=csr, shape=(0, 0)),
         "Sell": formats.Sell(cols=e_i, vals=e_f, slot_rows=e_i,
                              table=torch.zeros((0, 3), dtype=torch.int64, device=dev),
                              slice_widths=e_i,
                              slice_buckets=torch.zeros(0, dtype=torch.uint8, device=dev),
                              widths=(), n_slices=(), shape=(0, 0), slice_height=8)}[fmt]
    y = spmv.matvec(m)(e_f)
    torch.cuda.synchronize()
    assert y.shape == (0,)


def test_gather_spmv_on_the_knn_mesh(dev):
    """The kNN-6 mesh (RCM-numbered) in every format, and the same mesh in
    its points' numbering, which the ladder lands on Ell."""
    m_orig, perm = testing.knn_ldu(20000)
    m_rcm = testing.renumber_ldu(m_orig, np.argsort(perm))
    coo = ldu.ldu_to_coo_host(m_rcm, dtype=np.float32)
    for fmt in GATHER_PORT:
        _gather_check(fmt, _gather_mat(fmt, coo, dev), dev)
    c = ldu.ldu_to_coo_host(m_orig, dtype=np.float32)
    landed = spmv.pack_fast(c.rows, c.cols, c.vals, m_orig.n, presorted=True, device=dev)
    assert isinstance(landed, formats.Ell)
    _gather_check("Ell", landed, dev)


@pytest.mark.parametrize("fmt", list(GATHER_PORT))
def test_gather_spmv_never_reaches_its_twin_on_the_card(dev, fmt, monkeypatch):
    """A CUDA tensor never reaches a twin, and a malformed operand raises
    instead of launching."""
    from ogl_tpu_torch.kernels import gather_spmv

    def refuse(*args, **kw):
        raise AssertionError("a twin ran on the card")

    for name in ("spmv_csr", "spmv_ell", "spmv_sell", "spmv_hybrid"):
        monkeypatch.setattr(gather_spmv, name, refuse)
    coo = formats.coo_from_dense(_gather_dense("random"))
    m = _gather_mat(fmt, coo, dev)
    y = spmv.matvec(m)(_vec(m.shape[0], 1, dev))
    assert bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="shape"):
        spmv.matvec(m)(_vec(m.shape[0] + 1, 1, dev))
    with pytest.raises(TypeError, match="dtype"):
        spmv.matvec(m)(_vec(m.shape[0], 1, dev).double())


@pytest.mark.parametrize("fmt", list(GATHER_PORT))
def test_foam_solve_on_each_gather_format(dev, fmt):
    """GKOCG `BJ` on the kNN-6 mesh with an explicit matrixFormat: the
    general CG, its loop one launch of the CG loop kernel's variant of the
    format (Coo and Csr: the Csr one), the format's SpMV only the set-up's
    (2) and the residual-eval timing's (9); the count of the same solve on
    the CPU ±1."""
    m, perm = testing.knn_ldu(20000)
    m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOCG", "tolerance": 1e-6, "relTol": 0, "matrixFormat": fmt,
           "preconditioner": {"preconditioner": "BJ"}}
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, {**ctl, "executor": "cuda"})
    torch.cuda.synchronize()
    name = GATHER_LAUNCH[fmt]
    assert kernels.launches[name] == 2 + 9
    assert kernels.launches[GATHER_CG_LOOP[fmt]] == 1
    assert sum(kernels.launches.values()) == 12
    assert registry.global_registry.get("p_solver").route == "cg"
    _, perf_cpu = foam.solve("q", m, b, {**ctl, "executor": "cpu"})
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1


# ---- slice 15: the Ell row body and the loops on Ell and Hybrid -------------

# the kNN-6 mesh at 20,000 cells (a whole number of warps and of row quads)
# and 20,003 (a last warp of 3 rows, no row quads); Hybrid at its
# 80th-percentile width (a tail) and at a width above every row (no tail)
ELL_LOOP_CASES = {"Ell": ("Ell", 20000, None), "Ell n%32=3": ("Ell", 20003, None),
                  "Hybrid": ("Hybrid", 20000, None),
                  "Hybrid no tail n%32=3": ("Hybrid", 20003, 64)}


def _ell_loop_setup(case, pc, dev):
    """(plan, data, matrix, b, invd) of an ELL_LOOP_CASES case."""
    from ogl_tpu_torch.kernels.ell import EllCgKernels

    fmt, n, width = ELL_LOOP_CASES[case]
    coo = _knn_coo(n)
    mat = (formats.coo_to_ell(coo, device=dev) if fmt == "Ell"
           else formats.coo_to_hybrid(coo, width, device=dev))
    if fmt == "Hybrid":
        assert (mat.tail.nnz == 0) == (width is not None)
    kern = EllCgKernels.for_matrix(mat)
    diag = np.zeros(n, np.float32)
    on = coo.rows == coo.cols
    diag[coo.rows[on]] = coo.vals[on]
    invd = torch.tensor(1.0 / diag, device=dev) if pc == "BJ" else None
    return kern, kern.pack_values(mat), mat, _vec(n, 11, dev), invd


def test_ell_spmv_stops_each_warp_at_its_group(dev):
    """Slot counts that differ from one 32-row group to the next and a
    partial last warp (_gather_dense 'random': 517 rows, an empty and a
    dense row): Ell and Hybrid bit-equal to their twins on CPU copies, and
    to the sum over every slot."""
    coo = formats.coo_from_dense(_gather_dense("random"))
    for fmt in ("Ell", "Hybrid"):
        m = _gather_mat(fmt, coo, dev)
        ell = m.ell if fmt == "Hybrid" else m
        assert len(set(ell.warp_slots.tolist())) > 1 or fmt == "Hybrid"
        _gather_check(fmt, m, dev)


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("case", list(ELL_LOOP_CASES))
def test_ell_cg_loop_matches_plain(dev, case, pc):
    """The CG loop kernel's Ell variants against cg_loop_plain over the Ell
    (Hybrid) twin's K1, pinned and free-running (_check_loop): one
    ell_cg_loop launch per solve, the SpMV twice for the set-up."""
    from ogl_tpu_torch.kernels.ell import ell_k1_plain

    kern, data, mat, b, invd = _ell_loop_setup(case, pc, dev)
    mat64 = formats.cast_values(mat, torch.float64)
    _check_loop(kern, data, b, invd, functools.partial(ell_k1_plain, mat),
                GATHER_LAUNCH[ELL_LOOP_CASES[case][0]], lambda v: spmv.spmv(mat64, v),
                loop_counter="ell_cg_loop")


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("case", list(ELL_LOOP_CASES))
def test_ell_bicgstab_gen_loop_matches_plain(dev, case, pc):
    """The general-BiCGStab loop kernel's Ell variants against the twin on
    the card (solve/bicgstab.py's host loop over the Ell twin) pinned at 10
    iterations (x and the normalised residual rtol 1e-4): three launches
    repeat their count and iterate exactly, each one loop launch and two
    SpMVs (the set-up's)."""
    kern, data, mat, b, invd = _ell_loop_setup(case, pc, dev)
    name = GATHER_LAUNCH[ELL_LOOP_CASES[case][0]]
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    twin = _gen_solve(kern, data, mat, b, invd, pinned, loop=False)
    runs = []
    for _ in range(3):
        kernels.reset_launches()
        runs.append(_gen_solve(kern, data, mat, b, invd, pinned))
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {
            "ell_bicgstab_gen_loop": 1, name: 2}
    res = runs[0]
    assert all(r.iters == res.iters and torch.equal(r.x, res.x) for r in runs[1:])
    assert res.iters == twin.iters == 10 and not bool(res.converged)
    _close(res.x, twin.x, rtol=1e-4)
    torch.testing.assert_close(res.final_res_norm, twin.final_res_norm.cpu(), rtol=1e-4,
                               atol=1e-6 * float(res.init_res_norm))


def test_ell_loops_refuse_a_grid_too_large_and_bad_operands(dev):
    """On the 64×64×48 Poisson grid as Ell (196,608 rows: more blocks of
    512 than fit on the card), four times the co-resident grid is refused by
    the cooperative launch: the wrappers raise, count nothing and leave no
    error behind, and the next launch is unaffected.  A wrong operand raises
    before any launch."""
    from ogl_tpu_torch.kernels.ell import EllCgKernels
    from ogl_tpu_torch.kernels.fused import LOOP_ELL, LOOP_JACOBI

    coo = ldu.ldu_to_coo_host(testing.poisson_ldu((64, 64, 48)), dtype=np.float32)
    mat = formats.coo_to_ell(coo, device=dev)
    kern = EllCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    b, invd = _vec(kern.n, 11, dev), torch.full((kern.n,), 1.0 / 6.0, device=dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)

    def run_cg():
        (x, *state), z = _loop_state(kern, data, b, invd)
        return kern.cg_loop(data, x, *state, cfg, invd=invd, z=z)[0]

    def run_gen():
        return _gen_solve(kern, data, mat, b, invd, cfg).iters

    v = LOOP_ELL | LOOP_JACOBI
    for cache, what, run in ((kern._loop_blocks, "ell_cg_loop", run_cg),
                             (kern._gen_loop_blocks, "ell_bicgstab_gen_loop", run_gen)):
        assert run() == 5
        co_resident = cache[v]
        assert 0 < co_resident < -(-kern.n // 512)
        cache[v] = 4 * co_resident
        kernels.reset_launches()
        with pytest.raises(RuntimeError, match=f"{what}: CUDA error"):
            run()
        assert kernels.launches[what] == 0
        torch.cuda.synchronize()  # no error left behind for the next call to find
        cache[v] = co_resident
        assert run() == 5
    (x, *state), z = _loop_state(kern, data, b, invd)
    with pytest.raises(TypeError, match="float32"):
        kern.cg_loop(data, x, *state, cfg, invd=invd.double(), z=z)
    with pytest.raises(ValueError, match="shape"):
        kern.cg_loop((data[0][:, :-1], None), x, *state, cfg, invd=invd, z=z)
    with pytest.raises(TypeError, match="0-d float32"):
        kern.cg_loop(data, x, state[0], 1.0, state[2], state[3], cfg, invd=invd, z=z)
    with pytest.raises(ValueError, match="no kernel for device"):
        kern.cg_loop(data, x.cpu(), *state, cfg, invd=invd, z=z)
    with pytest.raises(ValueError, match="is on"):
        kern.bicgstab_gen_loop(data, x, state[0], state[0].cpu(), *state[1:], cfg, invd)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOBiCGStab"])
@pytest.mark.parametrize("fmt", ["Ell", "Hybrid"])
def test_foam_solve_on_ell_and_hybrid_is_one_loop_launch(dev, fmt, solver):
    """GKOCG and GKOBiCGStab `none`/`BJ` on an explicit Ell or Hybrid: one
    launch of the loop kernel's Ell variant per solve, the SpMV 11 times
    (set-up 2, residual-eval timing 9), no twin; iterations ±1 of the same
    solve over the plain twins on the card, the true residual within 10 ×
    the tolerance."""
    from ogl_tpu_torch.solve.cg import cg

    m, perm = testing.knn_ldu(20000)
    m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    loop = {"GKOCG": "ell_cg_loop", "GKOBiCGStab": "ell_bicgstab_gen_loop"}[solver]
    for pc in ("none", {"preconditioner": "BJ"}):
        registry.global_registry.clear()
        ctl = {"solver": solver, "tolerance": 1e-6, "relTol": 0, "matrixFormat": fmt,
               "preconditioner": pc, "executor": "cuda"}
        kernels.reset_launches()
        x, perf = foam.solve("p", m, b, ctl)
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {loop: 1,
                                                                    GATHER_LAUNCH[fmt]: 11}
        slv = registry.global_registry.get("p_solver")
        mat, bb = slv.matrix, torch.tensor(b, device=dev)
        invd = slv._precond_op.state if pc != "none" else None
        twin = {"GKOCG": cg, "GKOBiCGStab": bicgstab}[solver](
            single_device_ops(lambda v: spmv.spmv(mat, v), m.n,
                              precond=None if invd is None else (lambda r: invd * r)),
            bb, torch.zeros_like(bb), stopping.StoppingParams.of(slv.cfg.stopping))
        assert perf.converged and abs(perf.n_iterations - twin.iters) <= 1
        ops64 = single_device_ops(lambda v: spmv.spmv(formats.cast_values(mat, torch.float64),
                                                      v), m.n)
        b64 = bb.double()
        nf = stopping.initial_norm_factor(ops64, b64, torch.zeros_like(b64), b64)
        assert float((b64 - ops64.matvec(x.double())).abs().sum() / nf) <= 10 * 1e-6


# ---- slice 16: the CSR and Sell bodies and the loops on Coo, Csr and Sell ---


@pytest.mark.parametrize("kind", ["random", "long", "knn", "knn n%32=3"])
def test_csr_spmv_one_lane_body_matches_the_twin(dev, kind):
    """At one lane per row (each lane summing its row, four entries' loads
    in flight: rows shorter than four, long rows, the dense row of 'random')
    the kernel gives the twin's bits on CPU copies; a G > 1 graph ('long' at
    its own group) too."""
    from ogl_tpu_torch.kernels import gather_spmv

    coo = (_knn_coo(20000 if kind == "knn" else 20003) if kind.startswith("knn")
           else formats.coo_from_dense(_gather_dense(kind)))
    m = formats.coo_to_csr(coo, device=dev)
    x = _vec(m.shape[0], 3, dev)
    want = gather_spmv.spmv_csr(_to_cpu(m), x.cpu(), 1)
    kernels.reset_launches()
    y = gather_spmv.CsrSpmv(m, 1)(x)
    torch.cuda.synchronize()
    assert kernels.launches["csr_spmv"] == 1 and torch.equal(y.cpu(), want)
    if kind == "long":
        g = gather_spmv.csr_group(m.shape[0], m.nnz)
        assert g > 1
        y = gather_spmv.CsrSpmv(m)(x)
        assert torch.equal(y.cpu(), gather_spmv.spmv_csr(_to_cpu(m), x.cpu(), g))


@pytest.mark.parametrize("c", [8, 4, 1])
@pytest.mark.parametrize("kind", ["widths", "knn"])
def test_sell_spmv_stops_each_slice_at_its_width(dev, kind, c):
    """Slices of different widths in rounded buckets: the kernel reads each
    slice up to its longest row, bit-equal to its twin on CPU copies; a
    slice width above its bucket's is refused."""
    import dataclasses

    coo = _knn_coo(20003) if kind == "knn" else formats.coo_from_dense(_gather_dense(kind))
    m = formats.coo_to_sell(coo, c, device=dev)
    _gather_check("Sell", m, dev)
    bad = dataclasses.replace(m, slice_widths=m.slice_widths + 64)
    with pytest.raises(ValueError, match="slice width"):
        spmv.matvec(bad)


# the loops on Coo, Csr and Sell: the kNN-6 mesh at 20,000 cells (row
# quads) and 20,003 (a last warp of 3 rows, no row quads)
GATHER_LOOP_CASES = {"Coo": ("Coo", 20000), "Csr n%32=3": ("Csr", 20003),
                     "Sell": ("Sell", 20000), "Sell n%32=3": ("Sell", 20003)}


def _gather_loop_setup(case, pc, dev):
    """(plan, data, matrix, b, invd) of a GATHER_LOOP_CASES case."""
    from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels

    fmt, n = GATHER_LOOP_CASES[case]
    coo = _knn_coo(n)
    mat = _gather_mat(fmt, coo, dev)
    kern = (SellCgKernels if fmt == "Sell" else CsrCgKernels).for_matrix(mat)
    diag = np.zeros(n, np.float32)
    on = coo.rows == coo.cols
    diag[coo.rows[on]] = coo.vals[on]
    invd = torch.tensor(1.0 / diag, device=dev) if pc == "BJ" else None
    return kern, kern.pack_values(mat), mat, _vec(n, 11, dev), invd


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("case", list(GATHER_LOOP_CASES))
def test_gather_cg_loop_matches_plain(dev, case, pc):
    """The CG loop kernel's Csr and Sell variants against cg_loop_plain over
    the format twin's K1, pinned and free-running (_check_loop): one loop
    launch per solve, the SpMV twice for the set-up."""
    from ogl_tpu_torch.kernels.gather_loop import gather_k1_plain

    kern, data, mat, b, invd = _gather_loop_setup(case, pc, dev)
    mat64 = formats.cast_values(mat, torch.float64)
    _check_loop(kern, data, b, invd, functools.partial(gather_k1_plain, mat),
                GATHER_LAUNCH[GATHER_LOOP_CASES[case][0]], lambda v: spmv.spmv(mat64, v),
                loop_counter=f"{kern.NAME}_cg_loop")


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("case", list(GATHER_LOOP_CASES))
def test_gather_bicgstab_gen_loop_matches_plain(dev, case, pc):
    """The general-BiCGStab loop kernel's Csr and Sell variants against the
    twin on the card pinned at 10 iterations (x and the normalised residual
    rtol 1e-4): three launches repeat their count and iterate exactly, each
    one loop launch and two SpMVs (the set-up's)."""
    kern, data, mat, b, invd = _gather_loop_setup(case, pc, dev)
    name = GATHER_LAUNCH[GATHER_LOOP_CASES[case][0]]
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    twin = _gen_solve(kern, data, mat, b, invd, pinned, loop=False)
    runs = []
    for _ in range(3):
        kernels.reset_launches()
        runs.append(_gen_solve(kern, data, mat, b, invd, pinned))
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {
            f"{kern.NAME}_bicgstab_gen_loop": 1, name: 2}
    res = runs[0]
    assert all(r.iters == res.iters and torch.equal(r.x, res.x) for r in runs[1:])
    assert res.iters == twin.iters == 10 and not bool(res.converged)
    _close(res.x, twin.x, rtol=1e-4)
    torch.testing.assert_close(res.final_res_norm, twin.final_res_norm.cpu(), rtol=1e-4,
                               atol=1e-6 * float(res.init_res_norm))


@pytest.mark.parametrize("fmt", ["Csr", "Sell"])
def test_gather_loops_refuse_a_grid_too_large_and_bad_operands(dev, fmt):
    """As the Ell loops' test: on the 64×64×48 Poisson grid four times the
    co-resident grid is refused by the cooperative launch (the wrappers
    raise, count nothing, leave no error behind); a wrong operand raises
    before any launch."""
    from ogl_tpu_torch.kernels.fused import LOOP_JACOBI
    from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels

    coo = ldu.ldu_to_coo_host(testing.poisson_ldu((64, 64, 48)), dtype=np.float32)
    mat = _gather_mat(fmt, coo, dev)
    kern = (SellCgKernels if fmt == "Sell" else CsrCgKernels).for_matrix(mat)
    data = kern.pack_values(mat)
    b, invd = _vec(kern.n, 11, dev), torch.full((kern.n,), 1.0 / 6.0, device=dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)

    def run_cg():
        (x, *state), z = _loop_state(kern, data, b, invd)
        return kern.cg_loop(data, x, *state, cfg, invd=invd, z=z)[0]

    def run_gen():
        return _gen_solve(kern, data, mat, b, invd, cfg).iters

    v = kern.LOOP | LOOP_JACOBI
    for cache, what, run in ((kern._loop_blocks, f"{kern.NAME}_cg_loop", run_cg),
                             (kern._gen_loop_blocks, f"{kern.NAME}_bicgstab_gen_loop", run_gen)):
        assert run() == 5
        co_resident = cache[v]
        assert 0 < co_resident < -(-kern.n // 512)
        cache[v] = 4 * co_resident
        kernels.reset_launches()
        with pytest.raises(RuntimeError, match=f"{what}: CUDA error"):
            run()
        assert kernels.launches[what] == 0
        torch.cuda.synchronize()
        cache[v] = co_resident
        assert run() == 5
    (x, *state), z = _loop_state(kern, data, b, invd)
    with pytest.raises(TypeError, match="float32"):
        kern.cg_loop(data, x, *state, cfg, invd=invd.double(), z=z)
    with pytest.raises(ValueError, match="shape"):
        kern.cg_loop((data[0][:-1],), x, *state, cfg, invd=invd, z=z)
    with pytest.raises(ValueError, match="no kernel for device"):
        kern.cg_loop(data, x.cpu(), *state, cfg, invd=invd, z=z)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOBiCGStab"])
@pytest.mark.parametrize("fmt", ["Coo", "Csr", "Sell"])
def test_foam_solve_on_coo_csr_and_sell_is_one_loop_launch(dev, fmt, solver):
    """GKOCG and GKOBiCGStab `none`/`BJ` on an explicit Coo, Csr or Sell: one
    launch of the loop kernel's variant of the format per solve, the SpMV 11
    times (set-up 2, residual-eval timing 9), no twin; iterations ±1 of the
    same solve over the plain twins on the card."""
    from ogl_tpu_torch.solve.cg import cg

    m, perm = testing.knn_ldu(20000)
    m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    name = "sell" if fmt == "Sell" else "csr"
    loop = {"GKOCG": f"{name}_cg_loop", "GKOBiCGStab": f"{name}_bicgstab_gen_loop"}[solver]
    for pc in ("none", {"preconditioner": "BJ"}):
        registry.global_registry.clear()
        ctl = {"solver": solver, "tolerance": 1e-6, "relTol": 0, "matrixFormat": fmt,
               "preconditioner": pc, "executor": "cuda"}
        kernels.reset_launches()
        x, perf = foam.solve("p", m, b, ctl)
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {loop: 1,
                                                                    GATHER_LAUNCH[fmt]: 11}
        slv = registry.global_registry.get("p_solver")
        mat, bb = slv.matrix, torch.tensor(b, device=dev)
        invd = slv._precond_op.state if pc != "none" else None
        twin = {"GKOCG": cg, "GKOBiCGStab": bicgstab}[solver](
            single_device_ops(lambda v: spmv.spmv(mat, v), m.n,
                              precond=None if invd is None else (lambda r: invd * r)),
            bb, torch.zeros_like(bb), stopping.StoppingParams.of(slv.cfg.stopping))
        assert perf.converged and abs(perf.n_iterations - twin.iters) <= 1


# ---- slice 17: blocked Jacobi, ISAI/GISAI and GKOGMRES ------------------------


@pytest.mark.parametrize("n", [1000, 70001])
@pytest.mark.parametrize("bs", [2, 3, 4, 5, 8, 16, 32])
def test_block_jacobi_kernel_bit_equal_to_twin(dev, bs, n):
    from ogl_tpu_torch.kernels.block_jacobi import block_jacobi, block_jacobi_plain

    nb = -(-n // bs)
    g = torch.Generator(device="cpu").manual_seed(bs)
    inv_t = torch.randn((nb, bs, bs), generator=g).to(dev)
    r = _vec(n, bs + 1, dev)
    kernels.reset_launches()
    y = block_jacobi(inv_t, r)
    torch.cuda.synchronize()
    assert kernels.launches["block_jacobi"] == 1
    assert torch.equal(y, block_jacobi_plain(inv_t, r))


def _gmres_basis(j, n, dtype, dev, seed):
    from ogl_tpu_torch.kernels.gmres import new_basis

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, j + 1), generator=g, dtype=torch.float64))
    V = new_basis(j + 1, n, dtype, dev)
    V[:j + 1, :n] = q.T.to(torch.float32).to(dev).to(dtype)
    w = (q @ torch.randn(j + 1, generator=g, dtype=torch.float64)
         + torch.randn(n, generator=g, dtype=torch.float64)).float().to(dev)
    return V, w


@pytest.mark.parametrize("n", [4097, 262_144, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("j", [0, 7, 8, 9, 50, 99])
def test_gmres_arnoldi_kernel_matches_twin(dev, j, dtype, n):
    """h within 1e-4 of ‖w‖, v_{j+1} within 1e-5 in float32 and the stored
    bfloat16 row within one bfloat16 ulp: the dots are summed per CUDA block,
    then in block order."""
    from ogl_tpu_torch.kernels.gmres import gmres_arnoldi, gmres_arnoldi_plain

    V, w = _gmres_basis(j, n, dtype, dev, seed=j)
    V2 = V.clone()
    h, h2 = torch.zeros(j + 2, device=dev), torch.zeros(j + 2, device=dev)
    want = gmres_arnoldi_plain(V2, w.clone(), j, h2)
    kernels.reset_launches()
    got = gmres_arnoldi(V, w.clone(), j, h)
    torch.cuda.synchronize()
    assert kernels.launches["gmres_arnoldi"] == 1
    scale = float(torch.linalg.vector_norm(w))
    torch.testing.assert_close(h, h2, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    _check_stored_row(V[j + 1, :n], V2[j + 1, :n], got, want)
    assert torch.equal(V[:j + 1], V2[:j + 1])  # the live rows are read only


def _check_stored_row(row, row2, got, want):
    """The stored row against the twin's: float32 within 1e-5; bfloat16 the
    kernel's own v_{j+1} rounded to nearest even, bit for bit, and within one
    bfloat16 ulp of the twin's row, with a floor of 1e-6 of max |v_{j+1}|:
    an entry near 0 is the difference of terms of the vector's own scale, so
    its float32 value carries their rounding (a few 1e-9 at 1M entries) in
    the kernel and in the twin alike."""
    if row.dtype == torch.float32:
        torch.testing.assert_close(row, row2, rtol=0, atol=1e-5)
        return
    assert torch.equal(row, got.to(torch.bfloat16))
    row, row2 = row.float(), row2.float()
    floor = 1e-6 * float(want.abs().max())
    assert bool(((row - row2).abs() <= 2.0 ** -7 * row2.abs() + floor).all())


@pytest.mark.parametrize("n,dtype", [(1 << 20, torch.float32), (1 << 20, torch.bfloat16),
                                     ((1 << 20) + 3, torch.float32), (1 << 23, torch.bfloat16)],
                         ids=str)
def test_gmres_arnoldi_two_steps_match_twin(dev, n, dtype):
    """Steps j and j + 1 on the same V and h, as GMRES runs them: the second
    launch reads the row the first wrote, and no state of the first's shared
    slots reaches the second."""
    from ogl_tpu_torch.kernels.gmres import gmres_arnoldi, gmres_arnoldi_plain

    j = 16
    V, w = _gmres_basis(j, n, dtype, dev, seed=5)
    V2 = V.clone()
    h, h2 = torch.zeros(j + 3, device=dev), torch.zeros(j + 3, device=dev)
    g = torch.Generator(device="cpu").manual_seed(6)
    w1 = torch.randn(n, generator=g).to(dev)
    kernels.reset_launches()
    for step, ww in ((j, w), (j + 1, w1)):
        got = gmres_arnoldi(V, ww.clone(), step, h)
        want = gmres_arnoldi_plain(V2, ww.clone(), step, h2)
        torch.cuda.synchronize()
        scale = float(torch.linalg.vector_norm(ww))
        torch.testing.assert_close(h[:step + 2], h2[:step + 2], rtol=0, atol=1e-4 * scale)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        _check_stored_row(V[step + 1, :n], V2[step + 1, :n], got, want)
        V2[step + 1] = V[step + 1]  # the next step reads the kernel's row on both sides
    assert kernels.launches["gmres_arnoldi"] == 2


@pytest.mark.parametrize("n", [4097, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("j", [1, 7, 8, 50])
def test_gmres_combine_kernel_bit_equal_to_twin(dev, j, dtype, n):
    from ogl_tpu_torch.kernels.gmres import gmres_combine, gmres_combine_plain

    V, _ = _gmres_basis(j, n, dtype, dev, seed=j + 100)
    y = _vec(j, j, dev)
    kernels.reset_launches()
    got = gmres_combine(V, y, j, n)
    torch.cuda.synchronize()
    assert kernels.launches["gmres_combine"] == 1
    assert torch.equal(got, gmres_combine_plain(V, y, j, n))


def test_gmres_kernels_refuse_rows_shorter_than_n_rounded_up_to_8(dev):
    """A float32 basis whose row stride is a multiple of 4 but below n
    rounded up to 8: the last slice's bulk copies would read into the next
    row, so both kernels refuse it before any launch."""
    from ogl_tpu_torch.kernels.gmres import gmres_arnoldi, gmres_combine

    V = torch.zeros((16, 100), device=dev)  # 100 % 4 == 0, 100 < 104
    kernels.reset_launches()
    with pytest.raises(ValueError, match="at least 104 entries"):
        gmres_arnoldi(V, torch.zeros(100, device=dev), 0, torch.zeros(2, device=dev))
    with pytest.raises(ValueError, match="at least 104 entries"):
        gmres_combine(V, torch.zeros(2, device=dev), 2, 100)
    assert kernels.launches["gmres_arnoldi"] == kernels.launches["gmres_combine"] == 0


def test_gmres_kernels_refuse_bad_operands(dev):
    from ogl_tpu_torch.kernels.gmres import gmres_arnoldi, gmres_combine, new_basis

    V = new_basis(4, 100, torch.float32, dev)
    with pytest.raises(ValueError, match="rows"):
        gmres_arnoldi(V, torch.zeros(100, device=dev), 7, torch.zeros(9, device=dev))
    with pytest.raises(ValueError, match="multiple of 4"):
        gmres_combine(V[:, :98], torch.zeros(2, device=dev), 2, 98)
    with pytest.raises(ValueError, match="y must be .* on cuda"):  # a CPU y, a card V
        gmres_combine(V, torch.zeros(2), 2, 100)


def _true_residual64(m, b, x):
    import scipy.sparse as sp

    c = ldu.ldu_to_coo_host(m, dtype=np.float64)
    a = sp.csr_matrix((c.vals, (c.rows, c.cols)), shape=c.shape)
    return np.abs(b - a @ x.cpu().numpy().astype(np.float64)).sum() / np.abs(b).sum()


@pytest.mark.parametrize("basis", ["default", "bfloat16"])
@pytest.mark.parametrize("pc,fmt", [("GISAI", "Ell"), ("ISAI", "Dia"),
                                    ({"preconditioner": "BJ", "maxBlockSize": 4}, "Csr")],
                         ids=str)
def test_gkogmres_solve_on_the_card(dev, pc, fmt, basis, monkeypatch):
    """One Arnoldi launch per Arnoldi step, the combine kernel at the fired
    checks, no torch GEMV on the path; iterations ±1 of the same solve on
    the CPU over the twins (the bfloat16 basis: its true residual)."""
    m = testing.poisson_ldu((32, 32, 16)) if fmt == "Dia" else testing.knn_ldu(20000)[0]
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOGMRES", "tolerance": 1e-6, "relTol": 0, "matrixFormat": fmt,
           "preconditioner": pc, "basisPrecision": basis, "adaptMinIter": False}

    def refuse(*a, **kw):
        raise AssertionError("a torch GEMV ran on the GMRES path")

    kernels.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(torch, "mv", refuse)
        mp.setattr(torch, "addmv", refuse)
        x, perf = foam.solve("p", m, b, {**ctl, "executor": "cuda"})
        torch.cuda.synchronize()
    assert kernels.launches["gmres_arnoldi"] == perf.n_iterations
    assert kernels.launches["gmres_combine"] >= 1
    if isinstance(pc, dict):  # M⁻¹ once per Arnoldi step and once per recombination
        assert kernels.launches["block_jacobi"] == (perf.n_iterations
                                                    + kernels.launches["gmres_combine"])
    registry.global_registry.clear()
    _, perf_cpu = foam.solve("p", m, b, {**ctl, "executor": "cpu"})
    assert perf.converged and perf_cpu.converged
    assert _true_residual64(m, b, x) < 10 * 1e-6
    if basis == "default":
        assert abs(perf.n_iterations - perf_cpu.n_iterations) <= 1


@pytest.mark.parametrize("fmt", ["Dia", "Csr"])
def test_blocked_bj_bicgstab_on_the_card(dev, fmt):
    """GKOBiCGStab + BJ maxBlockSize 4: one launch of the general-BiCGStab
    loop kernel's block-Jacobi variant of the format, the SpMV 2 + 9 times
    (the set-up, the residual-eval timing), no block-Jacobi launch; ±1 of
    the CPU solve."""
    m = testing.convection_diffusion_ldu((32, 32, 16))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOBiCGStab", "tolerance": 1e-6, "relTol": 0, "matrixFormat": fmt,
           "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 4},
           "adaptMinIter": False}
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, {**ctl, "executor": "cuda"})
    torch.cuda.synchronize()
    loop, mv = {"Dia": ("bicgstab_gen_loop", "dia_spmv"),
                "Csr": ("csr_bicgstab_gen_loop", "csr_spmv")}[fmt]
    assert {k: v for k, v in kernels.launches.items() if v} == {loop: 1, mv: 11}
    registry.global_registry.clear()
    _, perf_cpu = foam.solve("p", m, b, {**ctl, "executor": "cpu"})
    assert perf.converged and abs(perf.n_iterations - perf_cpu.n_iterations) <= 1


# ---- slice 19: block Jacobi as phases of the general-BiCGStab loop ----------

# (format, system, size): convection-diffusion grids (2,048 rows, and 1,105:
# n % 4 = 1, the rows branch, blocks of 4 and 32 ragged) and the kNN-6 mesh
# at 20,000 and 20,003 cells (a last warp of 3 rows), each format's loop plan
BJ_LOOP_CASES = {"Dia": ("Dia", "cd", (16, 16, 8)), "Dia n%4=1": ("Dia", "cd", (17, 13, 5)),
                 "Gdia": ("Gdia", "cd", (16, 16, 8)), "Xell": ("Xell", "knn", 20000),
                 "Ell n%32=3": ("Ell", "knn", 20003), "Hybrid": ("Hybrid", "knn", 20000),
                 "Coo": ("Coo", "knn", 20000), "Csr n%32=3": ("Csr", "knn", 20003),
                 "Sell": ("Sell", "knn", 20000)}
BJ_LOOP_LAUNCH = {"Dia": ("bicgstab_gen_loop", "dia_spmv"),
                  "Gdia": ("bicgstab_gen_loop", "gdia_spmv"),
                  "Xell": ("bicgstab_gen_loop", "xell_spmv"),
                  **{f: (f"{'ell' if f in ('Ell', 'Hybrid') else 'sell' if f == 'Sell' else 'csr'}"
                         "_bicgstab_gen_loop", GATHER_LAUNCH[f])
                     for f in ("Ell", "Hybrid", "Coo", "Csr", "Sell")}}


def _bj_loop_setup(case, bs, dev):
    """(plan, data, matrix, b, inv_t): BJ_LOOP_CASES[case] in its format on
    the card, with the transposed inverses of its blocks of bs rows."""
    from ogl_tpu_torch.kernels.ell import EllCgKernels
    from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels
    from ogl_tpu_torch.precond.jacobi import block_inverses

    fmt, system, size = BJ_LOOP_CASES[case]
    if system == "knn":
        coo = _knn_coo(size)
    else:
        coo = ldu.ldu_to_coo_host(testing.convection_diffusion_ldu(size), dtype=np.float32)
    n = coo.shape[0]
    if fmt == "Gdia":  # renumbered inside each run of 128 rows
        inv = np.empty(n, np.int64)
        inv[_shuffled(n)] = np.arange(n)
        rows, cols = inv[np.asarray(coo.rows)], inv[np.asarray(coo.cols)]
        order = np.lexsort((cols, rows))
        coo = formats.Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                          vals=np.asarray(coo.vals)[order], shape=coo.shape)
        mat = gdia.gdia_from_coo(coo, device=dev)
        kern = GdiaCgKernels(n, mat.plane_offsets, dev)
    elif fmt == "Dia":
        mat = formats.coo_to_dia(coo, dev)
        kern = CgKernels(n, mat.offsets, dev)
    elif fmt == "Xell":
        mat = xell.xell_from_coo(coo, device=dev)
        kern = xell.XellCgKernels.for_matrix(mat)
    else:
        mat = _gather_mat(fmt, coo, dev)
        kern = {"Ell": EllCgKernels, "Hybrid": EllCgKernels, "Sell": SellCgKernels}.get(
            fmt, CsrCgKernels).for_matrix(mat)
    inv_t = torch.tensor(block_inverses(coo, bs), device=dev)
    return kern, kern.pack_values(mat), mat, _vec(n, 11, dev), inv_t


def _bj_solve(kern, data, mat, b, inv_t, cfg, loop=True):
    """solve/bicgstab.py with block Jacobi from a zero guess: the plan's loop
    kernel handed inv_t, or (loop=False) the host loop over the plain SpMV
    and block_jacobi_plain on the card — the twin's operations in order."""
    from ogl_tpu_torch.kernels.block_jacobi import block_jacobi_plain

    mv = spmv.matvec(mat) if loop else (lambda v: spmv.spmv(mat, v))
    ops = single_device_ops(mv, kern.n, precond=functools.partial(block_jacobi_plain, inv_t))
    return bicgstab(ops, b, torch.zeros_like(b), cfg,
                    *((kern, data, None, inv_t) if loop else ()))


@pytest.mark.parametrize("bs", [2, 4, 32])
@pytest.mark.parametrize("case", list(BJ_LOOP_CASES))
def test_bicgstab_gen_loop_block_jacobi_matches_plain(dev, case, bs):
    """The loop kernel's block-Jacobi variant of each format against the host
    loop over the twins on the card, pinned at 10 iterations (x and the
    normalised residual rtol 1e-4) and, on convection-diffusion,
    free-running to LOOP_TOL (±1 iteration, the float64 residual within 10
    x LOOP_TOL): three launches repeat their count and iterate exactly, each
    one loop launch and the format's SpMV twice (the set-up's), no
    block-Jacobi launch."""
    kern, data, mat, b, inv_t = _bj_loop_setup(case, bs, dev)
    loop, mv = BJ_LOOP_LAUNCH[BJ_LOOP_CASES[case][0]]
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0, max_iter=2000,
                                   frequency=1)
    for cfg in (pinned, free) if BJ_LOOP_CASES[case][1] == "cd" else (pinned,):
        twin = _bj_solve(kern, data, mat, b, inv_t, cfg, loop=False)
        runs = []
        for _ in range(3):
            kernels.reset_launches()
            runs.append(_bj_solve(kern, data, mat, b, inv_t, cfg))
            torch.cuda.synchronize()
            assert {k: v for k, v in kernels.launches.items() if v} == {loop: 1, mv: 2}
        res = runs[0]
        assert all(r.iters == res.iters and torch.equal(r.x, res.x) for r in runs[1:])
        if cfg is pinned:
            assert res.iters == twin.iters == 10 and not bool(res.converged)
            _close(res.x, twin.x, rtol=1e-4)
            torch.testing.assert_close(res.final_res_norm, twin.final_res_norm.cpu(),
                                       rtol=1e-4, atol=1e-6 * float(res.init_res_norm))
        else:
            assert bool(res.converged) and bool(twin.converged)
            assert abs(res.iters - twin.iters) <= 1 and float(res.final_res_norm) < LOOP_TOL
            mat64 = formats.cast_values(mat, torch.float64)
            x64 = res.x.double()
            assert float((b.double() - spmv.spmv(mat64, x64)).abs().sum()
                         / b.double().abs().sum()) <= 10 * LOOP_TOL


def test_bicgstab_gen_loop_block_jacobi_at_1m(dev):
    """The Dia block-Jacobi variant on the 1M convection-diffusion grid (the
    main path's size; row quads, a grid far below one tile per row) against
    the host loop over the twins, pinned at 10 iterations."""
    kern, data, mat, b, _ = _gen_system("convection_diffusion", (128, 128, 64), "Dia", dev)
    from ogl_tpu_torch.precond.jacobi import block_inverses

    coo = ldu.ldu_to_coo_host(testing.convection_diffusion_ldu((128, 128, 64)),
                              dtype=np.float32)
    inv_t = torch.tensor(block_inverses(coo, 4), device=dev)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10,
                                     frequency=1)
    twin = _bj_solve(kern, data, mat, b, inv_t, pinned, loop=False)
    kernels.reset_launches()
    res = _bj_solve(kern, data, mat, b, inv_t, pinned)
    torch.cuda.synchronize()
    assert kernels.launches["bicgstab_gen_loop"] == 1 and kernels.launches["block_jacobi"] == 0
    assert res.iters == 10
    _close(res.x, twin.x, rtol=1e-4)


def test_bicgstab_gen_loop_block_jacobi_refused_launch_raises(dev):
    """Four times the co-resident grid of the block-Jacobi variant is refused
    by the cooperative launch: the wrapper raises, counts nothing, leaves no
    error behind, and the next launch is unaffected; inconsistent inverses
    raise before any launch."""
    from ogl_tpu_torch.kernels.fused import LOOP_BLOCK_JACOBI
    from ogl_tpu_torch.precond.jacobi import block_inverses

    kern, data, mat, b, invd = _gen_system("poisson", (128, 128, 64), "Dia", dev)
    coo = ldu.ldu_to_coo_host(testing.poisson_ldu((128, 128, 64)), dtype=np.float32)
    inv_t = torch.tensor(block_inverses(coo, 4), device=dev)
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=5,
                                  frequency=1)
    assert _bj_solve(kern, data, mat, b, inv_t, cfg).iters == 5
    co_resident = kern._gen_loop_blocks[LOOP_BLOCK_JACOBI]
    assert 0 < co_resident < -(-kern.n // 512)
    kern._gen_loop_blocks[LOOP_BLOCK_JACOBI] = 4 * co_resident
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="bicgstab_gen_loop: CUDA error"):
        _bj_solve(kern, data, mat, b, inv_t, cfg)
    assert kernels.launches["bicgstab_gen_loop"] == 0
    torch.cuda.synchronize()
    kern._gen_loop_blocks[LOOP_BLOCK_JACOBI] = co_resident
    assert _bj_solve(kern, data, mat, b, inv_t, cfg).iters == 5
    x, r = torch.zeros_like(b), b.clone()
    one = torch.ones((), device=dev)
    with pytest.raises(ValueError, match="exclude each other"):
        kern.bicgstab_gen_loop(data, x, r, r.clone(), one, one, one, cfg, invd=invd, inv_t=inv_t)
    with pytest.raises(ValueError, match="blocks of 4"):
        kern.bicgstab_gen_loop(data, x, r, r.clone(), one, one, one, cfg,
                               inv_t=inv_t[1:].contiguous())
    with pytest.raises(ValueError, match="inv_t on cpu"):
        kern.bicgstab_gen_loop(data, x, r, r.clone(), one, one, one, cfg, inv_t=inv_t.cpu())


@pytest.mark.parametrize("n", [4097, (1 << 20) + 3, 8_388_608 + 5])
@pytest.mark.parametrize("bs", [3, 4, 7, 32])
def test_block_jacobi_kernel_bit_equal_at_ragged_n(dev, bs, n):
    """The standalone apply over the body of block_jacobi.cuh: bit-equal to
    its twin where n is a multiple of neither bs nor the tile."""
    from ogl_tpu_torch.kernels.block_jacobi import block_jacobi, block_jacobi_plain

    g = torch.Generator(device=dev).manual_seed(bs)
    inv_t = torch.randn((-(-n // bs), bs, bs), device=dev, generator=g)
    r = torch.randn(n, device=dev, generator=g)
    kernels.reset_launches()
    y = block_jacobi(inv_t, r)
    torch.cuda.synchronize()
    assert kernels.launches["block_jacobi"] == 1
    assert torch.equal(y, block_jacobi_plain(inv_t, r))


@pytest.mark.parametrize("n", [5003, (1 << 20) + 3, 8_388_608])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("j", [1, 9, 100])
def test_gmres_combine_bit_equal_at_ragged_n(dev, j, dtype, n):
    """The combine over the body of gmres_combine.cuh (rows in pairs, a
    column group of 4 entries per thread): bit-equal to its twin at n ragged
    against the group, NaN in every row's padding, nothing stored past n."""
    from ogl_tpu_torch.kernels.gmres import gmres_combine, gmres_combine_plain, new_basis

    g = torch.Generator(device=dev).manual_seed(j)
    V = new_basis(j, n, dtype, dev)
    V[:, n:] = float("nan")
    V[:j, :n] = torch.randn((j, n), device=dev, generator=g).to(dtype)
    y = torch.randn(j, device=dev, generator=g)
    kernels.reset_launches()
    got = gmres_combine(V, y, j, n)
    torch.cuda.synchronize()
    assert kernels.launches["gmres_combine"] == 1
    assert torch.equal(got, gmres_combine_plain(V, y, j, n))


# ---- slice 20: the ILU family's triangular kernels --------------------------------


def _tri_state(name, system, device, sweeps=8, exact=False):
    """The apply state of an ILU-family name on `system` on `device`."""
    from ogl_tpu_torch.config import PrecondConfig
    from ogl_tpu_torch.precond import build

    m = {"poisson": lambda: testing.poisson_ldu((32, 16, 8)),
         "poisson1m": lambda: testing.poisson_ldu((128, 128, 64)),
         "poisson2m": lambda: testing.poisson_ldu((256, 128, 64)),
         "cd": lambda: testing.convection_diffusion_ldu((32, 16, 8)),
         "knn": lambda: testing.knn_ldu(20000)[0],
         "knn262k": lambda: _knn_rcm(1 << 18)}[system]()
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    cfg = PrecondConfig(name=name, tri_solve_sweeps=sweeps,
                        tri_solve="exact" if exact else "approx")
    return build(cfg, coo, device).state


def _knn_rcm(n):
    """The kNN-6 mesh of n cells in its RCM numbering, as phase 12 solves it."""
    m, perm = testing.knn_ldu(n)
    return testing.renumber_ldu(m, np.argsort(perm))


TRI_CASES = [("IC", "poisson"), ("ILU", "cd"), ("ILUT", "cd"), ("ICT", "knn"), ("ILU", "knn")]


@pytest.mark.parametrize("sweeps", [0, 1, 3, 8])
@pytest.mark.parametrize("name,system", TRI_CASES)
def test_tri_sweep_kernel_bit_equal_to_twin(dev, name, system, sweeps):
    from ogl_tpu_torch.kernels import tri_solve

    st = _tri_state(name, system, dev, sweeps)
    r = _vec(st.lower.n, sweeps, dev)
    kernels.reset_launches()
    got = tri_solve.tri_sweep(st.lower, st.upper, r)
    torch.cuda.synchronize()
    assert kernels.launches["tri_sweep"] == 1
    assert torch.equal(got, tri_solve.tri_sweep_plain(st.lower, st.upper, r))


@pytest.mark.parametrize("name,system", TRI_CASES + [("IC", "poisson1m"), ("ILU", "poisson1m")])
def test_tri_levels_kernel_bit_equal_to_twin_and_to_the_sweeps_at_depth(dev, name, system):
    from ogl_tpu_torch.kernels import tri_solve

    st = _tri_state(name, system, dev, exact=True)
    lo, up = st.lower, st.upper
    r = _vec(lo.n, 3, dev)
    kernels.reset_launches()
    got = tri_solve.tri_levels(lo, up, r)
    torch.cuda.synchronize()
    assert kernels.launches["tri_levels"] == 1
    assert torch.equal(got, tri_solve.tri_levels_plain(lo, up, r))
    deep = _at_depth(lo), _at_depth(up)
    assert torch.equal(got, tri_solve.tri_sweep(*deep, r))
    assert kernels.launches["tri_sweep"] == 1


def _at_depth(t):
    """The factor with its sweep count raised to its dependency depth."""
    import dataclasses

    return dataclasses.replace(t, sweeps=t.depth, _tables={})


def test_tri_wrappers_never_take_a_twin_on_the_card(dev, monkeypatch):
    from ogl_tpu_torch.kernels import tri_solve
    from ogl_tpu_torch.precond import ilu

    st = _tri_state("IC", "poisson", dev)
    r = _vec(st.lower.n, 1, dev)
    want = tri_solve.tri_sweep_plain(st.lower, st.upper, r)
    want_exact = tri_solve.tri_levels_plain(st.lower, st.upper, r)

    def refuse(*a, **kw):
        raise AssertionError("a twin ran on CUDA tensors")

    for fn in ("tri_sweep_plain", "tri_levels_plain", "_sweeps_plain", "_levels_plain"):
        monkeypatch.setattr(tri_solve, fn, refuse)
    kernels.reset_launches()
    assert torch.equal(ilu.apply(st, r), want)
    st.exact = True
    assert torch.equal(ilu.apply(st, r), want_exact)
    torch.cuda.synchronize()
    assert kernels.launches["tri_sweep"] == 1 and kernels.launches["tri_levels"] == 1
    assert st.applies == 2


def test_tri_refused_launch_raises(dev, monkeypatch):
    """A grid above the co-resident blocks is refused by the cooperative
    launch: the wrapper raises, counts nothing, and the next launch runs."""
    from ogl_tpu_torch.kernels import tri_solve

    st = _tri_state("ILU", "cd", dev)
    r = _vec(st.lower.n, 2, dev)
    sweep_co = tri_solve.sweep_grid(dev.index or 0)[0]
    block, threads, _, _ = tri_solve.level_launch(st.lower, st.upper)
    level_co = tri_solve.level_grid(dev.index or 0, threads, block)
    kernels.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(tri_solve, "sweep_blocks", lambda n, d: 4 * sweep_co)
        mp.setattr(tri_solve, "level_blocks", lambda cfg, d: 4 * level_co)
        with pytest.raises(RuntimeError, match="tri_sweep: CUDA error"):
            tri_solve.tri_sweep(st.lower, st.upper, r)
        with pytest.raises(RuntimeError, match="tri_levels: CUDA error"):
            tri_solve.tri_levels(st.lower, st.upper, r)
    assert kernels.launches["tri_sweep"] == 0 and kernels.launches["tri_levels"] == 0
    torch.cuda.synchronize()
    assert torch.equal(tri_solve.tri_sweep(st.lower, st.upper, r),
                       tri_solve.tri_sweep_plain(st.lower, st.upper, r))
    with pytest.raises(ValueError, match="contiguous"):
        tri_solve.tri_sweep(st.lower, st.upper, r.double())


# slice 21: both kernels redesigned (kernel 1 over factors held in shared
# memory, kernel 2 on ready words with no grid barrier)


@pytest.mark.parametrize("exact", [False, True], ids=["sweeps", "exact"])
@pytest.mark.parametrize("name,system", [("ILUT", "knn262k"), ("ICT", "knn262k"),
                                         ("IC", "poisson2m")])
def test_tri_kernels_bit_equal_on_knn_threshold_factors_and_beyond_shared_memory(
        dev, name, system, exact):
    """The 262,144-cell kNN mesh's ILUT and ICT factors (1,699-3,010 levels
    deep), and an IC(0) factor of 2M rows, about twice what the card's shared
    memory holds: kernel 1 streams it, and, held as far as it fits, streams
    the rest of each CTA's rows in the same pass."""
    from ogl_tpu_torch.kernels import tri_solve

    st = _tri_state(name, system, dev, exact=exact)
    lo, up = st.lower, st.upper
    r = _vec(lo.n, 5, dev)
    kernels.reset_launches()
    if exact:
        got = tri_solve.tri_levels(lo, up, r)
        assert torch.equal(got, tri_solve.tri_levels_plain(lo, up, r))
        assert torch.equal(got, tri_solve.tri_sweep(_at_depth(lo), _at_depth(up), r))
    else:
        want = tri_solve.tri_sweep_plain(lo, up, r)
        assert torch.equal(tri_solve.tri_sweep(lo, up, r), want)
        if system == "poisson2m":
            blocks = tri_solve.sweep_blocks(lo.n, dev)
            cap = tri_solve.sweep_grid(dev.index or 0)[1]
            assert 4 * (lo.n + 1) + 8 * lo.mat.nnz > blocks * cap
            for share in (1.0, 0.0):  # every row streamed; held as far as it fits
                plan = tri_solve.sweep_plan(lo, blocks, cap, share)
                if share:
                    assert plan is None
                else:
                    bounds, held = (a.cpu() for a in plan)
                    assert bool((held > bounds[:-1]).all() and (held < bounds[1:]).all())
                assert torch.equal(tri_solve._launch_sweeps(lo, up, r, share), want)
    torch.cuda.synchronize()
    assert kernels.launches["tri_levels" if exact else "tri_sweep"] == (1 if exact or
                                                                       system != "poisson2m"
                                                                       else 3)


def _chain_state(n, device, seed=1):
    """Strict factors of n rows where every row depends on the one before
    (lower) or after (upper): depth n - 1 each, one row per level."""
    from ogl_tpu_torch.precond import ilu

    g = np.random.default_rng(seed)
    i = np.arange(1, n)
    lower = (i, i - 1, g.uniform(-0.9, 0.9, n - 1))
    upper = (i - 1, i, g.uniform(-0.9, 0.9, n - 1))
    return ilu.state_from_factors(lower, upper, g.uniform(1.0, 2.0, n), "lu", device,
                                  exact=True)


@pytest.mark.parametrize("n", [33, 4097])
def test_tri_kernels_on_a_chain_factor(dev, n):
    from ogl_tpu_torch.kernels import tri_solve

    st = _chain_state(n, dev)
    lo, up = st.lower, st.upper
    assert lo.depth == up.depth == n - 1
    r = _vec(n, 7, dev)
    got = tri_solve.tri_levels(lo, up, r)
    assert torch.equal(got, tri_solve.tri_levels_plain(lo, up, r))
    assert torch.equal(got, tri_solve.tri_sweep(_at_depth(lo), _at_depth(up), r))


def test_tri_levels_many_applies_past_an_epoch_wrap(dev, monkeypatch):
    """Applies in a row on one state, each on a new r: the epoch passes a
    small EPOCH_MAX twice, the ready words are zeroed and the epochs start
    again, and every apply stays bit-equal to the twin."""
    from ogl_tpu_torch.kernels import tri_solve

    monkeypatch.setattr(tri_solve, "EPOCH_MAX", 4)
    st = _tri_state("ILUT", "cd", dev, exact=True)
    lo, up = st.lower, st.upper
    lo.ready.epoch = up.ready.epoch = 2  # a start near the wrap
    seen = []
    for k in range(11):
        r = _vec(lo.n, 100 + k, dev)
        got = tri_solve.tri_levels(lo, up, r)
        seen.append(lo.ready.epoch)
        assert torch.equal(got, tri_solve.tri_levels_plain(lo, up, r)), k
    assert seen == [3, 4, 1, 2, 3, 4, 1, 2, 3, 4, 1]
    assert up.ready.epoch == lo.ready.epoch


def test_tri_levels_refuses_graph_capture_and_shared_words(dev):
    import dataclasses

    from ogl_tpu_torch.kernels import tri_solve

    st = _tri_state("IC", "poisson", dev, exact=True)
    r = _vec(st.lower.n, 1, dev)
    with pytest.raises(ValueError, match="share their ready words"):
        tri_solve.tri_levels(st.lower, dataclasses.replace(st.lower), r)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side), pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph, stream=side):
            tri_solve.tri_levels(st.lower, st.upper, r)
    torch.cuda.synchronize()
    assert torch.equal(tri_solve.tri_levels(st.lower, st.upper, r),
                       tri_solve.tri_levels_plain(st.lower, st.upper, r))


TRAP_SCRIPT = """
import numpy as np, torch, sys
sys.path.insert(0, {root!r})
from ogl_tpu_torch.kernels import tri_solve
from ogl_tpu_torch.precond import ilu
tri_solve.LEVEL_LIMIT_NS = 2 * 10**8
n = 16384  # more rows than threads: a waiting thread holds a later row
i = np.arange(1, n)
st = ilu.state_from_factors((i, i - 1, np.full(n - 1, 0.5)), (i - 1, i, np.full(n - 1, 0.5)),
                            np.ones(n), "lu", torch.device("cuda"), exact=True)
st.lower.order = torch.flip(st.lower.order, [0])  # every row before its source
out = tri_solve._launch_levels(st.lower, st.upper, torch.ones(n, device="cuda"),
                               (4, 32, 1, {sleep}))
torch.cuda.synchronize()
print("returned", float(out.sum()))
"""


@pytest.mark.parametrize("sleep", [0, 32])
def test_tri_levels_traps_on_a_row_before_its_source(dev, sleep):
    """A schedule that places rows before their sources cannot finish: the
    waits pass their bound, the kernel traps and the process sees a CUDA
    error at the synchronisation, in seconds, with no result."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    res = subprocess.run([sys.executable, "-c", TRAP_SCRIPT.format(root=root, sleep=sleep)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout
    assert "returned" not in res.stdout
    assert "CUDA" in res.stderr or "cuda" in res.stderr, res.stderr[-2000:]


ILU_SOLVES = {
    "GKOCG IC": ("GKOCG", "IC", "poisson"),
    "GKOCG ICT exact": ("GKOCG", {"preconditioner": "ICT", "triSolve": "exact"}, "poisson"),
    "GKOBiCGStab ILU": ("GKOBiCGStab", "ILU", "cd"),
    "GKOBiCGStab IRILU": ("GKOBiCGStab", "IRILU", "cd"),
    "GKOGMRES ILUT exact": ("GKOGMRES", {"preconditioner": "ILUT", "triSolve": "exact"}, "cd"),
}


@pytest.mark.parametrize("case", list(ILU_SOLVES))
def test_ilu_family_solves_on_the_card(dev, case):
    """foam.solve on the card: one tri_sweep (or, exact, tri_levels) launch
    per preconditioner apply and none of the other, ±1 iteration of the
    same solve on the CPU over the twins, the true residual in bounds."""
    solver, pc, system = ILU_SOLVES[case]
    m = (testing.poisson_ldu((32, 32, 16)) if system == "poisson"
         else testing.convection_diffusion_ldu((32, 32, 16)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": solver, "tolerance": 1e-6, "relTol": 0, "preconditioner": pc,
           "adaptMinIter": False}
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, {**ctl, "executor": "cuda"})
    torch.cuda.synchronize()
    st = registry.global_registry.get("p_solver")._precond_op.state
    exact = st.exact
    assert kernels.launches["tri_levels" if exact else "tri_sweep"] == st.applies > 0
    assert kernels.launches["tri_sweep" if exact else "tri_levels"] == 0
    registry.global_registry.clear()
    _, perf_cpu = foam.solve("p", m, b, {**ctl, "executor": "cpu"})
    assert perf.converged and perf_cpu.converged
    assert abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    assert _true_residual64(m, b, x) < 10 * 1e-6


# slice 22: AMG on unstructured meshes — the Ell and Gdia level smoothers
# (csrc/amg_ell_smooth.cu, amg_gdia_smooth.cu) and the pgm transfers
# (csrc/amg_transfer.cu), each bit-equal to its twin run on the card


def _amg_levels(mesh, aggregation, dtype, dev):
    """The hierarchy of a small unstructured mesh on the card: the kNN-6
    graph (4,096 or, "knn32k", 32,768 cells; Ell levels, Gdia once pgm has
    coarsened the smaller one) or the shuffled Poisson grid (32, 32, 16)
    (Gdia levels over a Dia coarsest)."""
    m = {"knn": lambda: testing.knn_ldu(4096)[0], "knn32k": lambda: testing.knn_ldu(1 << 15)[0],
         "shuffled": lambda: testing.shuffled_poisson_ldu((32, 32, 16))}[mesh]()
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    return amg.build_hierarchy(coo, 9, 10, aggregation, width=8, device=dev,
                               smoother_dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh,aggregation", [("knn", "pgm"), ("shuffled", "auto"),
                                              ("knn32k", "auto")], ids=str)
def test_amg_level_smoothers_bit_equal_to_twins(dev, mesh, aggregation, dtype):
    levels = _amg_levels(mesh, aggregation, dtype, dev)
    kinds = set()
    for lv in levels[:-1]:
        kind = type(lv.mat).__name__
        if kind == "Dia":
            continue
        kinds.add(kind)
        name = "amg_ell" if kind == "Ell" else "amg_gdia"
        x, b = _vec(lv.n, lv.n, dev), _vec(lv.n, lv.n + 1, dev)
        kernels.reset_launches()
        got_s = lv.kern.sweep(lv.data_s, x, b, lv.inv_diag, 0.9)
        got_r = lv.kern.resid(lv.data_s, x, b)
        torch.cuda.synchronize()
        assert kernels.launches[f"{name}_sweep"] == kernels.launches[f"{name}_resid"] == 1
        assert torch.equal(got_s, lv.kern.twin(lv.data_s, x, b, lv.inv_diag, 0.9))
        assert torch.equal(got_r, lv.kern.twin(lv.data_s, x, b, None, 0.0))
    assert kinds == {"knn": {"Ell", "Gdia"}, "shuffled": {"Gdia"}, "knn32k": {"Ell"}}[mesh]


@pytest.mark.parametrize("n,nc", [(4096, 1901), (1 << 20, 524_288), ((1 << 20) + 3, 300_001)],
                         ids=str)
def test_pgm_transfers_bit_equal_and_repeatable(dev, n, nc):
    from ogl_tpu_torch.kernels import amg_level

    rng = np.random.default_rng(n)
    agg = np.concatenate([np.arange(nc), rng.integers(0, nc, n - nc)])
    rng.shuffle(agg)
    tr = amg_level.PgmTransfer(agg, nc, dev)
    r, x = _vec(n, 1, dev), _vec(n, 2, dev)
    ec = _vec(nc, 3, dev)
    kernels.reset_launches()
    rc1, rc2 = tr.restrict(r), tr.restrict(r)
    out = tr.prolong_add(x, ec)
    torch.cuda.synchronize()
    assert kernels.launches["pgm_restrict"] == 2 and kernels.launches["pgm_prolong"] == 1
    assert torch.equal(rc1, rc2)  # no float atomics: the same bits on every run
    assert torch.equal(rc1, amg_level.pgm_restrict_plain(tr.table, r))
    assert torch.equal(out, amg_level.pgm_prolong_add_plain(tr.agg.long(), x, ec))
    exact = torch.zeros(nc, dtype=torch.float64, device=dev).index_add_(
        0, torch.tensor(agg, device=dev), r.double())
    _close(rc1.double(), exact, rtol=1e-5)


def test_amg_level_wrappers_raise_on_bad_operands_and_refused_launches(dev, monkeypatch):
    from ogl_tpu_torch.kernels import amg_level

    lv = next(lv for lv in _amg_levels("knn", "pgm", torch.bfloat16, dev)
              if isinstance(lv.mat, formats.Ell) and lv.transfer is not None)
    x, b = _vec(lv.n, 1, dev), _vec(lv.n, 2, dev)
    with pytest.raises(TypeError, match="float32"):
        lv.kern.sweep(lv.data_s, x.double(), b, lv.inv_diag, 0.9)
    with pytest.raises(ValueError, match="shape"):
        lv.kern.resid(lv.data_s[:, 1:].contiguous(), x, b)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lv.kern.resid(lv.data_s, x.cpu(), b)
    with pytest.raises(ValueError, match="shape"):
        lv.transfer.restrict(x[1:])
    kernels.reset_launches()
    with monkeypatch.context() as mp:  # a grid of no blocks: the launch is refused
        mp.setattr(amg_level, "_blocks", lambda items, device: 0)
        with pytest.raises(RuntimeError, match="amg_ell_sweep: CUDA error"):
            lv.kern.sweep(lv.data_s, x, b, lv.inv_diag, 0.9)
        with pytest.raises(RuntimeError, match="pgm_restrict: CUDA error"):
            lv.transfer.restrict(x)
    assert sum(kernels.launches.values()) == 0
    torch.cuda.synchronize()
    assert torch.equal(lv.kern.resid(lv.data_s, x, b),
                       lv.kern.twin(lv.data_s, x, b, None, 0.0))


AMG_LEVEL_SOLVES = {
    "GKOCG+MG Csr kNN": ("GKOCG", "Csr", "knn32k", "auto"),
    "GKOCG+MG Ell kNN pgm": ("GKOCG", "Ell", "knn32k", "pgm"),
    "GKOMultigrid Ell kNN": ("GKOMultigrid", "Ell", "knn32k", "auto"),
    "GKOCG+MG ladder shuffled": ("GKOCG", None, "shuffled", "auto"),
    "GKOCG+MG ladder kNN": ("GKOCG", None, "knn32k rcm", "auto"),
}


@pytest.mark.parametrize("case", list(AMG_LEVEL_SOLVES))
def test_amg_on_unstructured_meshes_on_the_card(dev, case):
    """foam.solve on the card over a hierarchy of Ell and Gdia levels: with
    grid or natural transfers on an outer plan the device V-cycle takes
    (Csr, Ell, Gdia), one launch of its loop kernel and no standalone level
    kernel; with pgm, or on the ladder's Xell, the level kernels and (pgm)
    the transfer kernels, no AMG loop kernel; ±1 iteration (bfloat16
    packing on both) of the same solve on the CPU over the twins, the true
    residual in bounds."""
    solver, fmt, mesh, aggregation = AMG_LEVEL_SOLVES[case]
    if mesh == "shuffled":
        m = testing.shuffled_poisson_ldu((32, 32, 32))
    else:
        m, perm = testing.knn_ldu(1 << 15)
        if mesh.endswith("rcm"):
            m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    pc = {"preconditioner": "Multigrid" if solver == "GKOCG" else "none",
          "aggregation": aggregation}
    ctl = {"solver": solver, "tolerance": 1e-6, "relTol": 0, "preconditioner": pc,
           "adaptMinIter": False, **({"matrixFormat": fmt} if fmt else {})}
    kernels.reset_launches()
    x, perf = foam.solve("p", m, b, {**ctl, "executor": "cuda"})
    torch.cuda.synchronize()
    slv = registry.global_registry.get("p_solver")
    levels = slv._precond_op.state
    got = dict(kernels.launches)
    on_loop = aggregation != "pgm" and not isinstance(slv.matrix, xell.Xell)
    loop = "amg_cg_loop" if solver == "GKOCG" else "amg_ir_loop"
    assert got["amg_cg_loop"] + got["amg_ir_loop"] == got[loop] == int(on_loop)
    for lv in levels[:-1]:
        name = {"Ell": "amg_ell", "Gdia": "amg_gdia", "Dia": "amg"}[type(lv.mat).__name__]
        assert (got[f"{name}_sweep"] > 0 and got[f"{name}_resid"] > 0) == (not on_loop)
    assert (got["pgm_restrict"] > 0) == (got["pgm_prolong"] > 0) == (aggregation == "pgm")
    registry.global_registry.clear()
    _, perf_cpu = foam.solve("p", m, b, {**ctl, "executor": "cpu"})
    assert perf.converged and perf_cpu.converged
    assert abs(perf.n_iterations - perf_cpu.n_iterations) <= 1
    assert _true_residual64(m, b, x) < 10 * 1e-6


# slice 23: the device V-cycle over Ell and Gdia levels, on the Gdia, Ell and
# Csr outer operators (csrc/amg_loop.cuh, its staged level phases over
# csrc/amg_stage.cuh), and the standalone level smoothers' staged bodies


def _unstructured_loop_setup(case, dtype, dev, dims=(32, 32, 32)):
    """(plan, packed values, b, op, plain K1, plain SpMV) of a device-loop
    case: the RCM-numbered kNN-6 mesh of 32,768 cells as Csr, the device
    Coo, Ell or Hybrid (a non-empty tail; Ell levels, natural runs of 8) or
    the shuffled grid `dims` as Gdia (a Gdia fine level), its `auto`
    hierarchy with `dtype` coefficients."""
    from ogl_tpu_torch.kernels import gather_spmv
    from ogl_tpu_torch.kernels.ell import EllCgKernels
    from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, gather_k1_plain

    if case == "shuffled Gdia":
        coo = ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu(dims), dtype=np.float32)
        mat = gdia.gdia_from_coo(coo, device=dev)
        kern = GdiaCgKernels(mat.shape[0], mat.plane_offsets, dev)
        data = kern.pack_values(mat)
        k1 = functools.partial(gdia.gdia_k1_plain, data[0], data[1], mat.plane_offsets)
        apply = functools.partial(gdia.gdia_spmv_plain, data[0], data[1], mat.plane_offsets)
    else:
        m, perm = testing.knn_ldu(1 << 15)
        coo = ldu.ldu_to_coo_host(testing.renumber_ldu(m, np.argsort(perm)), dtype=np.float32)
        fmt = case.split()[-1]
        conv = {"Csr": formats.coo_to_csr, "Coo": formats.coo_to_device,
                "Ell": formats.coo_to_ell, "Hybrid": formats.coo_to_hybrid}[fmt]
        mat = conv(coo, device=dev)
        kern = (CsrCgKernels if fmt in ("Csr", "Coo") else EllCgKernels)(mat)
        assert fmt != "Hybrid" or kern.n_tail > 0
        data = kern.pack_values(mat)
        k1 = functools.partial(gather_k1_plain, mat)
        apply = functools.partial({"Csr": gather_spmv.spmv_csr, "Coo": gather_spmv.spmv_csr,
                                   "Ell": gather_spmv.spmv_ell,
                                   "Hybrid": gather_spmv.spmv_hybrid}[fmt], mat)
    op = amg.amg(coo, dev, max_levels=9, min_coarse_rows=10, aggregation="auto",
                 smoother_dtype=dtype)
    assert amg_loop.qualifies(op, kern)
    kinds = {type(lv.mat).__name__ for lv in op.state[:-1]}
    assert kinds & {"Ell", "Gdia"}
    return kern, data, _vec(mat.shape[0], 23, dev), op, k1, apply


UNSTRUCTURED_LOOP_CASES = ["kNN Csr", "kNN Coo", "kNN Ell", "kNN Hybrid", "shuffled Gdia"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", UNSTRUCTURED_LOOP_CASES)
@pytest.mark.parametrize("name", ["cg", "ir"])
def test_amg_loop_on_unstructured_levels_matches_plain(dev, name, case, dtype):
    """Each new variant against its plain twin on the card (the plan's plain
    K1 or SpMV, vcycle_plain over the levels' twins): pinned, x within
    AMG_LOOP_RTOL; free-running, ±1 iteration and the true residual in
    bounds; one launch of the loop, repeating its bits, and no standalone
    level kernel."""
    kern, data, b, op, k1, apply = _unstructured_loop_setup(case, dtype, dev)
    loop = amg_loop.amg_cg_loop if name == "cg" else amg_loop.amg_ir_loop
    cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                              sweeps=op.smooth_iters)
    pinned = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=AMG_LOOP_PINNED,
                                     max_iter=AMG_LOOP_PINNED, frequency=1)
    free = stopping.StoppingParams(tolerance=LOOP_TOL, rel_tol=0.0, min_iter=0, max_iter=1000,
                                   frequency=1)
    for cfg in (pinned, free):
        state_p = _amg_state(kern, data, b)
        twin = amg_loop.amg_cg_loop_plain if name == "cg" else amg_loop.amg_ir_loop_plain
        it_p, rn_p, _, conv_p = twin(k1 if name == "cg" else apply, *state_p, cfg, cycle)
        runs = []
        for _ in range(2):
            state = _amg_state(kern, data, b)
            kernels.reset_launches()
            runs.append((state[0], *loop(kern, data, op, *state, cfg)))
            torch.cuda.synchronize()
            assert kernels.launches[f"amg_{name}_loop"] == 1
            assert not any(kernels.launches[k] for k in ("amg_ell_sweep", "amg_ell_resid",
                                                         "amg_gdia_sweep", "amg_gdia_resid"))
        x, it, rn, _, conv = runs[0]
        assert runs[1][1] == it and torch.equal(runs[1][0], x)
        if cfg is pinned:
            assert it == it_p == AMG_LOOP_PINNED and not conv
            _close(x, state_p[0], rtol=AMG_LOOP_RTOL)
            torch.testing.assert_close(rn, rn_p.cpu(), rtol=AMG_LOOP_RTOL, atol=0)
        else:
            assert bool(conv) and bool(conv_p) and abs(it - it_p) <= 1
            assert float(rn) < LOOP_TOL
            r64 = b.double() - apply(x).double()  # float64 of the float32 product
            assert float(r64.abs().sum() / state[-1].double()) <= 10 * LOOP_TOL


@pytest.mark.parametrize("mesh", ["knn", "shuffled"])
def test_amg_level_smoothers_bit_equal_at_1m(dev, mesh):
    """The standalone Ell and Gdia smoothers at the 1M fine levels of
    chip_smoke.py's pKMG (kNN-6, RCM-numbered; Ell K 17) and pSMG (the
    shuffled grid (128, 128, 64); Gdia), in float32 and bfloat16: every
    output bit-equal to its twin."""
    if mesh == "knn":
        m, perm = testing.knn_ldu(1 << 20)
        m = testing.renumber_ldu(m, np.argsort(perm))
    else:
        m = testing.shuffled_poisson_ldu((128, 128, 64))
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    lv = amg.build_hierarchy(coo, 1, 10, "auto", width=8, coarse_solver="cg", device=dev,
                             smoother_dtype=torch.float32)[0]
    assert type(lv.mat).__name__ == ("Ell" if mesh == "knn" else "Gdia")
    x, b = _vec(lv.n, 5, dev), _vec(lv.n, 6, dev)
    for vals in (lv.data_s, lv.data_s.to(torch.bfloat16)):
        got_s = lv.kern.sweep(vals, x, b, lv.inv_diag, 0.9)
        got_r = lv.kern.resid(vals, x, b)
        assert torch.equal(got_s, lv.kern.twin(vals, x, b, lv.inv_diag, 0.9))
        assert torch.equal(got_r, lv.kern.twin(vals, x, b, None, 0.0))


def test_amg_loop_on_gdia_refused_cooperative_launch_raises(dev):
    """A grid above the co-resident blocks of the Gdia-outer variant at its
    staged shared memory (the shuffled grid of 1M cells: a Gdia fine level,
    then a staged Ell level) is refused; the wrapper raises and launches
    nothing, and the next launch runs."""
    kern, data, b, op, _, _ = _unstructured_loop_setup("shuffled Gdia", torch.bfloat16, dev,
                                                       (128, 128, 64))
    cfg = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=3, max_iter=3,
                                  frequency=1)
    amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)
    tab = amg_loop.table_of(op)
    assert tab.smem > 0  # the Ell level's stages
    key = (kern.device.index, amg_loop.VARIANT_BF16 | amg_loop.OUTER_BITS[type(kern)], tab.smem)
    co_resident = amg_loop._grids[key]
    assert 0 < co_resident < -(-kern.n // 512)
    amg_loop._grids[key] = co_resident + 1
    kernels.reset_launches()
    try:
        with pytest.raises(RuntimeError, match="amg_cg_loop: CUDA error"):
            amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)
        assert kernels.launches["amg_cg_loop"] == 0
    finally:
        amg_loop._grids[key] = co_resident
    assert amg_loop.amg_cg_loop(kern, data, op, *_amg_state(kern, data, b), cfg)[0] == 3
