"""The Xell CG loop kernel's plain twin (`cg_loop_plain` over the port's
`XellCgKernels.k1`: the merged CG loop, criterion included, with identity
or scalar Jacobi preconditioning) against the reference's merged CG
(`ogl_tpu.solve.cg_fused` over its `XellCgKernels`, Pallas in interpret
mode) on the same numpy inputs; the dispatch of `XellCgKernels.cg_loop` and
`cg_fused` on CPU tensors; and the band arithmetic the Xell kernels share
(`csrc/xell_band.cuh`): which rows a band holds, and which bands each block
of a loop grid walks.  Then the general BiCGStab loop on Xell: its twin
(`bicgstab_gen_loop_plain` over the Xell SpMV, the route of
solve/bicgstab.py with the plan `XellCgKernels`) against the reference's
`bicgstab` over `xell_matvec` in interpret mode at 10 pinned iterations
(float32 BiCGStab on a symmetric graph moves its free-running count with
one ulp of b), its CPU dispatch, and foam.solve keeping the Xell plan.

The matrices are the random graph with a heavy spill and the kNN mesh over
two destination tiles with c_left > 0 (tests/test_torch_xell.py builds both
the same way), their values made symmetric and diagonally dominant (CG
needs an SPD matrix; the sparsity, and so the packing and the spill, stay
the same).  Pinned iterations (tolerance 0, minIter = maxIter = 40)
have no stop decision a one-ulp difference could flip: x within rtol 1e-4.
A free-running solve may stop one checked iteration apart (the reference's
K1 crosses its gathers through float32 MXU transposes and adds the spill in
another order): |Δiterations| ≤ frequency, x atol 1e-3."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu.config import StoppingConfig
from ogl_tpu.kernels import xell as ref_xell
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu.solve.bicgstab import bicgstab as ref_bicgstab
from ogl_tpu.solve.cg_fused import cg_fused as ref_cg_fused
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, kernels, testing
from ogl_tpu_torch.kernels import xell
from ogl_tpu_torch.kernels.fused import bicgstab_gen_loop_plain, cg_loop_plain
from ogl_tpu_torch.solve import bicgstab, stopping
from ogl_tpu_torch.solve.cg_fused import cg_fused, merged_norm_factor
from ogl_tpu_torch.solve.krylov import single_device_ops
from test_torch_xell import CASES as XELL_CASES
from test_torch_xell import _port_coo

torch.set_num_threads(2)

bicgstab_module = importlib.import_module("ogl_tpu_torch.solve.bicgstab")

MATRICES = ("graph_spill_high", "knn_two_tiles")
STOPPING = {
    "pinned": StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=40, max_iter=40),
    "free": StoppingConfig(tolerance=1e-5, rel_tol=0.0, max_iter=400),
    "frequency4_minIter3": StoppingConfig(tolerance=1e-5, rel_tol=0.0, min_iter=3,
                                          max_iter=400, frequency=4),
}


def _spd(coo):
    """The matrix of `coo` (a symmetric sparsity) with the values of
    (A + Aᵀ)/2 off the diagonal and Σ|off-diagonal| + 1 on it: SPD."""
    rows, cols = np.asarray(coo.rows, np.int64), np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals, np.float64)
    n = coo.shape[0]
    key = rows * n + cols
    at = np.searchsorted(key, cols * n + rows)  # row-major sorted: the transpose's entries
    assert np.array_equal(key[at], cols * n + rows)
    sym = 0.5 * (vals + vals[at])
    off = rows != cols
    diag = np.bincount(rows[off], weights=np.abs(sym[off]), minlength=n) + 1.0
    sym = np.where(off, sym, diag[rows]).astype(np.float32)
    return type(coo)(rows=coo.rows, cols=coo.cols, vals=sym, shape=coo.shape)


@pytest.fixture(scope="module", params=MATRICES)
def system(request):
    """(reference Xell, port Xell, b, invd) of one SPD matrix."""
    make, spill_frac = XELL_CASES[request.param]
    coo = _spd(make())
    ref = ref_xell.xell_from_coo(coo, spill_frac=spill_frac)
    mat = xell.xell_from_coo(_port_coo(coo), spill_frac=spill_frac)
    n = coo.shape[0]
    rows, cols, vals = (np.asarray(a) for a in (coo.rows, coo.cols, coo.vals))
    diag = np.zeros(n, np.float32)
    diag[rows[rows == cols]] = vals[rows == cols]
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    if request.param == "graph_spill_high":
        assert mat.spill.vals.shape[0] > 100
    else:
        assert mat.vals.shape[0] == 2 and mat.c_left > 0 and n % 128
    return ref, mat, b, (1.0 / diag).astype(np.float32)


def _loop_state(kern, data, b, x0, invd=None):
    """The set-up of solve/cg_fused.py: x, r = b − A x, ρ, ‖r‖₁, nf (and
    z = invd ⊙ r, ρ = Σ r·z with Jacobi)."""
    x = x0.clone()
    r = b - kern.apply(data, x)
    z = None if invd is None else invd * r
    return (x, r, torch.sum(r * (r if z is None else z)), torch.sum(torch.abs(r)),
            merged_norm_factor(kern, data, r, x, b), z)


def _twin(mat, b, cfg, invd=None):
    """The twin over the plan's K1 from the set-up: (x, *record)."""
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    invd = None if invd is None else torch.tensor(invd)
    x, r, rho, absr, nf, z = _loop_state(kern, data, torch.tensor(b),
                                         torch.zeros(len(b)), invd)
    return (x, *cg_loop_plain(functools.partial(kern.k1, data), x, r, rho, absr, nf, cfg,
                              invd, z))


def _reference(ref, b, cfg, invd=None):
    rkern, data3 = make_cg_kernels(ref, interpret=True)
    return ref_cg_fused(rkern, data3, jnp.asarray(b), jnp.zeros(len(b), jnp.float32), cfg,
                        invd=None if invd is None else jnp.asarray(invd))


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("name", list(STOPPING))
def test_xell_loop_plain_matches_reference(system, name, pc):
    ref, mat, b, invd = system
    invd = invd if pc == "BJ" else None
    cfg = STOPPING[name]
    x, iters, rn, init_rn, converged = _twin(mat, b, cfg, invd)
    want = _reference(ref, b, cfg, invd)
    x_ref = np.asarray(want.x)
    assert bool(converged) == bool(want.converged)
    np.testing.assert_allclose(float(init_rn), float(want.init_res_norm), rtol=1e-4)
    if name == "pinned":
        assert iters == int(want.iters) == 40 and not converged
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(x_ref).max()))
    else:
        assert converged and float(rn) < 1e-5
        assert abs(iters - int(want.iters)) <= cfg.frequency
        np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-3)
    if name == "frequency4_minIter3":
        assert iters % 4 == 0 and iters >= 4


@pytest.mark.parametrize("pc", ["none", "BJ"])
def test_cpu_dispatch_runs_the_plain_twin(system, pc):
    """CPU tensors through XellCgKernels.cg_loop run cg_loop_plain (no launch
    is counted), and cg_fused on CPU keeps its host loop: the same iterate
    and count, bit for bit, as the twin."""
    _, mat, b, invd = system
    invd = torch.tensor(invd) if pc == "BJ" else None
    cfg = STOPPING["free"]
    x_twin, *twin = _twin(mat, b, cfg, None if invd is None else invd.numpy())
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    bt = torch.tensor(b)
    kernels.reset_launches()
    x, r, rho, absr, nf, z = _loop_state(kern, data, bt, torch.zeros(len(b)), invd)
    got = kern.cg_loop(data, x, r, rho, absr, nf, cfg, invd=invd, z=z)
    res = cg_fused(kern, data, bt, torch.zeros(len(b)), cfg, invd=invd)
    assert sum(kernels.launches.values()) == 0
    assert got[0] == twin[0] and all(torch.equal(g, t) for g, t in zip(got[1:], twin[1:]))
    torch.testing.assert_close(x, x_twin, rtol=0, atol=0)
    assert res.iters == twin[0] and torch.equal(res.converged, twin[3])
    torch.testing.assert_close(res.x, x_twin, rtol=0, atol=0)
    torch.testing.assert_close(res.final_res_norm, twin[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="invd and z"):
        kern.cg_loop(data, x, r, rho, absr, nf, cfg, invd=torch.ones(len(b)))


# ragged sizes: below one band, one band and a row, over a tile, n % 4 != 0
BAND_SIZES = (1, 1801, 2049, 16384 + 3, 3 * 16384 + 129, 1 << 20)


@pytest.mark.parametrize("n", BAND_SIZES)
def test_bands_cover_the_rows_once(n):
    """band_grid(n) bands of BAND_ROWS rows cover [0, n) exactly once (the
    last one ragged), each inside one tile at the block row its origin
    names; partials are one per band."""
    bands = xell.band_grid(n)
    assert bands == -(-n // 2048) and (bands - 1) * xell.BAND_ROWS < n <= bands * xell.BAND_ROWS
    for band in {0, bands // 2, bands - 1}:
        tile, t0 = xell.band_origin(band)
        first = (tile * xell.TB + t0) * xell.LANES
        assert first == band * xell.BAND_ROWS and t0 + 16 <= xell.TB
        assert first // (xell.TB * xell.LANES) == tile  # the band lies in one tile


@pytest.mark.parametrize("n", BAND_SIZES)
def test_band_walk_covers_each_band_once(n):
    """For every grid from 1 block to band_grid(n) (sampled at large n), the
    blocks' band walks of the loop kernel's K1 phase partition the bands,
    each block in increasing order."""
    bands = xell.band_grid(n)
    grids = range(1, bands + 1) if bands <= 64 else (1, 2, 3, 7, 132, 264, bands - 1, bands)
    for blocks in grids:
        seen = []
        for block in range(blocks):
            walk = list(xell.band_walk(block, blocks, n))
            assert walk == sorted(walk)
            seen += walk
        assert sorted(seen) == list(range(bands))


def test_k1_partials_are_one_per_band():
    """The K1 wrapper's CPU route (the plain twin) gives δ = Σ p'·q; on the
    card its partials are band_grid(n) floats, one per block of the band
    grid — which is also the SpMV's grid."""
    make, spill_frac = XELL_CASES["knn_two_tiles"]
    mat = xell.xell_from_coo(_port_coo(make()), spill_frac=spill_frac)
    plan = xell.XellPlan.of(mat)
    data = (mat.vals, mat.ll, mat.bbT, mat.spill.vals)
    rng = np.random.default_rng(3)
    z, p = (torch.tensor(rng.normal(size=plan.n).astype(np.float32)) for _ in range(2))
    beta = torch.tensor(0.37)
    pw, q, delta = xell.xell_k1(plan, *data, z, p, beta)
    assert torch.equal(pw, z + beta * p)
    assert torch.equal(q, xell.xell_spmv(plan, *data, pw))
    torch.testing.assert_close(delta, torch.sum(pw * q), rtol=0, atol=0)
    assert xell.band_grid(plan.n) == 10 and plan.n_tiles * 8 >= xell.band_grid(plan.n)


# ---- the general BiCGStab loop on Xell --------------------------------------

BICGSTAB_PINNED = StoppingConfig(tolerance=0.0, rel_tol=0.0, min_iter=10, max_iter=10)


def _bicgstab_port(mat, b, invd, cfg):
    """solve/bicgstab.py handed the Xell plan (on CPU tensors: the twin),
    from a zero guess."""
    kern = xell.XellCgKernels.for_matrix(mat)
    iv = None if invd is None else torch.tensor(invd)
    ops = single_device_ops(xell.xell_matvec(mat), kern.n,
                            precond=None if iv is None else (lambda r: iv * r))
    bt = torch.tensor(b)
    kernels.reset_launches()
    res = bicgstab(ops, bt, torch.zeros_like(bt), cfg, kern,
                                  kern.pack_values(mat), iv)
    assert sum(kernels.launches.values()) == 0  # CPU tensors run the twin
    return res


@pytest.mark.parametrize("pc", ["none", "BJ"])
def test_bicgstab_twin_matches_reference(system, pc):
    ref, mat, b, invd = system
    invd = invd if pc == "BJ" else None
    ours = _bicgstab_port(mat, b, invd, BICGSTAB_PINNED)
    ij = None if invd is None else jnp.asarray(invd)
    ops = ref_ops(ref_xell.xell_matvec(ref, interpret=True), ref.shape[0],
                  precond=None if ij is None else (lambda r: ij * r))
    bj = jnp.asarray(b)
    want = ref_bicgstab(ops, bj, jnp.zeros_like(bj), BICGSTAB_PINNED)
    assert ours.iters == int(want.iters) == 10 and not bool(ours.converged)
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(ours.x.numpy(), x_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(x_ref).max()))
    np.testing.assert_allclose(float(ours.init_res_norm), float(want.init_res_norm), rtol=1e-4)
    np.testing.assert_allclose(float(ours.final_res_norm), float(want.final_res_norm),
                               rtol=1e-4, atol=1e-6 * float(want.init_res_norm))


@pytest.mark.parametrize("pc", ["none", "BJ"])
def test_bicgstab_cpu_dispatch_runs_the_twin(system, pc):
    """XellCgKernels.bicgstab_gen_loop on CPU tensors (its own Ops over the
    plan's SpMV and invd ⊙ ·) gives solve/bicgstab.py's host loop bit for
    bit, no launch counted."""
    _, mat, b, invd = system
    iv = torch.tensor(invd) if pc == "BJ" else None
    cfg = stopping.StoppingParams(tolerance=1e-5, rel_tol=0.0, min_iter=0, max_iter=200,
                                  frequency=1)
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    ops = single_device_ops(xell.xell_matvec(mat), kern.n,
                            precond=None if iv is None else (lambda r: iv * r))
    bt = torch.tensor(b)
    host = bicgstab(ops, bt, torch.zeros_like(bt), cfg)
    x0 = torch.zeros_like(bt)
    r0 = bt - ops.matvec(x0)
    rh = r0.clone()
    kernels.reset_launches()
    got = kern.bicgstab_gen_loop(data, x0, r0, rh, torch.sum(rh * r0), torch.sum(torch.abs(r0)),
                                 stopping.initial_norm_factor(ops, r0, x0, bt), cfg, iv)
    assert sum(kernels.launches.values()) == 0
    assert got[0] == host.iters and torch.equal(x0, host.x)
    assert torch.equal(got[1], host.final_res_norm) and torch.equal(got[3], host.converged)
    assert bicgstab_module.bicgstab_gen_loop_plain is bicgstab_gen_loop_plain  # one host loop


def test_foam_gkobicgstab_on_xell_keeps_the_plan():
    """GKOBiCGStab with matrixFormat Xell through foam.solve keeps the Xell
    plan for the loop kernel (why_not None; on the card one launch) and on
    the CPU converges through the twin, no launch counted."""
    m, perm = testing.knn_ldu(4096)
    m = testing.renumber_ldu(m, np.argsort(perm))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    for pc in ("none", {"preconditioner": "BJ"}):
        slv = foam.FoamSolver("u", {"solver": "GKOBiCGStab", "executor": "cpu",
                                    "matrixFormat": "Xell", "tolerance": 1e-6, "relTol": 0,
                                    "adaptMinIter": False, "preconditioner": pc})
        kernels.reset_launches()
        x, perf = slv.solve(m, b)
        assert sum(kernels.launches.values()) == 0
        assert slv.route == "bicgstab" and type(slv.kern) is xell.XellCgKernels
        assert perf.converged and perf.final_residual < 1e-6
        a = testing.to_dense_ldu(m)
        assert np.abs(b - a @ x.numpy().astype(np.float64)).sum() / np.abs(b).sum() < 1e-5
