"""GKOGMRES on the port against the reference: the Arnoldi and combine
twins (kernels/gmres.py) against a float64 blocked modified Gram–Schmidt,
the host-loop GMRES (solve/gmres.py) against `ogl_tpu.solve.gmres` with
restarts, the bfloat16 basis held to the true residual, and `foam.solve`
with GKOGMRES against `ogl_tpu.foam.solve`."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import foam as ref_foam
from ogl_tpu import registry as ref_registry
from ogl_tpu import testing as ref_testing
from ogl_tpu.config import PrecondConfig as RefPrecondConfig
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import spmv as ref_spmv
from ogl_tpu.precond import build as ref_build
from ogl_tpu.solve.krylov import single_device_ops as ref_ops
from ogl_tpu_torch import foam, interop, kernels, registry, testing
from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import spmv
from ogl_tpu_torch.kernels.gmres import (BLOCK, arnoldi_plan, gmres_arnoldi,
                                         gmres_arnoldi_plain, gmres_combine, gmres_combine_plain,
                                         new_basis)
from ogl_tpu_torch.precond import build
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.krylov import single_device_ops

ref_gmres = importlib.import_module("ogl_tpu.solve.gmres").gmres
gmres_mod = importlib.import_module("ogl_tpu_torch.solve.gmres")

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


# ---- the twins ---------------------------------------------------------------


def _basis(j, n, dtype, seed):
    """A basis whose rows 0..j are orthonormal (as GMRES keeps them), stored
    in `dtype`, and a w with a part inside and a part outside their span."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, j + 1)))
    V = new_basis(j + 1, n, dtype, "cpu")
    V[:j + 1, :n] = torch.tensor(q.T, dtype=torch.float32).to(dtype)
    w = (q @ rng.normal(size=j + 1) + rng.normal(size=n)).astype(np.float32)
    return V, w


def _mgs64(V, w, j, n):
    """Blocked MGS in float64 on the stored rows: the twin's arithmetic."""
    rows = V[:j + 1, :n].double().numpy()
    w = w.astype(np.float64)
    h = np.zeros(j + 2)
    for k0 in range(0, j + 1, BLOCK):
        blk = rows[k0:k0 + BLOCK]
        hb = blk @ w
        w = w - hb @ blk
        h[k0:k0 + len(hb)] = hb
    h[j + 1] = np.linalg.norm(w)
    return h, w / h[j + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("j", [0, 7, 8, 50])
def test_arnoldi_twin_is_blocked_mgs(j, dtype):
    n = 301  # not a multiple of 4: the kernels' ragged last quad
    V, w = _basis(j, n, dtype, seed=j)
    h = torch.zeros(j + 2)
    h_want, v_want = _mgs64(V, w, j, n)
    kernels.reset_launches()
    v = gmres_arnoldi(V, torch.tensor(w), j, h)  # CPU tensors: the twin
    assert kernels.launches["gmres_arnoldi"] == 0
    scale = np.linalg.norm(w)
    np.testing.assert_allclose(h.numpy(), h_want, atol=1e-5 * scale)
    np.testing.assert_allclose(v.numpy(), v_want, atol=1e-5)
    stored = V[j + 1, :n].float().numpy()
    np.testing.assert_array_equal(stored, v.to(dtype).float().numpy())
    # the twin is the function that gmres_arnoldi runs on the CPU
    V2, _ = _basis(j, n, dtype, seed=j)
    h2 = torch.zeros(j + 2)
    torch.testing.assert_close(gmres_arnoldi_plain(V2, torch.tensor(w), j, h2), v,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("j", [0, 1, 9, 50])
def test_combine_twin_rounds_in_k_order(j, dtype):
    n = 203
    V, _ = _basis(max(j, 1), n, dtype, seed=3)
    y = torch.tensor(np.random.default_rng(4).normal(size=max(j, 1)).astype(np.float32))
    got = gmres_combine(V, y, j, n)
    want = np.zeros(n, np.float32)
    rows = V[:, :n].float().numpy()
    for k in range(j):
        want = (want + (y.numpy()[k] * rows[k]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gmres_combine_plain(V, y, j, n).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [13, 301, 4097, 4104])
def test_new_basis_rows_start_16_byte_aligned(n, dtype):
    """Every row of new_basis starts 16-byte aligned in both types (the
    Arnoldi kernel's bulk copies need it), and the twin's h and v are those
    of the earlier padding to a multiple of 4 entries, bit for bit."""
    j = 9
    V, w = _basis(j, n, dtype, seed=n)
    ld = V.shape[1]
    assert ld % 8 == 0 and ld >= n and ld - n < 8
    assert all((V.data_ptr() + r * ld * V.element_size()) % 16 == 0 for r in range(V.shape[0]))
    V4 = torch.zeros((V.shape[0], -(-n // 4) * 4), dtype=dtype)
    V4[:, :n] = V[:, :n]
    h, h4 = torch.zeros(j + 2), torch.zeros(j + 2)
    v = gmres_arnoldi_plain(V, torch.tensor(w), j, h)
    v4 = gmres_arnoldi_plain(V4, torch.tensor(w), j, h4)
    assert torch.equal(h, h4) and torch.equal(v, v4)
    assert torch.equal(V[j + 1, :n], V4[j + 1, :n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [301, 4097, 262_144, 1 << 20, (1 << 20) + 3, 1 << 23])
def test_arnoldi_plan(n, dtype):
    """The Arnoldi launch's layout on a 132-SM card: slices that cover [0, n)
    once, in order, 16-byte aligned; at most 232,448 bytes of shared memory,
    as gmres_arnoldi.cuh `smem_bytes` counts them; a whole block held where
    it fits (bfloat16 at 1M, float32 at 262,144), part of it in float32 at
    1M, nothing at 8.4M."""
    bf16 = dtype == torch.bfloat16
    p = arnoldi_plan(n, bf16, 132)
    elem = 2 if bf16 else 4
    assert p.ctas == 132 and p.slice % 8 == 0
    starts = [c * p.slice for c in range(p.ctas)]
    ends = [min(s + p.slice, n) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e0 == s1 or s1 >= n for e0, s1 in zip(ends, starts[1:]))  # no gap, no overlap
    assert sum(max(0, e - s) for s, e in zip(starts, ends)) == n  # each entry once
    assert all(s * elem % 16 == 0 and s * 4 % 16 == 0 for s in starts)
    assert p.chunk * elem == 2048 and p.chunks == -(-p.slice // p.chunk)
    piece = p.chunk * elem
    smem = (1280 + (4 * p.slice if p.w_resident else 0) + (p.chunks + p.stages) * p.resident * piece
            + p.stages * 2 * (BLOCK - p.resident) * piece)
    assert p.smem == smem <= 232_448
    assert 2 <= p.stages <= 8 and 0 <= p.resident <= BLOCK
    if n == 1 << 20 and bf16 or n == 262_144:
        assert p.resident == BLOCK and p.w_resident
    if n == 1 << 20 and not bf16:
        assert 0 < p.resident < BLOCK and p.w_resident and p.hint
    if n == 1 << 23:
        assert p.resident == 0 and not p.w_resident and not p.hint


# ---- the solver against ogl_tpu.solve.gmres ----------------------------------


def _systems(kind):
    m = (ref_testing.poisson_ldu((10, 9, 4)) if kind == "poisson"
         else ref_testing.convection_diffusion_ldu((10, 9, 4)))
    b = np.random.default_rng(1).normal(size=m.n).astype(np.float32)
    ref_coo = ref_ldu.ldu_to_coo_host(m, dtype=np.float32)
    coo = ldu.ldu_to_coo_host(_port(m), dtype=np.float32)
    return m, b, ref_coo, coo


@pytest.mark.parametrize("pc", ["none", "BJ"])
@pytest.mark.parametrize("krylov", [10, 100])
@pytest.mark.parametrize("kind", ["poisson", "cd"])
def test_gmres_matches_reference(kind, krylov, pc):
    m, b, ref_coo, coo = _systems(kind)
    cfg = StoppingConfig(tolerance=TOL, rel_tol=0.0, max_iter=1000)
    params = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0, max_iter=1000,
                                     frequency=1)
    ref_mat = ref_formats.coo_to_csr(ref_coo)
    ref_pc = None if pc == "none" else ref_build(RefPrecondConfig(name="BJ"), ref_coo)
    want = ref_gmres(ref_ops(ref_spmv.matvec(ref_mat), m.n, ref_pc), jnp.asarray(b),
                     jnp.zeros(m.n, jnp.float32), cfg, krylov_dim=krylov)
    mat = formats.coo_to_csr(coo, device="cpu")
    port_pc = None if pc == "none" else build(PrecondConfig(name="BJ"), coo, "cpu")
    got = gmres_mod.gmres(single_device_ops(spmv.matvec(mat), m.n, port_pc), torch.tensor(b),
                          torch.zeros(m.n), params, krylov_dim=krylov)
    assert abs(got.iters - int(want.iters)) <= 1, (got.iters, int(want.iters))
    assert bool(got.converged) and bool(want.converged)
    x_ref = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_ref, atol=1e-4 * max(1.0, np.abs(x_ref).max()))
    assert float(got.final_res_norm) < TOL and float(want.final_res_norm) < TOL


def _true_res(m, b, x):
    a = testing.to_dense_ldu(_port(m)).astype(np.float64)
    return np.abs(b - a @ np.asarray(x, np.float64)).sum() / np.abs(b).sum()


def test_bf16_basis_reaches_the_true_tolerance():
    m, b, _, coo = _systems("poisson")
    params = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0, max_iter=1000,
                                     frequency=1)
    mat = formats.coo_to_csr(coo, device="cpu")
    res = gmres_mod.gmres(single_device_ops(spmv.matvec(mat), m.n), torch.tensor(b),
                          torch.zeros(m.n), params, krylov_dim=30,
                          basis_dtype=torch.bfloat16)
    assert bool(res.converged)
    assert _true_res(m, b, res.x.numpy()) < 2e-6


def test_bf16_basis_no_restart_pathology_on_an_ill_conditioned_system():
    """1000:1 anisotropic diffusion (tests/test_gmres_bf16_basis.py's case):
    the near-floor gate keeps the stagnation restart from re-cycling."""
    m = ref_testing.poisson_ldu((20, 20))
    la, ua = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    upper = np.where((ua - la) == 1, m.upper * 1000.0, m.upper)
    diag = np.ones(m.n)
    np.add.at(diag, la, np.abs(upper))
    np.add.at(diag, ua, np.abs(upper))
    m = dataclasses.replace(m, upper=upper.astype(m.upper.dtype), diag=diag.astype(m.diag.dtype))
    b = np.random.default_rng(9).normal(size=m.n).astype(np.float32)
    counts, res = {}, {}
    for tag, extra in (("f32", {}), ("bf16", {"basisPrecision": "bfloat16"})):
        x, perf = foam.solve(f"ill_{tag}", _port(m), b,
                             {"solver": "GKOGMRES", "executor": "cpu", "tolerance": 1e-4,
                              "relTol": 0.0, "maxIter": 4000, "krylovDim": 60,
                              "preconditioner": {"preconditioner": "GISAI",
                                                 "sparsityPower": 1}, **extra})
        assert perf.converged, (tag, perf)
        counts[tag] = perf.n_iterations
        res[tag] = _true_res(m, b, x.numpy())
    assert counts["bf16"] <= 8 * counts["f32"] + 20, counts
    assert res["bf16"] < 10 * max(res["f32"], 1e-9), res


# ---- foam.solve against the reference ----------------------------------------

FOAM_CASES = {
    "ISAI Sell": ("ISAI", "Sell", "poisson", {}),
    "GISAI Gdia": ("GISAI", "Gdia", "poisson", {}),
    "GISAI Hybrid": ("GISAI", "Hybrid", "cd", {}),
    "GISAI Ell p2": ({"preconditioner": "GISAI", "sparsityPower": 2}, "Ell", "cd", {}),
    "none Dia": ("none", "Dia", "poisson", {"krylovDim": 20}),
    "BJ Dia cd": ("BJ", "Dia", "cd", {}),
    "BJ4 Dia cd": ({"preconditioner": "BJ", "maxBlockSize": 4}, "Dia", "cd",
                   {"krylovDim": 10}),
    "BJ4 Csr": ({"preconditioner": "BJ", "maxBlockSize": 4}, "Csr", "poisson", {}),
}


@pytest.mark.parametrize("case", list(FOAM_CASES))
def test_foam_gmres_matches_reference(case):
    pc, fmt, kind, extra = FOAM_CASES[case]
    m = (ref_testing.poisson_ldu((12, 10, 6)) if kind == "poisson"
         else ref_testing.convection_diffusion_ldu((12, 10, 6)))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    ctl = {"solver": "GKOGMRES", "executor": "cpu", "matrixFormat": fmt, "tolerance": TOL,
           "relTol": 0, "preconditioner": pc, "adaptMinIter": False, **extra}
    ref_registry.global_registry.clear()
    x_ref, perf_ref = ref_foam.solve("p", m, b, ctl)
    kernels.reset_launches()
    x, perf = foam.solve("p", _port(m), b, ctl)
    assert not any(kernels.launches.values())  # CPU tensors: the twins
    assert registry.global_registry.get("p_solver").route == "gmres"
    assert perf.solver_name == perf_ref.solver_name == f"GKOGMRES_{fmt}"
    assert abs(perf.n_iterations - perf_ref.n_iterations) <= 1, (perf, perf_ref)
    assert perf.converged and perf_ref.converged
    assert _true_res(m, b, x.numpy()) < 10 * TOL
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4 * np.abs(x_ref).max())


def test_gkogmres_class_and_bf16_basis_through_foam():
    m = ref_testing.poisson_ldu((12, 10, 6))
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    slv = foam.GKOGMRES("p", {"executor": "cpu", "tolerance": TOL, "relTol": 0,
                              "preconditioner": "ISAI", "basisPrecision": "bfloat16",
                              "krylovDim": 30})
    x, perf = slv.solve(_port(m), b)
    assert slv.route == "gmres" and perf.solver_name == "GKOGMRES_Dia"
    assert perf.converged and _true_res(m, b, x.numpy()) < 10 * TOL


def test_arnoldi_phases_stamps_the_body():
    """python -m ogl_tpu_torch.arnoldi_phases stamps the step's start and end,
    every pass's sums, barrier and totals, and the waits: every anchor it
    needs is in gmres_arnoldi.cuh once."""
    from pathlib import Path

    from ogl_tpu_torch import arnoldi_phases
    from ogl_tpu_torch.kernels import gmres as gmres_kernels

    src = (Path(gmres_kernels.__file__).parent / "csrc" / "gmres_arnoldi.cuh").read_text()
    out = arnoldi_phases.stamped_source(src)
    assert out.count("ARNOLDI_STAMP(") == 9 and "t_pw +=" in out and "t_wait +=" in out
    with pytest.raises(RuntimeError, match="update arnoldi_phases.py"):
        arnoldi_phases.stamped_source(src.replace("grid.sync();", "grid.sync(); "))
