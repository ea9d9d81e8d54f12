"""Restarted GMRES (GKOGMRES) on an `Ops` bundle, as a host loop over the
basis kernels.

Counterpart: ogl_tpu/solve/gmres.py, which replaces `gko::solver::Gmres` as
driven by GKOGMRES.  Kept from the reference:

  * right preconditioning (x = x0 + M⁻¹ V y) and `krylovDim` m;
  * blocked MODIFIED Gram–Schmidt over blocks of 8 basis rows, no
    re-orthogonalisation (kernels/gmres.py `gmres_arnoldi`);
  * the OpenFOAM criterion on a materialised residual only where the
    minIter/frequency gate fires, behind the 2-norm pre-gate: with right
    preconditioning |g[j]| is the true residual 2-norm and ‖r‖₁ ≥ ‖r‖₂, so
    a check that cannot pass (|g[j]| ≥ 4·tol·nf, and the relTol bound) is
    skipped;
  * `basisPrecision bfloat16`: V stored in bfloat16, the running vector v
    and every sum in float32; the ratio check (a materialised residual 8x
    above the estimate restarts the cycle) and the estimate-stagnation
    restart near the cycle's bfloat16 floor;
  * the exact final residual, one more materialised evaluation.

The loop runs on the host (a device loop is ROADMAP.md §B item 2).  Each
Arnoldi step is the format's SpMV kernel over M⁻¹ v, ONE launch of the
Arnoldi kernel and ONE device-to-host copy of h[0..j+1]; the Givens chain
then runs on the host, one rotation after another, in Python floats
(float64), and so does the small triangular solve for y.  The reference
applies its rotations as an associative scan in float32 (gmres.py:303-330):
the same recurrence, rounded in another order and precision (ROADMAP.md
§C: a float32 chain in this order is no closer to the scan, and near a
bfloat16 basis's floor on an ill-conditioned system it restarts more).
A fired check recombines the basis with the combine kernel
(`gmres_combine`), then M⁻¹, the SpMV and ‖r‖₁, and reads one bool.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ogl_tpu_torch.kernels.gmres import gmres_arnoldi, gmres_combine, new_basis
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["gmres"]


def _solve_y(H: np.ndarray, g: list, j: int) -> np.ndarray:
    """y = H[:j, :j]⁻¹ g[:j] by back substitution (H upper triangular after
    the rotations)."""
    y = np.zeros(j, np.float64)
    for i in range(j - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:]) / H[i, i]
    return y


def gmres(ops: Ops, b, x0, cfg, krylov_dim: int = 100, basis_dtype=None,
          arnoldi=gmres_arnoldi, combine=gmres_combine) -> SolveResult:
    """basis_dtype torch.bfloat16 stores the Krylov basis in bfloat16.
    arnoldi, combine: the basis steps (kernels/gmres.py; their twins give
    the same solve over the plain functions on any device)."""
    dtype = b.dtype
    bdtype = dtype if basis_dtype is None else basis_dtype
    reduced = bdtype != dtype
    n = b.shape[0]
    m = int(krylov_dim)
    hard_cap = cfg.max_iter + cfg.frequency
    tiny = stopping.small_of(dtype) ** 2
    eps_b = torch.finfo(bdtype).eps
    x = x0.to(dtype).clone()
    V = new_basis(m, n, bdtype, b.device)
    h_dev = torch.zeros(m + 1, dtype=dtype, device=b.device)
    st = stopping.init_state(dtype, b.device)
    nf_h, init_rn_h = 1.0, 0.0  # host copies for the pre-gate, set at iteration 0

    def x_at(x_restart, H, g, j):
        if j == 0:  # y = 0: M⁻¹ 0 = 0
            return x_restart
        y = torch.tensor(_solve_y(H, g, j), dtype=dtype, device=b.device)
        return x_restart + ops.precond(combine(V, y, j, n))

    while not st.converged and st.iter < hard_cap:
        r = b - ops.matvec(x)
        beta_t = ops.norm2(r)
        beta = float(beta_t)
        v = r / torch.clamp(beta_t, min=tiny)
        V[0, :n] = v.to(bdtype)
        g = [0.0] * (m + 1)
        g[0] = beta
        H = np.zeros((m + 1, m), np.float64)
        cs, sn = [1.0] * m, [0.0] * m
        j, stall, chk, pj, pest = 0, False, beta, 0, beta
        checked = None  # (j, x) of the last materialised check
        while j < m and not stall and not st.converged and st.iter < hard_cap:
            it = st.iter
            est2 = abs(g[j])
            fire = stopping.would_check(cfg, it)
            if fire:
                could_hit = est2 < 4.0 * cfg.tolerance * nf_h or (
                    cfg.rel_tol > 0 and est2 < 4.0 * cfg.rel_tol * init_rn_h * nf_h)
                if reduced:
                    # a true-residual check every ~1.5 claimed decades
                    could_hit = could_hit or est2 < 0.03 * chk
                fire = it == 0 or could_hit or it >= cfg.max_iter
            stalled = False
            if fire:
                xj = x_at(x, H, g, j)
                rj = b - ops.matvec(xj)
                if it == 0:
                    st = st.replace(norm_factor=stopping.initial_norm_factor(ops, rj, xj, b))
                st = stopping.check_from_norm(cfg, st, ops.norm1(rj))
                if it == 0:
                    nf_h, init_rn_h = (float(t) for t in (st.norm_factor, st.init_res_norm))
                if reduced:
                    # the true residual far above the estimate: the cycle hit
                    # the basis's representation floor; restart from x
                    stalled = (not st.converged and j >= 2
                               and float(ops.norm2(rj)) > 8.0 * abs(g[j]))
                checked = (j, xj)
                chk = est2
            if reduced:
                # the estimate failing to fall 30% over 8 steps near the
                # cycle's bfloat16 floor (~eps · β₀, 32x slack)
                window = (j - pj) >= 8
                near_floor = est2 < 32.0 * eps_b * beta
                stalled = stalled or (window and near_floor and est2 > 0.7 * pest
                                      and not st.converged)
                if window:
                    pj, pest = j, est2
            if st.converged:
                break
            # Arnoldi: w = A M⁻¹ v_j, orthogonalised against V[0..j] on the device
            w = ops.matvec(ops.precond(v))
            v = arnoldi(V, w, j, h_dev, tiny)
            hc = h_dev[:j + 2].tolist()
            for k in range(j):  # the previous rotations, in order
                a, c = hc[k], hc[k + 1]
                hc[k] = cs[k] * a + sn[k] * c
                hc[k + 1] = -sn[k] * a + cs[k] * c
            denom = math.sqrt(hc[j] * hc[j] + hc[j + 1] * hc[j + 1])
            if denom > tiny:
                cs[j], sn[j] = hc[j] / denom, hc[j + 1] / denom
            else:
                cs[j], sn[j] = 1.0, 0.0
            hc[j] = cs[j] * hc[j] + sn[j] * hc[j + 1]
            hc[j + 1] = 0.0
            H[:j + 2, j] = hc
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            j += 1
            st = st.replace(iter=st.iter + 1)
            stall = stalled
        x = checked[1] if checked is not None and checked[0] == j else x_at(x, H, g, j)

    # exact exit residual: checks may have been skipped by the pre-gate
    rn_fin = ops.norm1(b - ops.matvec(x)) / st.norm_factor
    fin = st.replace(res_norm=rn_fin)
    return SolveResult(x=x, iters=st.iter, init_res_norm=st.init_res_norm,
                       final_res_norm=rn_fin, converged=stopping.satisfied(cfg, fin))
