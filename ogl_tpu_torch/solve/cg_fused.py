"""Merged-kernel PCG for Dia matrices — two kernels per iteration.

Counterpart: ogl_tpu/solve/cg_fused.py.  Same recurrences, criterion and
gating as solve/cg.py; each iteration is K1 (p-update + SpMV + δ) and K2
(x/r/z updates + ρ and ‖r‖₁), so the residual norm the criterion needs
comes free.  The preconditioner is diagonal — `invd` None → identity (K2i,
no z stream), else scalar Jacobi (K2) — or rich: `precond` (the AMG
cycle) maps r to z, and each iteration runs K1, then K2n (x, r and ‖r‖₁
only), then z = precond(r) and ρ = Σ r·z (the reference's
`precond_framed` route, which the port runs on flat vectors).

With identity or scalar Jacobi preconditioning on a Dia, a Gdia or an
Xell matrix on the card the whole loop, criterion included, is one
persistent kernel (`CgKernels.cg_loop`, csrc/cg_loop.cu; Xell:
`XellCgKernels.cg_loop`, csrc/xell_cg_loop.cu, its K1 phase the Xell band
body): one launch per solve and one host read of its record, as the
reference runs the loop as one device program.  So is the
AMG-preconditioned loop on a Dia or Gdia matrix on the card when the
hierarchy qualifies (kernels/amg_loop.py `takes_loop`: cycle v, Dia, Gdia
and Ell levels, grid or natural transfers, a dense coarse inverse): K1,
K2n and the V-cycle are the phases of `amg_cg_loop` (csrc/amg_loop.cuh),
whose set-up's z = M r₀ runs inside the launch too.  Every other case — the CPU, a hierarchy that keeps the
host cycle, a plan that subclasses one of these to override a step —
loops on the host.  The iteration counter and the minIter/frequency gating
are then host integers; α, β, ρ, δ, ‖r‖₁ and the normalised residual stay 0-d
device tensors; the host reads one bool per checked iteration.  When that
bool says converged the loop breaks before K1/K2, which yields exactly the
iterate and count of the reference's branchless α = 0 freeze (its x and r
are unchanged on that last pass).

The reference gates the z-free K2i on a working-set size measured on its
TPU; that gate is not carried over — `preconditioner none` always takes
K2i, and the two routes give identical iterates when invd = 1.
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.kernels import amg_loop
from ogl_tpu_torch.kernels.fused import CgKernels, GdiaCgKernels
from ogl_tpu_torch.kernels.xell import XellCgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult

__all__ = ["cg_fused", "merged_norm_factor"]


def merged_norm_factor(kern: CgKernels, data, r, x, b):
    """The OpenFOAM norm factor (StoppingCriterion.C:32-69) on the initial
    state, with A applied through the plan's K1 (`apply`)."""
    xavg = torch.sum(x) / kern.n
    axref = kern.apply(data, torch.ones_like(x) * xavg)
    b_sub = b - axref
    return torch.sum(torch.abs(r - b_sub) + torch.abs(b_sub)) + stopping.small_of(kern.dtype)


def cg_fused(kern: CgKernels, data, b, x0, cfg, invd=None, precond=None) -> SolveResult:
    """b, x0, invd: flat (n,) float32 tensors on kern's device; data:
    kern.pack_values(mat); precond: r -> z (excludes invd), the AmgOp itself
    for the device V-cycle."""
    dtype = kern.dtype
    identity = invd is None and precond is None
    x = x0.to(dtype).clone()
    r = b - kern.apply(data, x)
    if amg_loop.takes_loop(kern, precond, b):
        absr = torch.sum(torch.abs(r))
        nf = merged_norm_factor(kern, data, r, x, b)
        iters, rn, init_rn, converged = amg_loop.amg_cg_loop(kern, data, precond, x, r, absr,
                                                              nf, cfg)
        return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                           converged=converged)
    if identity:
        z = r  # z ≡ r: K1 reads r, K2i drops the z stream
        rho = torch.sum(r * r)
    else:
        z = precond(r) if precond is not None else invd * r
        rho = torch.sum(r * z)
    absr = torch.sum(torch.abs(r))
    nf = merged_norm_factor(kern, data, r, x, b)
    # the exact type: subclasses that override a step keep the host loop
    if (precond is None and type(kern) in (CgKernels, GdiaCgKernels, XellCgKernels)
            and b.device.type == "cuda"):
        iters, rn, init_rn, converged = kern.cg_loop(data, x, r, rho, absr, nf, cfg, invd=invd,
                                                     z=None if identity else z)
        return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                           converged=converged)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    rho_old = torch.ones((), dtype=dtype, device=b.device)
    zero = torch.zeros((), dtype=dtype, device=b.device)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = zero if st.iter == 0 else rho / rho_old
        p, q, delta = kern.k1(data, z, p, beta)
        alpha = rho / delta
        rho_old = rho
        if identity:
            rho, absr = kern.k2i(alpha, x, r, p, q)
        elif precond is not None:
            absr = kern.k2n(alpha, x, r, p, q)
            z = precond(r)
            rho = torch.sum(r * z)
        else:
            rho, absr = kern.k2(alpha, x, r, p, q, invd, z)
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
