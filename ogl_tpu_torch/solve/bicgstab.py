"""Preconditioned BiCGStab on an `Ops` bundle.

Counterpart: ogl_tpu/solve/bicgstab.py, which replaces `gko::solver::
Bicgstab` as driven by GKOBiCGStab.  Two SpMVs per iteration — why the
reference doubles maxIter for this solver (config.parse_controls).  The
shadow residual is r̂ = r0.  Breakdown guards (`_safe_div`: a denominator
at most small_of(dtype)² in magnitude gives 0) zero the step instead of
poisoning the recurrence with NaN.

The five inner products of an iteration fall into three dependency groups,
each one stacked reduction (`ops.allreduce`): [‖r‖₁, <r̂,r>] on the carried
r, then [<r̂,v>] after the first SpMV, then [<t,s>, <t,t>] after the second.
The norm factor is computed once before the loop, so the criterion rides
the grouped ‖r‖₁ (stopping.check_from_norm).

The loop runs on the host, as solve/cg.py: host integers for the count and
the gating, 0-d device tensors for ρ, α, ω and the sums, one bool read per
checked iteration.  The check is at the top of the iteration, on the
carried r; when it says converged the loop breaks, which gives the
reference's iterate and count exactly (its α = ω = 0 freeze leaves x and r
unchanged, and that pass is not counted).
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["bicgstab"]


def _safe_div(num, den):
    """num / den, or 0 where |den| ≤ small_of(dtype)² (the breakdown guard)."""
    tiny = stopping.small_of(num.dtype) ** 2
    return torch.where(den.abs() > tiny, num / torch.where(den == 0, 1.0, den), 0.0)


def bicgstab(ops: Ops, b, x0, cfg) -> SolveResult:
    dtype = b.dtype
    x = x0.to(dtype).clone()
    r = b - ops.matvec(x)
    r_hat = r  # shadow residual, fixed (r is rebound, never written in place)
    nf = stopping.initial_norm_factor(ops, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho_old = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        # group 1: ‖r‖₁ (criterion) and ρ = <r̂, r>
        absr, rho = ops.allreduce(torch.stack(
            [torch.sum(torch.abs(r)), torch.sum(r_hat * r)])).unbind()
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = _safe_div(rho, rho_old) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        y = ops.precond(p)
        v = ops.matvec(y)
        alpha = _safe_div(rho, ops.dot(r_hat, v))  # group 2
        s = r - alpha * v
        z = ops.precond(s)
        t = ops.matvec(z)
        # group 3: <t, s> and <t, t>
        ts, tt = ops.allreduce(torch.stack([torch.sum(t * s), torch.sum(t * t)])).unbind()
        omega = _safe_div(ts, tt)
        x = x + alpha * y + omega * z
        r = s - omega * t
        rho_old = rho
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
