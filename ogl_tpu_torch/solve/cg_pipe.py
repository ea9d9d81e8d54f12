"""Single-reduction (Chronopoulos–Gear) PCG on an `Ops` bundle.

Counterpart: ogl_tpu/solve/cg_pipe.py.  The rearrangement of classical PCG
that makes all three inner products of an iteration available at once:

    u = M⁻¹ r,  w = A u
    γ = <r, u>,  δ = <w, u>        (+ ‖r‖₁ for the criterion)
    β = γ / γ_old                  (0 on the first iteration)
    α = γ / (δ − β·γ/α_old)        (γ / δ on the first iteration)
    p = u + β p,   s = w + β s     (s carries A p)
    x += α p,      r −= α s

γ, δ and ‖r‖₁ depend only on the carried r, so they are one stacked
reduction per iteration (`ops.allreduce`; identity on one device).  The
criterion reads that ‖r‖₁ (stopping.check_from_norm); the norm factor is
computed once before the loop on the initial state.  `pipelinedCG true`
on GKOCG routes here for Gdia, Xell, Multigrid and `fusedCG false`; Dia
with `none`/`BJ` takes the merged form (solve/cg_pipe_fused.py).

The loop runs on the host, as solve/cg.py: host integers for the count and
the gating, 0-d device tensors for the scalars, one bool read per checked
iteration.  `first` is the host test `iter == 0`.  When the check says
converged the loop breaks before the update, which gives the reference's
iterate and count exactly (its α = 0 freeze leaves x and r unchanged, and
that pass is not counted).
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["cg_pipelined"]


def cg_pipelined(ops: Ops, b, x0, cfg) -> SolveResult:
    dtype = b.dtype
    x = x0.to(dtype).clone()
    r = b - ops.matvec(x)
    nf = stopping.initial_norm_factor(ops, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    s = torch.zeros_like(b)
    gamma_old = alpha_old = torch.ones((), dtype=dtype, device=b.device)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        u = ops.precond(r)
        w = ops.matvec(u)
        # the single stacked reduction of the iteration
        gamma, delta, absr = ops.allreduce(torch.stack([
            torch.sum(r * u), torch.sum(w * u), torch.sum(torch.abs(r))])).unbind()
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        if st.iter == 0:
            beta = torch.zeros((), dtype=dtype, device=b.device)
            denom = delta
        else:
            beta = gamma / gamma_old
            denom = delta - beta * gamma / alpha_old
        alpha = gamma / denom
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        gamma_old, alpha_old = gamma, alpha
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
