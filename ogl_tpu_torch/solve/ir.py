"""IR — preconditioned Richardson iteration: x ← x + M⁻¹ r, r ← r − A M⁻¹ r.

Counterpart: ogl_tpu/solve/ir.py (the shape without `inner_solve`).  It is
what GKOMultigrid runs, with M⁻¹ one AMG cycle.  Same OpenFOAM criterion
and host loop as solve/cg.py: the residual is the recurrence r − A dx, and
the host reads one bool per checked iteration.  `ir_fused` is the same
solve on a loop plan (kernels/amg_loop.py OUTER_PLANS: Dia, Gdia, Ell or
Hybrid, Csr or Coo): on the card, with a hierarchy that qualifies
(`takes_loop`), the whole loop — criterion, V-cycle, x += z, r −= A z —
is one launch of `amg_ir_loop` (csrc/amg_loop.cuh); otherwise it is `ir`
over the plan's SpMV.  The `inner` sub-dictionary of
GKOIR (an inner CG per step) is not ported (ROADMAP.md A9).
"""

from __future__ import annotations

import functools

import torch

from ogl_tpu_torch.kernels import amg_loop
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor
from ogl_tpu_torch.solve.krylov import Ops, single_device_ops

__all__ = ["ir", "ir_fused"]


def ir(ops: Ops, b, x0, cfg) -> SolveResult:
    dtype = b.dtype
    x = x0.to(dtype).clone()
    r = b - ops.matvec(x)
    nf = stopping.initial_norm_factor(ops, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        st = stopping.check(ops, cfg, st, r)
        if st.converged:
            break
        dx = ops.precond(r).to(dtype)
        x = x + dx
        r = r - ops.matvec(dx)
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )


def ir_fused(kern, data, b, x0, cfg, precond) -> SolveResult:
    """GKOMultigrid on a loop plan (kern: one of amg_loop.OUTER_PLANS,
    data: kern.pack_values(mat)) with `precond` the AmgOp: one
    `amg_ir_loop` launch on the card from the set-up's r = b − A x and norm
    factor (both through the plan's apply) when `amg_loop.takes_loop`; else
    `ir` over the plan's SpMV."""
    if not amg_loop.takes_loop(kern, precond, b):
        ops = single_device_ops(functools.partial(kern.spmv, data), kern.n, precond=precond)
        return ir(ops, b, x0, cfg)
    x = x0.to(b.dtype).clone()
    r = b - kern.apply(data, x)
    absr = torch.sum(torch.abs(r))
    nf = merged_norm_factor(kern, data, r, x, b)
    iters, rn, init_rn, converged = amg_loop.amg_ir_loop(kern, data, precond, x, r, absr, nf,
                                                          cfg)
    return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                       converged=converged)
