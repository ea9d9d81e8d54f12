"""IR — preconditioned Richardson iteration: x ← x + M⁻¹ r, r ← r − A M⁻¹ r.

Counterpart: ogl_tpu/solve/ir.py (the shape without `inner_solve`).  It is
what GKOMultigrid runs, with M⁻¹ one AMG cycle.  Same OpenFOAM criterion
and host loop as solve/cg.py: the residual is the recurrence r − A dx, and
the host reads one bool per checked iteration.  The `inner` sub-dictionary
of GKOIR (an inner CG per step) is not ported (ROADMAP.md A9).
"""

from __future__ import annotations

from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["ir"]


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
