"""Preconditioned conjugate gradients on an `Ops` bundle.

Counterpart: ogl_tpu/solve/cg.py.  The same recurrences and the same
OpenFOAM criterion, checked before each update; the loop runs on the host
(the reference runs it as one device program) and reads one bool from the
device per checked iteration.  It is the `fusedCG false` route of the foam
layer and the independent solver the merged-kernel path is checked
against.  Its SpMV is whatever `ops.matvec` is — the Dia SpMV kernel on
the foam path.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["cg", "SolveResult"]


class SolveResult(NamedTuple):
    x: Any
    iters: int  # number of solver updates performed
    init_res_norm: Any  # 0-d tensor
    final_res_norm: Any  # residual at the last criterion check (0-d)
    converged: Any  # 0-d bool tensor: tolerance criteria met


def cg(ops: Ops, b, x0, cfg) -> SolveResult:
    dtype = b.dtype
    x = x0.to(dtype).clone()
    r = b - ops.matvec(x)
    nf = stopping.initial_norm_factor(ops, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    rho_old = torch.ones((), dtype=dtype, device=b.device)
    # gating can defer the maxIter check by at most one frequency window
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        st = stopping.check(ops, cfg, st, r)
        if st.converged:
            break
        z = ops.precond(r)
        rho = ops.dot(r, z)
        p = z if st.iter == 0 else z + (rho / rho_old) * p
        q = ops.matvec(p)
        alpha = rho / ops.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rho_old = rho
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
