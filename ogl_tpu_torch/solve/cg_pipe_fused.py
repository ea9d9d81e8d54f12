"""Merged-kernel pipelined (Chronopoulos–Gear) PCG for Dia matrices — two
kernels per iteration.

Counterpart: ogl_tpu/solve/cg_pipe_fused.py.  The recurrences, criterion
and gating of solve/cg_pipe.py, with each iteration as
  KA       u = M⁻¹ r ;  w = A u ;  (γ, δ, ‖r‖₁)
  KB_pipe  p' = u + β·p ;  s' = w + β·s ;  x' = x + α·p' ;  r' = r − α·s'
(kernels/fused.py: KA in CUDA C++, KB_pipe in Triton).  M is diagonal:
`invd` None → identity (u ≡ r, no invd stream), else scalar Jacobi.

The loop runs on the host.  The iteration counter, the minIter/frequency
gating and `first` are host integers; γ, δ, α, β and ‖r‖₁ stay 0-d device
tensors that the kernels read through pointers; the host reads one bool
per checked iteration.  The check reads the ‖r‖₁ that KA returns for the
incoming r; when it says converged the loop breaks before KB_pipe and does
not count the pass — exactly the reference's α = 0 freeze.  KB_pipe
updates p, s, x and r in place.
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

__all__ = ["cg_pipelined_fused"]


def cg_pipelined_fused(kern: CgKernels, data, b, x0, cfg, invd=None) -> SolveResult:
    """b, x0, invd: flat (n,) float32 tensors on kern's device; data:
    kern.pack_values(mat)."""
    dtype = kern.dtype
    x = x0.to(dtype).clone()
    r = b - kern.apply(data, x)
    nf = merged_norm_factor(kern, data, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    s = torch.zeros_like(b)
    zero = torch.zeros((), dtype=dtype, device=b.device)
    gamma_old = alpha_old = torch.ones((), dtype=dtype, device=b.device)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        w, gamma, delta, absr = kern.ka(data, r, invd)
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        if st.iter == 0:
            beta, denom = zero, delta
        else:
            beta = gamma / gamma_old
            denom = delta - beta * gamma / alpha_old
        alpha = gamma / denom
        kern.kb_pipe(w, p, s, x, r, alpha, beta, invd)
        gamma_old, alpha_old = gamma, alpha
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
