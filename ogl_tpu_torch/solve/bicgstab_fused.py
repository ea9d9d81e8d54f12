"""Merged-kernel BiCGStab for Dia matrices — three kernels per iteration.

Counterpart: ogl_tpu/solve/bicgstab_fused.py.  The recurrence of
solve/bicgstab.py under identity preconditioning (`fusedBiCGStab true`
with preconditioner `none`), each iteration as
  K1B        p' = r + β·p − β·ω·v ;  v' = A p' ;  <r̂, v'>
  K1B        s = r − α·v' ;  t = A s ;  <t, s>, <t, t>      (b and c both v')
  KB_update  x' = x + α·p' + ω·s ;  r' = s − ω·t ;  <r̂, r'>, ‖r'‖₁
(kernels/fused.py: K1B in CUDA C++, KB_update in Triton).  ρ and ‖r‖₁ of
the next check come out of KB_update.

The loop runs on the host.  The iteration counter and the gating are host
integers; ρ, α, ω, β and the K1B coefficients β and −β·ω, −α stay 0-d
device tensors (computed on the device, read by the kernels through
pointers); the host reads one bool per checked iteration.  The check is at
the top of the iteration on the carried ‖r‖₁; when it says converged the
loop breaks, exactly the reference's α = ω = 0 freeze.  KB_update updates
x in place and writes r' into r's buffer, so r̂ is a copy of r0.
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.bicgstab import _safe_div
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

__all__ = ["bicgstab_fused"]


def bicgstab_fused(kern: CgKernels, data, b, x0, cfg) -> SolveResult:
    """b, x0: flat (n,) float32 tensors on kern's device; data:
    kern.pack_values(mat)."""
    dtype = kern.dtype
    x = x0.to(dtype).clone()
    r = b - kern.apply(data, x)
    rhat = r.clone()  # fixed shadow residual (r's buffer takes every r')
    rho = torch.sum(r * r)
    absr = torch.sum(torch.abs(r))
    nf = merged_norm_factor(kern, data, r, x, b)
    st = stopping.init_state(dtype, b.device).replace(norm_factor=nf)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    zero = torch.zeros((), dtype=dtype, device=b.device)
    rho_old = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    hard_cap = cfg.max_iter + cfg.frequency
    while st.iter < hard_cap:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = _safe_div(rho, rho_old) * _safe_div(alpha, omega)
        p, v, d_rv, _, _ = kern.k1b(data, r, p, v, rhat, beta, -beta * omega)
        alpha = _safe_div(rho, d_rv)
        s, t, _, d_ts, d_tt = kern.k1b(data, r, v, v, rhat, -alpha, zero)
        omega = _safe_div(d_ts, d_tt)
        rho_old = rho
        rho, absr = kern.kb_update(x, p, s, t, rhat, alpha, omega, r)
        st = st.replace(iter=st.iter + 1)
    return SolveResult(
        x=x,
        iters=st.iter,
        init_res_norm=st.init_res_norm,
        final_res_norm=st.res_norm,
        converged=stopping.satisfied(cfg, st),
    )
