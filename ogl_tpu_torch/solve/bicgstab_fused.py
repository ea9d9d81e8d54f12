"""Merged-kernel BiCGStab for Dia matrices — three kernels per iteration.

Counterpart: ogl_tpu/solve/bicgstab_fused.py.  The recurrence of
solve/bicgstab.py under identity preconditioning (`fusedBiCGStab true`
with preconditioner `none`), each iteration as
  K1B        p' = r + β·p − β·ω·v ;  v' = A p' ;  <r̂, v'>
  K1B        s = r − α·v' ;  t = A s ;  <t, s>, <t, t>      (b and c both v')
  KB_update  x' = x + α·p' + ω·s ;  r' = s − ω·t ;  <r̂, r'>, ‖r'‖₁
(kernels/fused.py, CUDA C++).  ρ and ‖r‖₁ of the next check come out of
KB_update.

On the card the whole loop, criterion included, is one persistent kernel
(`CgKernels.bicgstab_loop`, csrc/bicgstab_loop.cu): one launch per solve
and one host read of its record, as the reference runs the loop as one
device program.  On the CPU, or with a plan that is not CgKernels itself
(a subclass that overrides a step), the loop runs on the host
(`bicgstab_loop_plain` over the plan's K1B and KB_update): the iteration
counter and the gating are host integers; ρ, α, ω, β and the K1B
coefficients β and −β·ω, −α stay 0-d device tensors (computed on the
device, read by the kernels through pointers); the host reads one bool per
checked iteration.  Either way the check is at the top of the iteration on
the carried ‖r‖₁; when it says converged the loop leaves, exactly the
reference's α = ω = 0 freeze.  KB_update updates x in place and writes r'
into r's buffer, so r̂ is a copy of r0.
"""

from __future__ import annotations

import functools

import torch

from ogl_tpu_torch.kernels.fused import CgKernels, bicgstab_loop_plain
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

__all__ = ["bicgstab_fused"]


def bicgstab_fused(kern: CgKernels, data, b, x0, cfg) -> SolveResult:
    """b, x0: flat (n,) float32 tensors on kern's device; data:
    kern.pack_values(mat)."""
    x = x0.to(kern.dtype).clone()
    r = b - kern.apply(data, x)
    rhat = r.clone()  # fixed shadow residual (r's buffer takes every r')
    rho = torch.sum(r * r)
    absr = torch.sum(torch.abs(r))
    nf = merged_norm_factor(kern, data, r, x, b)
    # the exact type: subclasses that override a step keep the host loop
    if type(kern) is CgKernels and b.device.type == "cuda":
        iters, rn, init_rn, converged = kern.bicgstab_loop(data, x, r, rhat, rho, absr, nf, cfg)
    else:
        iters, rn, init_rn, converged = bicgstab_loop_plain(
            functools.partial(kern.k1b, data), kern.kb_update, x, r, rhat, rho, absr, nf, cfg)
    return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                       converged=converged)
