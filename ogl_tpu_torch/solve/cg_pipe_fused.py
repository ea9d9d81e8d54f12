"""Merged-kernel pipelined (Chronopoulos–Gear) PCG for Dia matrices — two
kernels per iteration.

Counterpart: ogl_tpu/solve/cg_pipe_fused.py.  The recurrences, criterion
and gating of solve/cg_pipe.py, with each iteration as
  KA       u = M⁻¹ r ;  w = A u ;  (γ, δ, ‖r‖₁)
  KB_pipe  p' = u + β·p ;  s' = w + β·s ;  x' = x + α·p' ;  r' = r − α·s'
(kernels/fused.py, CUDA C++).  M is diagonal: `invd` None → identity
(u ≡ r, no invd stream), else scalar Jacobi.

On the card the whole loop, criterion included, is one persistent kernel
(`CgKernels.cg_pipe_loop`, csrc/cg_pipe_loop.cu): one launch per solve and
one host read of its record, as the reference runs the loop as one device
program.  On the CPU, or with a plan that is not CgKernels itself (a
subclass that overrides a step), the loop runs on the host
(`cg_pipe_loop_plain` over the plan's KA and KB_pipe): the iteration
counter and the gating are host integers, γ, δ, α, β and ‖r‖₁ stay 0-d
device tensors that the kernels read through pointers, and the host reads
one bool per checked iteration.  Either way the check reads the ‖r‖₁ that
KA returns for the incoming r, and a converged check leaves before KB_pipe
without counting the pass — exactly the reference's α = 0 freeze.
"""

from __future__ import annotations

import functools

from ogl_tpu_torch.kernels.fused import CgKernels, cg_pipe_loop_plain
from ogl_tpu_torch.solve.cg import SolveResult
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

__all__ = ["cg_pipelined_fused"]


def cg_pipelined_fused(kern: CgKernels, data, b, x0, cfg, invd=None) -> SolveResult:
    """b, x0, invd: flat (n,) float32 tensors on kern's device; data:
    kern.pack_values(mat)."""
    x = x0.to(kern.dtype).clone()
    r = b - kern.apply(data, x)
    nf = merged_norm_factor(kern, data, r, x, b)
    # the exact type: subclasses that override a step keep the host loop
    if type(kern) is CgKernels and b.device.type == "cuda":
        iters, rn, init_rn, converged = kern.cg_pipe_loop(data, x, r, nf, cfg, invd)
    else:
        iters, rn, init_rn, converged = cg_pipe_loop_plain(
            functools.partial(kern.ka, data), kern.kb_pipe, x, r, nf, cfg, invd)
    return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                       converged=converged)
