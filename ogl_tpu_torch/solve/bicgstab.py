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

Where the matrix is Dia, Gdia, Xell, Ell, Hybrid, Csr (or a device Coo) or
Sell and the preconditioner `none`, scalar `BJ` or blocked `BJ` (maxBlockSize
2 to 32) (`why_not` None), the solver passes the format's plan (and, for a
blocked BJ, its transposed inverses `inv_t`): with the plan itself
(CgKernels, GdiaCgKernels, XellCgKernels, EllCgKernels, CsrCgKernels or
SellCgKernels, not a subclass that overrides a step) on CUDA tensors the
whole loop, criterion included, is one launch of the plan's
`bicgstab_gen_loop` (csrc/bicgstab_gen_loop.cu, whose two SpMV phases are
the format's SpMV body, and whose block-Jacobi phases are the body of
csrc/block_jacobi.cuh).  A refused launch
raises; there is no fallback to the host loop.  Everything else (the CPU,
ISAI, GISAI, the ILU family, Multigrid, a subclassed plan) runs the host
loop, `bicgstab_gen_loop_plain`
(kernels/fused.py), which is also the loop kernel's plain twin: host
integers for the count and the gating, 0-d device tensors for ρ, α, ω and
the sums, one bool read per checked iteration.  The check is at the top of
the iteration, on the carried r; when it says converged the loop breaks,
which gives the reference's iterate and count exactly (its α = ω = 0
freeze leaves x and r unchanged, and that pass is not counted).
"""

from __future__ import annotations

import torch

from ogl_tpu_torch.core.formats import Csr, Dia, Ell, Hybrid, Sell, format_name
from ogl_tpu_torch.kernels.fused import (CgKernels, GdiaCgKernels, bicgstab_gen_loop_plain,
                                         gen_check_sums)
from ogl_tpu_torch.kernels.gdia import Gdia
from ogl_tpu_torch.kernels.xell import Xell, XellCgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.kernels.block_jacobi import MAX_BLOCK
from ogl_tpu_torch.solve.cg import LOOP_PLANS, SolveResult, gather_why_not, precond_why_not
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["bicgstab", "why_not"]


def why_not(mat, precond_name: str, max_block_size: int = 1) -> str | None:
    """Why the general BiCGStab keeps the host loop on the matrix `mat` with
    the preconditioner named `precond_name` (BJ: of `max_block_size`), or
    None when the loop kernel takes the solve (the caller then passes the
    format's plan): on Dia, Gdia, Xell and the gather formats the general
    CG takes (solve/cg.py why_not), with `none`, scalar `BJ` or a blocked
    `BJ` of 2 to MAX_BLOCK rows (the loop's block-Jacobi phases).  ISAI,
    GISAI, the ILU family and Multigrid keep the host loop."""
    if not isinstance(mat, (Dia, Gdia, Xell, Ell, Hybrid, Csr, Sell)):
        return f"the {format_name(mat)} format (no loop kernel on this route)"
    if not (precond_name == "BJ" and 1 < max_block_size <= MAX_BLOCK):
        pc = precond_why_not(precond_name, max_block_size)
        if pc is not None:
            return pc
    return None if isinstance(mat, (Dia, Gdia, Xell)) else gather_why_not(mat)


def _safe_div(num, den):
    """num / den, or 0 where |den| ≤ small_of(dtype)² (the breakdown guard)."""
    tiny = stopping.small_of(num.dtype) ** 2
    return torch.where(den.abs() > tiny, num / torch.where(den == 0, 1.0, den), 0.0)


def bicgstab(ops: Ops, b, x0, cfg, kern=None, data=None, invd=None, inv_t=None) -> SolveResult:
    """kern, data: the matrix's plan and kern.pack_values(mat), where
    why_not is None (else None: the host loop); invd: the scalar Jacobi
    inverse diagonal when ops.precond is invd ⊙ ·, inv_t: the transposed
    block inverses when ops.precond is the block-Jacobi apply over them,
    both None with identity."""
    x = x0.to(b.dtype).clone()
    r = b - ops.matvec(x)
    r_hat = r.clone()  # fixed shadow residual (r's buffer takes every r')
    nf = stopping.initial_norm_factor(ops, r, x, b)
    absr, rho = gen_check_sums(ops, r, r_hat)
    # the exact types: subclasses that override a step keep the host loop
    if (type(kern) in (CgKernels, GdiaCgKernels, XellCgKernels, *LOOP_PLANS)
            and b.device.type == "cuda"):
        rec = kern.bicgstab_gen_loop(data, x, r, r_hat, rho, absr, nf, cfg, invd, inv_t)
    else:
        rec = bicgstab_gen_loop_plain(ops, x, r, r_hat, rho, absr, nf, cfg)
    iters, rn, init_rn, converged = rec
    return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                       converged=converged)
