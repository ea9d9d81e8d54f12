"""Preconditioned conjugate gradients on an `Ops` bundle.

Counterpart: ogl_tpu/solve/cg.py.  The same recurrences and the same
OpenFOAM criterion, checked before each update; the loop runs on the host
(the reference runs it as one device program) and reads one bool from the
device per checked iteration.  It is the `fusedCG false` route of the foam
layer and the independent solver the merged-kernel path is checked
against.  Its SpMV is whatever `ops.matvec` is — the Dia SpMV kernel on
the foam path.

Where the matrix is Ell, Hybrid, Csr (or a device Coo) or Sell and the
preconditioner `none` or scalar `BJ` (`why_not` None; a blocked BJ, ISAI,
GISAI, the ILU family or Multigrid keeps the CG's host loop, ops.precond),
the solver passes the format's plan: with the plan itself (kernels/ell.py
`EllCgKernels`, kernels/gather_loop.py `CsrCgKernels`, `SellCgKernels`, not
a subclass) on CUDA tensors, the set-up below runs as ever and the whole
loop, criterion included, is then one launch of its `cg_loop`
(csrc/cg_loop.cu's variant of the format). That loop computes this one's
values in the merged order of solve/cg_fused.py: ρ and ‖r‖₁ come from the
update of r (K2), z, p and q = A p from one phase (K1), so only the order
of the reductions differs. With Multigrid (`precond`, the AmgOp) on an Ell,
Hybrid, Csr or device-Coo plan, a hierarchy the device V-cycle takes
(kernels/amg_loop.py `takes_loop`) runs the whole solve as one launch of
`amg_cg_loop` (csrc/amg_loop.cuh, the plan's K1 phase), in the same merged
order after the same set-up. A refused launch raises. Everything else runs
the host loop below.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ogl_tpu_torch.core.formats import Csr, Ell, Hybrid, Sell, format_name
from ogl_tpu_torch.kernels import amg_loop
from ogl_tpu_torch.kernels.ell import EllCgKernels
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels
from ogl_tpu_torch.kernels.gather_spmv import CSR_GROUP_FROM, csr_group
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["cg", "SolveResult", "why_not", "precond_why_not", "gather_why_not", "LOOP_PLANS"]

# the plans of the gather formats' loop kernels, by the matrix's exact type
# (a DeviceCoo is a Csr by its storage)
LOOP_PLANS = (EllCgKernels, CsrCgKernels, SellCgKernels)


class SolveResult(NamedTuple):
    x: Any
    iters: int  # number of solver updates performed
    init_res_norm: Any  # 0-d tensor
    final_res_norm: Any  # residual at the last criterion check (0-d)
    converged: Any  # 0-d bool tensor: tolerance criteria met


def precond_why_not(precond_name: str, max_block_size: int = 1) -> str | None:
    """Why a loop kernel cannot take the preconditioner, or None: the CG
    loops' phases apply identity or scalar Jacobi (invd ⊙ r) only, so a
    blocked BJ (its block-Jacobi kernel), ISAI and GISAI (SpMVs of M), the
    ILU family (its triangular kernels) and Multigrid keep the host loop.  The general BiCGStab's loop kernel also
    takes a blocked BJ (solve/bicgstab.py why_not)."""
    if precond_name not in ("none", "BJ"):
        return f"preconditioner {precond_name}"
    if precond_name == "BJ" and max_block_size != 1:
        return f"BJ maxBlockSize {max_block_size} > 1 (the loops' Jacobi phase is scalar)"
    return None


def why_not(mat, precond_name: str, max_block_size: int = 1) -> str | None:
    """Why the general CG keeps the host loop on the matrix `mat` with the
    preconditioner named `precond_name` (BJ: of `max_block_size`), or None
    when the loop kernel takes the solve (the caller then passes the
    format's plan).  The gather formats (Ell, Hybrid, Csr, a device Coo,
    Sell) have loop kernels; a Csr whose SpMV takes more than one lane per
    row keeps the host loop, since the loop phases walk one lane per row.
    Dia, Gdia and Xell take the merged route (solve/cg_fused.py) instead."""
    if not isinstance(mat, (Ell, Hybrid, Csr, Sell)):
        return f"the {format_name(mat)} format (no loop kernel on this route)"
    return precond_why_not(precond_name, max_block_size) or gather_why_not(mat)


def gather_why_not(mat) -> str | None:
    """Why a gather-format matrix has no loop plan, or None: a Csr whose SpMV
    takes more than one lane per row (the loop phases walk one)."""
    if isinstance(mat, Csr) and csr_group(mat.shape[0], mat.nnz) > 1:
        return (f"the {format_name(mat)} format at {mat.nnz / mat.shape[0]:.1f} entries per "
                f"row on mean: from {CSR_GROUP_FROM} its SpMV takes "
                f"{csr_group(mat.shape[0], mat.nnz)} lanes per row, and the loop phases walk "
                "one")
    return None


def cg(ops: Ops, b, x0, cfg, kern=None, data=None, invd=None, precond=None) -> SolveResult:
    """kern, data: the matrix's plan and kern.pack_values(mat), where
    why_not is None or, with Multigrid, the device V-cycle may take the
    plan (else None: the host loop); invd: the scalar Jacobi inverse
    diagonal when ops.precond is invd ⊙ ·, None with identity; precond: the
    AmgOp that ops.precond applies, with Multigrid."""
    dtype = b.dtype
    x = x0.to(dtype).clone()
    r = b - ops.matvec(x)
    nf = stopping.initial_norm_factor(ops, r, x, b)
    if precond is not None:
        if amg_loop.takes_loop(kern, precond, b):
            iters, rn, init_rn, converged = amg_loop.amg_cg_loop(
                kern, data, precond, x, r, torch.sum(torch.abs(r)), nf, cfg)
            return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                               converged=converged)
    # the exact type: a subclass that overrides a step keeps the host loop
    elif type(kern) in LOOP_PLANS and b.device.type == "cuda":
        z = r if invd is None else invd * r
        iters, rn, init_rn, converged = kern.cg_loop(
            data, x, r, torch.sum(r * z), torch.sum(torch.abs(r)), nf, cfg, invd=invd,
            z=None if invd is None else z)
        return SolveResult(x=x, iters=iters, init_res_norm=init_rn, final_res_norm=rn,
                           converged=converged)
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
