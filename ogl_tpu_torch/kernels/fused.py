"""Merged-Krylov and AMG-smoother kernels for the Dia (stencil) path: K1,
K2, K2i, KA, KB_pipe, K1B, KB_update, the smoother passes and the whole
merged CG, merged pipelined-CG, merged BiCGStab and general BiCGStab loops
in CUDA C++ (`csrc/cg_k1.cu`, `csrc/cg_k2.cu`, `csrc/cg_k2i.cu`,
`csrc/cg_pipe.cu`, `csrc/cg_kb_pipe.cu`, `csrc/bicgstab.cu`,
`csrc/bicgstab_kb_update.cu`, `csrc/cg_k2n.cu`, `csrc/amg_smooth.cu`,
`csrc/cg_loop.cu`, `csrc/cg_pipe_loop.cu`, `csrc/bicgstab_loop.cu`,
`csrc/bicgstab_gen_loop.cu`), each beside its plain PyTorch twin (the AMG
solves' own loop kernel, `csrc/amg_loop.cu`, is wrapped by
kernels/amg_loop.py).

Counterpart: ogl_tpu/kernels/fused.py (`CgKernels.k1`/`k2`/`k2i`/`k2n`/
`ka`/`kb_pipe`/`k1b`/`kb_update`/`ksweep`/`kresid`/`apply`/`pack_values`,
kernels `_k1_kernel`, `_k2_kernel`, `_k2i_kernel`, `_k2n_kernel`,
`_ka_kernel`, `_kb_pipe_kernel`, `_k1b_kernel`, `_kb_update_kernel`,
`_sweep_kernel`, `_resid_kernel`).  Two kernels per CG iteration:

  K1   p' = z + β·p ;  q = A p' ;  δ = Σ p'·q
  K2   x' = x + α·p' ;  r' = r − α·q ;  z' = invd ⊙ r' ;  ρ' = Σ r'·z' ;
       s = Σ|r'|          (the residual 1-norm of the criterion comes free)
  K2i  K2 for identity preconditioning (z ≡ r): no z write, no invd read,
       ρ' = Σ r'·r'
  K2n  K2 for a rich preconditioner (AMG): x', r' and s only — z and ρ
       come from the preconditioner's cycle
two per iteration of the pipelined (Chronopoulos–Gear) CG
(solve/cg_pipe_fused.py):
  KA       u = invd ⊙ r (or r) ;  w = A u ;  (γ = Σ r·u, δ = Σ w·u, ‖r‖₁)
  KB_pipe  p' = u + β·p ;  s' = w + β·s ;  x' = x + α·p' ;  r' = r − α·s'
three per iteration of the merged BiCGStab (solve/bicgstab_fused.py):
  K1B        w = a + ca·b + cb·c ;  q = A w ;  (Σ r̂·q, Σ q·w, Σ q·q)
  KB_update  x' = x + α·p + ω·s ;  r' = s − ω·t ;  (Σ r̂·r', ‖r'‖₁)
the whole merged CG loop on a Dia or a Gdia matrix, with identity or
scalar Jacobi preconditioning, as one persistent cooperative kernel
(`cg_loop`; no counterpart kernel — the reference runs K1, K2 or K2i and
the criterion inside one `jax.lax.while_loop`):
  each iteration the criterion on ‖r‖₁, β, K1 (the Dia or the Gdia row
  body), a grid barrier, K2 (Jacobi) or K2i (identity), a grid barrier;
  one launch per solve and one host read at its end
the whole merged pipelined-CG loop on a Dia matrix, with identity or
scalar Jacobi preconditioning, as a second persistent cooperative kernel
(`cg_pipe_loop`; the reference runs KA, KB_pipe and the criterion inside
one `jax.lax.while_loop`):
  each iteration KA (row body `csrc/cg_ka.cuh`), a grid barrier, the
  criterion on ‖r‖₁, α and β, KB_pipe (body `csrc/cg_kb_pipe.cuh`), a
  grid barrier
the whole merged BiCGStab loop on a Dia matrix (identity) as a third
(`bicgstab_loop`; the reference runs K1B twice, KB_update and the
criterion inside one `jax.lax.while_loop`):
  each iteration the criterion on ‖r‖₁, β, K1B (row body
  `csrc/bicgstab_k1b.cuh`), a grid barrier, α, K1B with b = c, a grid
  barrier, ω, KB_update (body `csrc/bicgstab_kb_update.cuh`), a grid
  barrier
the whole general BiCGStab loop (solve/bicgstab.py, `fusedBiCGStab` false)
on a Dia, a Gdia or (through kernels/xell.py `XellCgKernels`) an Xell
matrix with identity, scalar Jacobi or block-Jacobi preconditioning as a
fourth
(`bicgstab_gen_loop`; the reference runs two SpMVs, the elementwise passes,
the reductions and the criterion inside one `jax.lax.while_loop`):
  each iteration the criterion on ‖r‖₁, β, SpMV A (v' = A M⁻¹p' with p' =
  r + β·(p − ω·v) recomputed at each source; the Dia SpMV's row-quad body
  `csrc/dia_rows.cuh`, the Gdia one, `csrc/gdia_k1.cuh`, or the Xell band
  body, `csrc/xell_band.cuh`), a grid
  barrier, α, SpMV B (t = A M⁻¹s, s = r − α·v'), a grid barrier, ω, the
  update of x and r, a grid barrier; with block Jacobi (`inv_t`, bit
  LOOP_BLOCK_JACOBI) p' and y = M⁻¹p' are formed first over whole Jacobi
  blocks (the body `csrc/block_jacobi.cuh`) behind a barrier of their own,
  and s and z = M⁻¹s the same way before SpMV B: five barriers
and the AMG smoother's two passes, each one stencil apply:
  sweep  out = x + relax·invd ⊙ (b − A x)
  resid  out = b − A x
whose coefficients may be packed in bfloat16 (`pack_values(mat, dtype)`;
the reference's choice for its smoother operators): they are widened to
float32 in the kernel and sums accumulate in float32.  Their row body
(`csrc/amg_smooth.cuh`: row quads with 16- or 8-byte coefficient loads,
else rows) is also the smoothing phases of the device V-cycle.  `GdiaCgKernels`
(counterpart of the reference's class of that name, `_k1_gdia_kernel`) is
the same plan for a Gdia matrix: its K1 is the Gdia kernel of
kernels/gdia.py (`csrc/gdia.cu`, row body `csrc/gdia_k1.cuh`), K2/K2i/K2n
and the loop kernel are shared.

Layout: flat (n,) float32 vectors and a contiguous (nd, n) Dia data
tensor.  The reference's halo-framed (Rp + 2T, 128) layout exists for the
TPU's (8, 128) tiling and static DMA windows; the port has no frame, so
`frame`/`unframe` are dropped and every kernel masks i + off to [0, n)
itself.  Cross-block sums are one float32 partial per block, summed with
torch.sum outside the kernel — deterministic, no float atomics.

α, β, ω, ca and cb are 0-d float32 tensors on the device: the kernels
read them through a pointer, so a launch never waits for the host.
K2/K2i update x, r (and z) IN PLACE: every element is read and written by
the same program, so there is no race; the plain versions do the same.
K2n, KB_pipe (p, s, x, r) and KB_update (x, and r' into r) do too.  The
stencil passes cannot: they read their inputs at the neighbours of other
blocks, so they write buffers of their own, and the smoother passes and
K1B refuse an `out` that overlaps an operand.

Dispatch, the same for every wrapper: tensors on the CPU run the plain
version; CUDA tensors launch the kernel or raise (wrong device, dtype,
shape, contiguity, or a refused launch) — there is no fallback.  Each
launch counts in `ogl_tpu_torch.kernels.launches`.

K2 (`_k2_kernel`, 8 streams: x, r, p, q, invd in; x, r, z out), K2i
(`_k2i_kernel`, 6), K2n (`_k2n_kernel`, 6: x, r, p, q in; x, r out),
KB_pipe (`_kb_pipe_kernel`: 9 streams, 36 B, 10 with Jacobi) and KB_update
(`_kb_update_kernel`: 7 streams, 28 B) are CUDA C++ (`csrc/cg_k2.cu`,
`csrc/cg_k2i.cu`, `csrc/cg_k2n.cu`, `csrc/cg_kb_pipe.cu`,
`csrc/bicgstab_kb_update.cu`): their bodies are also phases of the loop
kernels.  Each runs on a grid-stride grid of row quads (float4, the last
quad of n % 4 ≠ 0 row by row where the kernel takes it) with one partial
per block and sum; bound: device-memory bandwidth at a handful of flops
per row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build, gdia
from ogl_tpu_torch.kernels.block_jacobi import block_jacobi_plain, check_inverses
from ogl_tpu_torch.kernels.dia_spmv import (THREADS, DiaPlan, check_operands,
                                            check_scalar, dia_spmv, dia_spmv_plain, on_cpu,
                                            persistent_launch, require_cuda, sm_count,
                                            stream_of)

__all__ = ["CgKernels", "GdiaCgKernels", "LOOP_JACOBI", "LOOP_GDIA", "LOOP_XELL", "LOOP_ELL",
           "LOOP_CSR", "LOOP_SELL", "LOOP_BLOCK_JACOBI", "gen_loop_precond",
           "gen_loop_preconditioner",
           "k1_plain",
           "k2_plain", "k2i_plain", "k2n_plain", "cg_loop_plain", "ka_plain", "kb_pipe_plain",
           "cg_pipe_loop_plain", "k1b_plain", "kb_update_plain", "bicgstab_loop_plain",
           "gen_check_sums", "gen_phase_a_plain", "gen_phase_b_plain", "gen_update_plain",
           "bicgstab_gen_loop_plain", "ksweep_plain", "kresid_plain", "SMOOTHER_DTYPES"]

# the grid cap of the standalone grid-stride kernels (K2, K2i, K2n, KB_pipe,
# K1B, KB_update), blocks of 256 per SM: one row quad per thread up to 8.4M rows
# (timed on the H100 in turns against 4, 8 and 16 per SM, which give each
# thread a loop of quads: level or faster)
K2_BLOCKS_PER_SM = 64
# threads per block of the loop kernels (csrc/cg_loop.cu, cg_pipe_loop.cu,
# bicgstab_loop.cu kMaxThreads)
LOOP_THREADS = 512
# the loop kernels' variant bits (csrc/cg_loop.cu, bicgstab_gen_loop.cu;
# cg_pipe_loop.cu and xell_cg_loop.cu take the first): scalar Jacobi, the
# Gdia apply, the Xell apply (bicgstab_gen_loop.cu), the Ell (and Hybrid)
# apply (kernels/ell.py), the Csr (and device Coo) apply and the Sell apply
# (kernels/gather_loop.py)
LOOP_JACOBI, LOOP_GDIA, LOOP_XELL, LOOP_ELL, LOOP_CSR, LOOP_SELL = 1, 2, 4, 8, 16, 32
# the general-BiCGStab loop's block-Jacobi variants (csrc/bicgstab_gen_loop.cu
# kBlockJacobi; not with LOOP_JACOBI): M⁻¹ the transposed block inverses inv_t
LOOP_BLOCK_JACOBI = 64
# coefficient types the smoother kernels take (csrc/amg_smooth.cu templates)
SMOOTHER_DTYPES = (torch.float32, torch.bfloat16)

# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def k1_plain(data, offsets, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p', δ = Σ p'·q."""
    pw = z + beta * p
    q = dia_spmv_plain(data, offsets, pw)
    return pw, q, torch.sum(pw * q)


def k2_plain(alpha, x, r, p, q, invd, z):
    """In place: x += α·p, r −= α·q, z = invd ⊙ r; returns (ρ, ‖r‖₁)."""
    x += alpha * p
    r -= alpha * q
    torch.mul(invd, r, out=z)
    return torch.sum(r * z), torch.sum(torch.abs(r))


def k2i_plain(alpha, x, r, p, q):
    """In place: x += α·p, r −= α·q; returns (ρ = Σ r·r, ‖r‖₁)."""
    x += alpha * p
    r -= alpha * q
    return torch.sum(r * r), torch.sum(torch.abs(r))


def cg_loop_plain(k1, x, r, rho, absr, nf, cfg, invd=None, z=None):
    """The loop kernel's function: the merged CG loop of solve/cg_fused.py
    with identity (invd and z None: k2i_plain) or scalar Jacobi (k2_plain)
    preconditioning over the plan's K1 — `k1(z, p, β) -> (p', q, δ)`, the
    Dia or the Gdia apply — from the set-up's x, r (z = invd ⊙ r), ρ = Σ r·z
    (Σ r·r), ‖r‖₁ and norm factor nf, with the criterion of
    solve/stopping.py (cfg: StoppingParams) read on the host at each check.
    x, r and z are updated in place; returns the kernel's record:
    (iterations, final and initial normalised residual, converged) — an int
    and three 0-d tensors."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    p, rho_old, zero = torch.zeros_like(x), torch.ones_like(nf), torch.zeros_like(nf)
    while st.iter < cfg.max_iter + cfg.frequency:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = zero if st.iter == 0 else rho / rho_old
        p, q, delta = k1(r if invd is None else z, p, beta)
        alpha, rho_old = rho / delta, rho
        if invd is None:
            rho, absr = k2i_plain(alpha, x, r, p, q)
        else:
            rho, absr = k2_plain(alpha, x, r, p, q, invd, z)
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


def k2n_plain(alpha, x, r, p, q):
    """In place: x += α·p, r −= α·q; returns ‖r‖₁."""
    x += alpha * p
    r -= alpha * q
    return torch.sum(torch.abs(r))


def ka_plain(data, offsets, r, invd=None):
    """(w, γ, δ, ‖r‖₁) with u = invd ⊙ r (r when invd is None), w = A u,
    γ = Σ r·u, δ = Σ w·u."""
    u = r if invd is None else invd * r
    w = dia_spmv_plain(data, offsets, u)
    return w, torch.sum(r * u), torch.sum(w * u), torch.sum(torch.abs(r))


def kb_pipe_plain(w, p, s, x, r, alpha, beta, invd=None):
    """In place: p = u + β·p, s = w + β·s, x += α·p, r −= α·s, with
    u = invd ⊙ r (r when invd is None) taken before r changes."""
    u = r if invd is None else invd * r
    torch.add(u, beta * p, out=p)
    torch.add(w, beta * s, out=s)
    x += alpha * p
    r -= alpha * s


def cg_pipe_loop_plain(ka, kb_pipe, x, r, nf, cfg, invd=None):
    """The pipelined loop kernel's function, and the host loop of
    solve/cg_pipe_fused.py: the merged pipelined CG over the plan's KA —
    `ka(r, invd) -> (w, γ, δ, ‖r‖₁)` — and KB_pipe — `kb_pipe(w, p, s, x, r,
    α, β, invd)`, in place — with identity (invd None) or scalar Jacobi
    preconditioning, from the set-up's x, r = b − A x and norm factor nf,
    with the criterion of solve/stopping.py (cfg: StoppingParams) read on
    the host at each check.  The check reads the ‖r‖₁ that KA returns for
    the incoming r; when it says converged the loop breaks before KB_pipe and
    does not count the pass — the reference's α = 0 freeze.  x and r are
    updated in place; returns (iterations, final and initial normalised
    residual, converged) — an int and three 0-d tensors."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    p, s = torch.zeros_like(x), torch.zeros_like(x)
    zero = torch.zeros_like(nf)
    gamma_old = alpha_old = torch.ones_like(nf)
    while st.iter < cfg.max_iter + cfg.frequency:
        w, gamma, delta, absr = ka(r, invd)
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        if st.iter == 0:
            beta, denom = zero, delta
        else:
            beta = gamma / gamma_old
            denom = delta - beta * gamma / alpha_old
        alpha = gamma / denom
        kb_pipe(w, p, s, x, r, alpha, beta, invd)
        gamma_old, alpha_old = gamma, alpha
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


def k1b_plain(data, offsets, a, b, c, rhat, ca, cb):
    """(w, q, Σ r̂·q, Σ q·w, Σ q·q) with w = a + ca·b + cb·c, q = A w."""
    w = a + ca * b + cb * c
    q = dia_spmv_plain(data, offsets, w)
    return w, q, torch.sum(rhat * q), torch.sum(q * w), torch.sum(q * q)


def kb_update_plain(x, p, s, t, rhat, alpha, omega, r):
    """In place: x = x + α·p + ω·s, r = s − ω·t; returns (Σ r̂·r, ‖r‖₁)."""
    x += alpha * p
    x += omega * s
    torch.sub(s, omega * t, out=r)
    return torch.sum(rhat * r), torch.sum(torch.abs(r))


def bicgstab_loop_plain(k1b, kb_update, x, r, rhat, rho, absr, nf, cfg):
    """The BiCGStab loop kernel's function, and the host loop of
    solve/bicgstab_fused.py: the merged BiCGStab over the plan's K1B —
    `k1b(a, b, c, r̂, ca, cb) -> (w, q, Σ r̂·q, Σ q·w, Σ q·q)` — and KB_update
    — `kb_update(x, p, s, t, r̂, α, ω, r) -> (Σ r̂·r', ‖r'‖₁)`, x in place and
    r' into r — from the set-up's x, r = b − A x, the shadow residual r̂ (a
    copy of r0), ρ = Σ r̂·r, ‖r‖₁ and norm factor nf, with the criterion of
    solve/stopping.py (cfg: StoppingParams) read on the host at each check.
    The check is at the top of the iteration on the carried ‖r‖₁; when it
    says converged the loop breaks before any phase and does not count the
    pass — the reference's α = ω = 0 freeze.  ρ, α, ω, β and the K1B
    coefficients stay 0-d tensors on x's device.  x and r are updated in
    place; returns (iterations, final and initial normalised residual,
    converged) — an int and three 0-d tensors."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module
    from ogl_tpu_torch.solve.bicgstab import _safe_div

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    p, v = torch.zeros_like(x), torch.zeros_like(x)
    zero = torch.zeros_like(nf)
    rho_old = alpha = omega = torch.ones_like(nf)
    while st.iter < cfg.max_iter + cfg.frequency:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = _safe_div(rho, rho_old) * _safe_div(alpha, omega)
        p, v, d_rv, _, _ = k1b(r, p, v, rhat, beta, -beta * omega)
        alpha = _safe_div(rho, d_rv)
        s, t, _, d_ts, d_tt = k1b(r, v, v, rhat, -alpha, zero)
        omega = _safe_div(d_ts, d_tt)
        rho_old = rho
        rho, absr = kb_update(x, p, s, t, rhat, alpha, omega, r)
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


def gen_check_sums(ops, r, rhat):
    """(‖r‖₁, Σ r̂·r): the general BiCGStab's check group, one stacked
    reduction (ops.allreduce)."""
    return ops.allreduce(torch.stack([torch.sum(torch.abs(r)), torch.sum(rhat * r)])).unbind()


def gen_phase_a_plain(ops, r, p, v, rhat, beta, omega):
    """Phase A of the general BiCGStab: (p', y, v', Σ r̂·v') with p' = r +
    β·(p − ω·v), y = M⁻¹p' (ops.precond) and v' = A y (ops.matvec)."""
    pn = r + beta * (p - omega * v)
    y = ops.precond(pn)
    vn = ops.matvec(y)
    return pn, y, vn, ops.dot(rhat, vn)


def gen_phase_b_plain(ops, r, v, alpha):
    """Phase B: (s, z, t, Σ t·s, Σ t·t) with s = r − α·v', z = M⁻¹s and t =
    A z; the two sums one stacked reduction."""
    s = r - alpha * v
    z = ops.precond(s)
    t = ops.matvec(z)
    ts, tt = ops.allreduce(torch.stack([torch.sum(t * s), torch.sum(t * t)])).unbind()
    return s, z, t, ts, tt


def gen_update_plain(ops, x, r, y, z, s, t, rhat, alpha, omega):
    """The update, in place: x = (x + α·y) + ω·z and r = s − ω·t into r's
    buffer; returns the next check's group (gen_check_sums)."""
    torch.add(x + alpha * y, omega * z, out=x)
    torch.sub(s, omega * t, out=r)
    return gen_check_sums(ops, r, rhat)


def gen_loop_precond(x, invd=None, inv_t=None):
    """The preconditioner of a general-BiCGStab loop on x's rows as its twin
    applies it: None (identity), invd ⊙ · (scalar Jacobi) or the
    block-Jacobi twin over the transposed block inverses inv_t, checked
    against x (kernels/block_jacobi.py check_inverses); invd and inv_t
    exclude each other."""
    if invd is not None and inv_t is not None:
        raise ValueError("bicgstab_gen_loop: invd (scalar Jacobi) and inv_t (block Jacobi) "
                         "exclude each other")
    if inv_t is not None:
        check_inverses(inv_t, x)
        return functools.partial(block_jacobi_plain, inv_t)
    return None if invd is None else (lambda w: invd * w)


def gen_loop_preconditioner(x, invd=None, inv_t=None):
    """The general-BiCGStab loop launch's preconditioner operands (invd and
    inv_t checked by gen_loop_precond): (variant bits, the pointer of invd
    or inv_t or None, the block size or 0, and the scratch vectors y and z
    the block-Jacobi variants write, or Nones)."""
    if inv_t is None:
        return ((0, None, 0, None, None) if invd is None
                else (LOOP_JACOBI, invd.data_ptr(), 0, None, None))
    return (LOOP_BLOCK_JACOBI, inv_t.data_ptr(), inv_t.shape[1], torch.empty_like(x),
            torch.empty_like(x))


def bicgstab_gen_loop_plain(ops, x, r, rhat, rho, absr, nf, cfg):
    """The general-BiCGStab loop kernel's function (csrc/bicgstab_gen_loop.cu)
    and the host loop of solve/bicgstab.py: the recurrence over the phase
    twins above on an Ops bundle (solve/krylov.py: the format's SpMV, any
    preconditioner; the kernel's are identity and invd ⊙ ·), from the
    set-up's x, r = b − A x, the shadow residual r̂ (a copy of r0), ρ = Σ r̂·r,
    ‖r‖₁ and norm factor nf, with the criterion of solve/stopping.py (cfg:
    StoppingParams) read on the host at each check.  The check is at the top
    of the iteration on the carried ‖r‖₁; when it says converged the loop
    breaks before any phase and does not count the pass — the reference's
    α = ω = 0 freeze.  It leaves at maxIter + frequency (maxIter already
    doubled by config).  ρ, α, ω and β stay 0-d tensors on x's device.  x
    and r are updated in place; returns (iterations, final and initial
    normalised residual, converged) — an int and three 0-d tensors."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module
    from ogl_tpu_torch.solve.bicgstab import _safe_div

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    p, v = torch.zeros_like(x), torch.zeros_like(x)
    rho_old = alpha = omega = torch.ones_like(nf)
    while st.iter < cfg.max_iter + cfg.frequency:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        beta = _safe_div(rho, rho_old) * _safe_div(alpha, omega)
        p, y, v, d_rv = gen_phase_a_plain(ops, r, p, v, rhat, beta, omega)
        alpha = _safe_div(rho, d_rv)
        s, z, t, d_ts, d_tt = gen_phase_b_plain(ops, r, v, alpha)
        omega = _safe_div(d_ts, d_tt)
        rho_old = rho
        absr, rho = gen_update_plain(ops, x, r, y, z, s, t, rhat, alpha, omega)
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


def kresid_plain(data, offsets, x, b):
    """b − A x; bfloat16 data is widened to float32 (x's type) before the
    products, as the kernel does."""
    return b - dia_spmv_plain(data.to(x.dtype), offsets, x)


def ksweep_plain(data, offsets, x, b, invd, relax):
    """x + relax·invd ⊙ (b − A x): one damped Jacobi sweep."""
    return x + relax * invd * kresid_plain(data, offsets, x, b)


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_no_overlap(what: str, out: torch.Tensor, *operands) -> None:
    """Raise if `out` shares memory with any operand (a smoother pass reads
    its operands while other blocks write `out`)."""
    lo, hi = _span(out)
    for t in operands:
        if t.device == out.device:
            a, b = _span(t)
            if a < hi and lo < b:
                raise ValueError(f"{what}: out overlaps an operand; it needs a "
                                 "buffer of its own")


def _ptr(t: torch.Tensor | None):
    """A tensor's device pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _read_record(record: torch.Tensor) -> tuple:
    """The one host read of a loop kernel's 4-word record (csrc/loop.cuh
    `write_record`): (iterations, final and initial normalised residual,
    converged) — an int and three 0-d CPU tensors."""
    host = record.cpu()
    return int(host.view(torch.int32)[0]), host[1], host[2], host[3] != 0


class CgKernels:
    """Merged-CG steps for one Dia sparsity on one device.

    Holds only static structure (the DiaPlan: n, offsets, device offsets),
    so one object serves every coefficient update; the values travel as
    the `data` argument.  Vectors are flat (n,) — the reference's
    `frame`/`unframe` are dropped."""

    def __init__(self, n: int, offsets, device: torch.device | str):
        self.plan = DiaPlan(n, offsets, device)
        self.n = self.plan.n
        self.offsets = self.plan.offsets
        self.device = self.plan.device
        self.dtype = torch.float32
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)
        # variant -> co-resident blocks of the loop kernel, of the pipelined
        # one, of the BiCGStab one
        self._loop_blocks: dict = {}
        self._pipe_loop_blocks: dict = {}
        self._bicgstab_loop_blocks: dict = {}
        self._gen_loop_blocks: dict = {}

    def pack_values(self, mat, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The Dia data as the kernels take it: contiguous (nd, n), float32
        unless `dtype` overrides the storage type (bfloat16 for the smoother
        operators: the smoother kernels widen it to float32 and halve the
        coefficient bytes they read)."""
        if tuple(mat.offsets) != self.offsets:
            raise ValueError("matrix offsets do not match this plan")
        return mat.data.to(dtype or self.dtype).contiguous()

    # ---- K1 (CUDA C++) -------------------------------------------------
    def k1(self, data, z, p, beta):
        """(p', q, δ) — p' and q in new buffers, δ a 0-d tensor."""
        if on_cpu(data, z, p, beta):
            return k1_plain(data, self.offsets, z, p, beta)
        require_cuda("k1", z)
        check_operands(self.plan, data, z, p)
        check_scalar("beta", beta, self.device)
        lib = _build.library()
        pout = torch.empty_like(p)
        q = torch.empty_like(p)
        grid = -(-self.n // THREADS)
        partials = torch.empty(grid, dtype=torch.float32, device=self.device)
        _build.check(lib.ogl_cg_k1(
            data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            z.data_ptr(), p.data_ptr(), beta.data_ptr(), pout.data_ptr(),
            q.data_ptr(), partials.data_ptr(), self.n, THREADS, grid,
            stream_of(z)), "cg_k1")
        kernels.launches["cg_k1"] += 1
        return pout, q, torch.sum(partials)

    def apply(self, data, x):
        """Plain y = A x through K1 (z = p = x, β = 0)."""
        _, q, _ = self.k1(data, x, x, self._zero)
        return q

    def spmv(self, data, x):
        """y = A x through the format's SpMV kernel (plain for CPU tensors)."""
        return dia_spmv(self.plan, data, x)

    # ---- K2, K2i, K2n (CUDA C++) -----------------------------------------
    def k2(self, alpha, x, r, p, q, invd, z):
        """In place on x, r, z; returns (ρ, ‖r‖₁) as 0-d tensors."""
        if on_cpu(alpha, x, r, p, q, invd, z):
            return k2_plain(alpha, x, r, p, q, invd, z)
        return self._launch_k2("k2", alpha, (x, r, p, q, invd, z))

    def k2i(self, alpha, x, r, p, q):
        """K2 for identity preconditioning, in place on x and r; returns
        (ρ = Σ r·r, ‖r‖₁) as 0-d tensors."""
        if on_cpu(alpha, x, r, p, q):
            return k2i_plain(alpha, x, r, p, q)
        return self._launch_k2("k2i", alpha, (x, r, p, q))

    def _launch_k2(self, what, alpha, vectors, sums=2):
        """Launch `ogl_cg_<what>` (csrc/cg_k2.cu, cg_k2i.cu, cg_k2n.cu) over
        `vectors` in its C argument order, on a grid of at most
        K2_BLOCKS_PER_SM blocks per SM, with the float4 branch where every
        vector allows it; returns its `sums` block sums ((ρ, ‖r‖₁), or
        (‖r‖₁,) for K2n)."""
        require_cuda(what, vectors[0])
        check_operands(self.plan, None, *vectors)
        check_scalar("alpha", alpha, self.device)
        vec, blocks = persistent_launch(self.n, [t.data_ptr() for t in vectors],
                                        sm_count(self.device.index),
                                        blocks_per_sm=K2_BLOCKS_PER_SM)
        partials = torch.empty((sums, blocks), dtype=torch.float32, device=self.device)
        entry = getattr(_build.library(), f"ogl_cg_{what}")
        _build.check(entry(alpha.data_ptr(), *(t.data_ptr() for t in vectors),
                           partials.data_ptr(), self.n, vec, blocks, stream_of(vectors[0])),
                     f"cg_{what}")
        kernels.launches[f"cg_{what}"] += 1
        return torch.sum(partials, dim=1).unbind()

    def k2n(self, alpha, x, r, p, q):
        """K2 without z and ρ (a rich preconditioner makes z), in place on
        x and r; returns ‖r‖₁ as a 0-d tensor."""
        if on_cpu(alpha, x, r, p, q):
            return k2n_plain(alpha, x, r, p, q)
        return self._launch_k2("k2n", alpha, (x, r, p, q), sums=1)[0]

    # ---- the whole merged CG loop (CUDA C++) -----------------------------
    def loop_blocks(self, variant: int = 0) -> int:
        """The co-resident blocks of LOOP_THREADS of the loop kernel's
        `variant` (LOOP_JACOBI | LOOP_GDIA bits) on this plan's card
        (occupancy × SMs), queried once per variant; raises on a card
        without cooperative launch."""
        return self._coop_blocks("cg_loop", self._loop_blocks, variant)

    def pipe_loop_blocks(self, variant: int = 0) -> int:
        """loop_blocks for the pipelined loop kernel (variant 0 or
        LOOP_JACOBI)."""
        return self._coop_blocks("cg_pipe_loop", self._pipe_loop_blocks, variant)

    def bicgstab_loop_blocks(self) -> int:
        """loop_blocks for the merged-BiCGStab loop kernel (one variant)."""
        return self._coop_blocks("bicgstab_loop", self._bicgstab_loop_blocks, 0)

    def gen_loop_blocks(self, variant: int = 0) -> int:
        """loop_blocks for the general-BiCGStab loop kernel (LOOP_JACOBI or
        LOOP_BLOCK_JACOBI, and LOOP_GDIA bits)."""
        return self._coop_blocks("bicgstab_gen_loop", self._gen_loop_blocks, variant)

    def _coop_blocks(self, kernel: str, cache: dict, variant: int) -> int:
        if variant not in cache:
            blocks = ctypes.c_int64()
            query = getattr(_build.library(), f"ogl_{kernel}_grid")
            with torch.cuda.device(self.device):
                _build.check(query(variant, LOOP_THREADS, ctypes.byref(blocks)),
                             f"{kernel} (occupancy query)")
            cache[variant] = blocks.value
        return cache[variant]

    def _loop_apply(self, data, vectors):
        """The loop kernel's apply for this plan, after checking `data` and
        `vectors` against it: (variant bits, (coef, lidx, offsets, nd,
        rows)) — the Dia data and offsets here."""
        check_operands(self.plan, data, *vectors)
        return 0, (data.data_ptr(), None, self.plan.offsets_dev.data_ptr(), len(self.offsets), 0)

    def cg_loop(self, data, x, r, rho, absr, nf, cfg, invd=None, z=None):
        """The merged CG loop from the set-up's state (solve/cg_fused.py):
        x and r (and, with Jacobi, z = invd ⊙ r), updated in place; ρ = Σ r·z
        (Σ r·r with identity: invd and z None), ‖r‖₁ and the norm factor as
        0-d tensors; cfg the StoppingParams.  One cooperative launch on the
        card, then one host read of its record; returns (iterations, final
        and initial normalised residual, converged) — an int and three 0-d
        CPU tensors."""
        if (invd is None) != (z is None):
            raise ValueError("cg_loop: invd and z come together (Jacobi) or not at all")
        coef = data if isinstance(data, tuple) else (data,)
        if on_cpu(*coef, x, r, rho, absr, nf, invd, z):
            return cg_loop_plain(functools.partial(self.k1, data), x, r, rho, absr, nf, cfg,
                                 invd, z)
        require_cuda("cg_loop", x)
        jacobi = invd is not None
        vectors = (x, r, z, invd) if jacobi else (x, r)
        variant, apply = self._loop_apply(data, vectors)
        variant |= LOOP_JACOBI if jacobi else 0
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        blocks = min(self.loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, pn, q = torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(self.n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                          for t in (*vectors, p, pn, q)))
        _build.check(_build.library().ogl_cg_loop(
            variant, *apply, x.data_ptr(), r.data_ptr(), z.data_ptr() if jacobi else None,
            invd.data_ptr() if jacobi else None, p.data_ptr(), pn.data_ptr(), q.data_ptr(),
            rho.data_ptr(), absr.data_ptr(), nf.data_ptr(), partials.data_ptr(),
            record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter,
            cfg.max_iter, cfg.frequency, vec, LOOP_THREADS, blocks, stream_of(x)), "cg_loop")
        kernels.launches["cg_loop"] += 1
        return _read_record(record)

    # ---- pipelined CG: KA, KB_pipe and the whole loop (CUDA C++) --------
    def ka(self, data, r, invd=None):
        """(w, γ, δ, ‖r‖₁): u = invd ⊙ r (r when invd is None), w = A u in a
        new buffer, γ = Σ r·u, δ = Σ w·u and ‖r‖₁ as 0-d tensors."""
        if on_cpu(data, r, invd):
            return ka_plain(data, self.offsets, r, invd)
        require_cuda("ka", r)
        check_operands(self.plan, data, r, *(() if invd is None else (invd,)))
        lib = _build.library()
        w = torch.empty_like(r)
        grid = -(-self.n // THREADS)
        partials = torch.empty((3, grid), dtype=torch.float32, device=self.device)
        _build.check(lib.ogl_cg_ka(
            data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            r.data_ptr(), None if invd is None else invd.data_ptr(), w.data_ptr(),
            partials.data_ptr(), self.n, THREADS, grid, stream_of(r)), "cg_ka")
        kernels.launches["cg_ka"] += 1
        return (w, *torch.sum(partials, dim=1).unbind())

    def kb_pipe(self, w, p, s, x, r, alpha, beta, invd=None):
        """In place on p, s, x and r: p = u + β·p, s = w + β·s, x += α·p,
        r −= α·s, with u = invd ⊙ r (r when invd is None)."""
        if on_cpu(w, p, s, x, r, alpha, beta, invd):
            return kb_pipe_plain(w, p, s, x, r, alpha, beta, invd)
        require_cuda("kb_pipe", w)
        vectors = (w, p, s, x, r) if invd is None else (w, p, s, x, r, invd)
        check_operands(self.plan, None, *vectors)
        check_scalar("alpha", alpha, self.device)
        check_scalar("beta", beta, self.device)
        vec, blocks = persistent_launch(self.n, [t.data_ptr() for t in vectors],
                                        sm_count(self.device.index),
                                        blocks_per_sm=K2_BLOCKS_PER_SM, tail=True)
        _build.check(_build.library().ogl_cg_kb_pipe(
            alpha.data_ptr(), beta.data_ptr(), *(t.data_ptr() for t in vectors[:5]),
            None if invd is None else invd.data_ptr(), self.n, vec, blocks, stream_of(w)),
            "cg_kb_pipe")
        kernels.launches["cg_kb_pipe"] += 1

    def cg_pipe_loop(self, data, x, r, nf, cfg, invd=None):
        """The merged pipelined CG loop from the set-up's state
        (solve/cg_pipe_fused.py): x and r = b − A x, updated in place; the
        norm factor as a 0-d tensor; invd the Jacobi inverse diagonal (None:
        identity); cfg the StoppingParams.  One cooperative launch on the
        card, then one host read of its record; returns (iterations, final
        and initial normalised residual, converged) — an int and three 0-d
        CPU tensors."""
        if on_cpu(data, x, r, nf, invd):
            return cg_pipe_loop_plain(functools.partial(self.ka, data), self.kb_pipe, x, r, nf,
                                      cfg, invd)
        require_cuda("cg_pipe_loop", x)
        jacobi = invd is not None
        vectors = (x, r, invd) if jacobi else (x, r)
        check_operands(self.plan, data, *vectors)
        check_scalar("nf", nf, self.device)
        variant = LOOP_JACOBI if jacobi else 0
        blocks = min(self.pipe_loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, s, w = torch.zeros_like(x), torch.zeros_like(x), torch.empty_like(x)
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(all(t.data_ptr() % 16 == 0 for t in (*vectors, p, s, w)))
        _build.check(_build.library().ogl_cg_pipe_loop(
            variant, data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            invd.data_ptr() if jacobi else None, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            s.data_ptr(), w.data_ptr(), nf.data_ptr(), partials.data_ptr(), record.data_ptr(),
            self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter, cfg.frequency, vec,
            LOOP_THREADS, blocks, stream_of(x)), "cg_pipe_loop")
        kernels.launches["cg_pipe_loop"] += 1
        return _read_record(record)

    # ---- merged BiCGStab: K1B, KB_update and the whole loop (CUDA C++) --
    def k1b(self, data, a, b, c, rhat, ca, cb, out=None):
        """(w, q, Σ r̂·q, Σ q·w, Σ q·q) with w = a + ca·b + cb·c, q = A w.
        w and q go into new buffers, or into `out` = (w, q), which must not
        overlap an operand: other blocks read a, b and c at the neighbours.
        b and c may be one tensor (the kernel then reads it once)."""
        if out is not None:
            _check_no_overlap("k1b", out[0], data, a, b, c, rhat, out[1])
            _check_no_overlap("k1b", out[1], data, a, b, c, rhat)
        if on_cpu(data, a, b, c, rhat, ca, cb, *(out or ())):
            res = k1b_plain(data, self.offsets, a, b, c, rhat, ca, cb)
            if out is None:
                return res
            return (out[0].copy_(res[0]), out[1].copy_(res[1]), *res[2:])
        require_cuda("k1b", a)
        w, q = out if out is not None else (torch.empty_like(a), torch.empty_like(a))
        check_operands(self.plan, data, a, b, c, rhat, w, q)
        check_scalar("ca", ca, self.device)
        check_scalar("cb", cb, self.device)
        vec, blocks = persistent_launch(self.n, [t.data_ptr() for t in (data, a, b, c, rhat, w, q)],
                                        sm_count(self.device.index),
                                        blocks_per_sm=K2_BLOCKS_PER_SM)
        partials = torch.empty((3, blocks), dtype=torch.float32, device=self.device)
        _build.check(_build.library().ogl_bicgstab_k1b(
            data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), rhat.data_ptr(), ca.data_ptr(),
            cb.data_ptr(), w.data_ptr(), q.data_ptr(), partials.data_ptr(), self.n, vec,
            blocks, stream_of(a)), "bicgstab_k1b")
        kernels.launches["bicgstab_k1b"] += 1
        return (w, q, *torch.sum(partials, dim=1).unbind())

    def kb_update(self, x, p, s, t, rhat, alpha, omega, r):
        """In place: x = x + α·p + ω·s, and r' = s − ω·t into `r` (a buffer
        the iteration no longer reads); returns (Σ r̂·r', ‖r'‖₁) as 0-d
        tensors."""
        if on_cpu(x, p, s, t, rhat, alpha, omega, r):
            return kb_update_plain(x, p, s, t, rhat, alpha, omega, r)
        require_cuda("kb_update", x)
        vectors = (x, p, s, t, rhat, r)
        check_operands(self.plan, None, *vectors)
        check_scalar("alpha", alpha, self.device)
        check_scalar("omega", omega, self.device)
        vec, blocks = persistent_launch(self.n, [v.data_ptr() for v in vectors],
                                        sm_count(self.device.index),
                                        blocks_per_sm=K2_BLOCKS_PER_SM, tail=True)
        partials = torch.empty((2, blocks), dtype=torch.float32, device=self.device)
        _build.check(_build.library().ogl_bicgstab_kb_update(
            alpha.data_ptr(), omega.data_ptr(), *(v.data_ptr() for v in vectors),
            partials.data_ptr(), self.n, vec, blocks, stream_of(x)), "bicgstab_kb_update")
        kernels.launches["bicgstab_kb_update"] += 1
        return torch.sum(partials, dim=1).unbind()

    def bicgstab_loop(self, data, x, r, rhat, rho, absr, nf, cfg):
        """The merged BiCGStab loop from the set-up's state
        (solve/bicgstab_fused.py): x and r = b − A x, updated in place; the
        shadow residual r̂; ρ = Σ r̂·r, ‖r‖₁ and the norm factor as 0-d
        tensors; cfg the StoppingParams.  One cooperative launch on the
        card, then one host read of its record; returns (iterations, final
        and initial normalised residual, converged) — an int and three 0-d
        CPU tensors."""
        if on_cpu(data, x, r, rhat, rho, absr, nf):
            return bicgstab_loop_plain(functools.partial(self.k1b, data), self.kb_update, x, r,
                                       rhat, rho, absr, nf, cfg)
        require_cuda("bicgstab_loop", x)
        check_operands(self.plan, data, x, r, rhat)
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        blocks = min(self.bicgstab_loop_blocks(), -(-self.n // LOOP_THREADS))
        p, v = torch.zeros_like(x), torch.zeros_like(x)
        pn, vn, s, t = (torch.empty_like(x) for _ in range(4))
        partials = torch.empty(5 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(self.n % 4 == 0 and all(u.data_ptr() % 16 == 0
                                          for u in (data, rhat, x, r, p, pn, v, vn, s, t)))
        _build.check(_build.library().ogl_bicgstab_loop(
            data.data_ptr(), self.plan.offsets_dev.data_ptr(), len(self.offsets),
            rhat.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), pn.data_ptr(),
            v.data_ptr(), vn.data_ptr(), s.data_ptr(), t.data_ptr(), rho.data_ptr(),
            absr.data_ptr(), nf.data_ptr(), partials.data_ptr(), record.data_ptr(), self.n,
            cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter, cfg.frequency, vec,
            LOOP_THREADS, blocks, stream_of(x)), "bicgstab_loop")
        kernels.launches["bicgstab_loop"] += 1
        return _read_record(record)

    # ---- the general BiCGStab: the whole loop (CUDA C++) ------------------
    def bicgstab_gen_loop(self, data, x, r, rhat, rho, absr, nf, cfg, invd=None, inv_t=None):
        """The general BiCGStab loop of solve/bicgstab.py from its set-up: x
        and r = b − A x, updated in place; the shadow residual r̂ (a copy of
        r0); ρ = Σ r̂·r, ‖r‖₁ and the norm factor as 0-d tensors; cfg the
        StoppingParams; invd the Jacobi inverse diagonal, or inv_t the
        transposed block-Jacobi inverses (ceil(n / bs), bs, bs) (both None:
        identity).  One cooperative launch on the card
        (csrc/bicgstab_gen_loop.cu, its two SpMV phases the format's row
        body, with inv_t its two block-Jacobi phases), then one host read of
        its record; returns (iterations, final and initial normalised
        residual, converged) — an int and three 0-d CPU tensors."""
        coef = data if isinstance(data, tuple) else (data,)
        pc = gen_loop_precond(x, invd, inv_t)
        if on_cpu(*coef, x, r, rhat, rho, absr, nf, invd, inv_t):
            from ogl_tpu_torch.solve.krylov import single_device_ops  # solve imports this module
            ops = single_device_ops(functools.partial(self.spmv, data), self.n, precond=pc)
            return bicgstab_gen_loop_plain(ops, x, r, rhat, rho, absr, nf, cfg)
        require_cuda("bicgstab_gen_loop", x)
        vectors = (x, r, rhat) if invd is None else (x, r, rhat, invd)
        variant, apply = self._loop_apply(data, vectors)
        gdia_v = bool(variant & LOOP_GDIA)
        bits, pc_ptr, bs, y, z = gen_loop_preconditioner(x, invd, inv_t)
        variant |= bits
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        blocks = min(self.gen_loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, v = torch.zeros_like(x), torch.zeros_like(x)
        pn, vn, s, t = (torch.empty_like(x) for _ in range(4))
        partials = torch.empty(5 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        streams = (*vectors, p, pn, v, vn, s, t, *(() if y is None else (y, z)),
                   *(() if gdia_v else coef))
        vec = int((gdia_v or self.n % 4 == 0) and all(u.data_ptr() % 16 == 0 for u in streams))
        _build.check(_build.library().ogl_bicgstab_gen_loop(
            variant, *apply, pc_ptr, bs, rhat.data_ptr(), x.data_ptr(), r.data_ptr(),
            p.data_ptr(), pn.data_ptr(), v.data_ptr(), vn.data_ptr(), s.data_ptr(), t.data_ptr(),
            _ptr(y), _ptr(z), rho.data_ptr(), absr.data_ptr(), nf.data_ptr(), partials.data_ptr(),
            record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter,
            cfg.frequency, vec, LOOP_THREADS, blocks, stream_of(x)), "bicgstab_gen_loop")
        kernels.launches["bicgstab_gen_loop"] += 1
        return _read_record(record)

    # ---- AMG smoother passes (CUDA C++) --------------------------------
    def ksweep(self, data, x, b, invd, relax: float, out=None):
        """One damped Jacobi sweep x + relax·invd ⊙ (b − A x), into `out`
        (a new buffer when None; never one overlapping an operand)."""
        if out is not None:
            _check_no_overlap("ksweep", out, data, x, b, invd)
        if on_cpu(data, x, b, invd, out):
            y = ksweep_plain(data, self.offsets, x, b, invd, relax)
            return y if out is None else out.copy_(y)
        return self._launch_smooth("amg_sweep", data, x, b, invd, relax, out)

    def kresid(self, data, x, b, out=None):
        """The residual b − A x, into `out` as ksweep."""
        if out is not None:
            _check_no_overlap("kresid", out, data, x, b)
        if on_cpu(data, x, b, out):
            y = kresid_plain(data, self.offsets, x, b)
            return y if out is None else out.copy_(y)
        return self._launch_smooth("amg_resid", data, x, b, None, 0.0, out)

    def _launch_smooth(self, name, data, x, b, invd, relax, out):
        require_cuda(name, x)
        out = torch.empty_like(x) if out is None else out
        vectors = (x, b, out) if invd is None else (x, b, invd, out)
        check_operands(self.plan, data, *vectors, data_dtypes=SMOOTHER_DTYPES)
        lib = _build.library()
        common = (data.data_ptr(), int(data.dtype == torch.bfloat16),
                  self.plan.offsets_dev.data_ptr(), len(self.offsets),
                  x.data_ptr(), b.data_ptr())
        tail = (out.data_ptr(), self.n, THREADS, stream_of(x))
        if invd is None:
            code = lib.ogl_amg_resid(*common, *tail)
        else:
            code = lib.ogl_amg_sweep(*common, invd.data_ptr(), float(relax), *tail)
        _build.check(code, name)
        kernels.launches[name] += 1
        return out


class GdiaCgKernels(CgKernels):
    """Merged-CG steps for one Gdia sparsity: K1 is the Gdia kernel
    (`csrc/gdia.cu` `ogl_gdia_k1`, launched through kernels/gdia.py
    `gdia_k1`); K2, K2i and K2n are the structure-free kernels of
    CgKernels, and the loop kernel runs its Gdia variants (the K1 phase
    from `csrc/gdia_k1.cuh`).  Packed coefficients are a (vals, lidx) pair.
    The Dia smoother passes are not for a Gdia matrix: a Gdia AMG level
    smooths through kernels/amg_level.py `GdiaSmoother`."""

    def __init__(self, n: int, plane_offsets, device: torch.device | str):
        super().__init__(n, (), device)
        self.gplan = gdia.GdiaPlan(n, plane_offsets, self.device)
        self.plane_offsets = self.gplan.plane_offsets

    def pack_values(self, mat, dtype: torch.dtype | None = None) -> tuple:
        if tuple(mat.plane_offsets) != self.plane_offsets:
            raise ValueError("matrix plane offsets do not match this plan")
        return mat.vals.to(dtype or self.dtype).contiguous(), mat.lidx

    def k1(self, data, z, p, beta):
        """(p', q, δ) — p' and q in new buffers, δ a 0-d tensor."""
        return gdia.gdia_k1(self.gplan, *data, z, p, beta)

    def spmv(self, data, x):
        return gdia.gdia_spmv(self.gplan, *data, x)

    def _loop_apply(self, data, vectors):
        vals, lidx = data
        gdia.check_operands(self.gplan, vals, lidx, *vectors)
        return LOOP_GDIA, (vals.data_ptr(), lidx.data_ptr(), self.gplan.offsets_dev.data_ptr(),
                           len(self.plane_offsets), self.gplan.r)
