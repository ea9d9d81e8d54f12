"""OpenFOAM-compatible stopping criterion.

Counterpart: ogl_tpu/solve/stopping.py, which carries the criterion as
loop state inside one compiled device program.  So does the port's CG loop
kernel (kernels/csrc/cg_loop.cu, the `none` solve on Dia on the card),
which evaluates the same gating and test in float32 on the device.  The
port's other loops run on the host, so the split is:

  * host integers: the iteration counter and the minIter/frequency gating
    (`would_check`) — they depend only on the iteration index;
  * 0-d device tensors: the norm factor, the initial and last normalised
    residuals, and every comparison against the tolerances;
  * one host read per CHECKED iteration: the bool that says stop.

Semantics mirrored exactly (reference StoppingCriterion.C):
  * norm factor (:32-69): with x̄ = mean(x0) broadcast as a constant vector
    and Axref = A x̄,  nf = ‖ |r − (b − Axref)| + |b − Axref| ‖₁ + SMALL,
    evaluated once on the initial state;
  * gating (:77-87): no check while 0 < iter < minIter, and only every
    `frequency`-th iteration;
  * stop when iter ≥ maxIter, res < tolerance, or relTol > 0 and
    res < relTol · initial-res (:123-135).
OpenFOAM's SMALL is precision-dependent (1e-15 double / 1e-6 single).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ogl_tpu_torch.config import StoppingConfig
from ogl_tpu_torch.solve.krylov import Ops

__all__ = ["StoppingParams", "StopState", "init_state", "would_check", "check",
           "check_from_norm", "initial_norm_factor", "satisfied", "small_of"]


def small_of(dtype) -> float:
    if isinstance(dtype, torch.dtype):
        return 1e-15 if dtype.itemsize >= 8 else 1e-6
    return 1e-15 if np.dtype(dtype).itemsize >= 8 else 1e-6


@dataclasses.dataclass(frozen=True)
class StoppingParams:
    """The runtime stopping controls of one solve (adaptMinIter changes
    minIter/frequency between solves)."""

    tolerance: float
    rel_tol: float
    min_iter: int
    max_iter: int
    frequency: int

    @staticmethod
    def of(cfg: StoppingConfig) -> "StoppingParams":
        return StoppingParams(
            tolerance=cfg.tolerance,
            rel_tol=cfg.rel_tol,
            min_iter=cfg.min_iter,
            max_iter=cfg.max_iter,
            frequency=cfg.frequency,
        )


@dataclasses.dataclass(frozen=True)
class StopState:
    iter: int  # number of completed solver updates (host)
    converged: bool  # loop-exit flag, read from the device at a check
    norm_factor: Any  # 0-d device tensor
    init_res_norm: Any  # normalised initial residual (0-d)
    res_norm: Any  # normalised residual at the last check (0-d)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(dtype, device) -> StopState:
    zero = torch.zeros((), dtype=dtype, device=device)
    return StopState(iter=0, converged=False,
                     norm_factor=torch.ones((), dtype=dtype, device=device),
                     init_res_norm=zero, res_norm=zero)


def would_check(cfg, it: int) -> bool:
    """The gating predicate (StoppingCriterion.C:77-87), on host ints."""
    skip_min = 0 < it < cfg.min_iter
    skip_freq = it % cfg.frequency != 0
    return not (skip_min or skip_freq)


def _norm_factor(ops: Ops, r, x, b):
    xavg = ops.mean(x)
    axref = ops.matvec(torch.ones_like(x) * xavg)
    b_sub = b - axref
    nf = ops.norm1(torch.abs(r - b_sub) + torch.abs(b_sub))
    return nf + small_of(r.dtype)


def initial_norm_factor(ops: Ops, r0, x0, b):
    """The OpenFOAM norm factor on the initial state (StoppingCriterion.C:
    32-69), hoisted out of the loop so the in-loop criterion can use the
    1-norm the iteration already produced (check_from_norm)."""
    return _norm_factor(ops, r0, x0, b)


def _hit(cfg, st: StopState, rn):
    hit = rn < cfg.tolerance
    if cfg.rel_tol > 0:
        hit = hit | (rn < cfg.rel_tol * st.init_res_norm)
    return hit


def check_from_norm(cfg, state: StopState, absr) -> StopState:
    """One criterion evaluation from the raw residual 1-norm (a 0-d
    tensor).  Gated iterations return `state` untouched and read nothing;
    a checked iteration reads ONE bool from the device."""
    it = state.iter
    if not would_check(cfg, it):
        return state
    rn = (absr / state.norm_factor).to(state.res_norm.dtype)
    st = state.replace(res_norm=rn, init_res_norm=rn if it == 0 else state.init_res_norm)
    if it >= cfg.max_iter:
        return st.replace(converged=True)
    return st.replace(converged=bool(_hit(cfg, st, rn)))


def check(ops: Ops, cfg, state: StopState, r) -> StopState:
    """check_from_norm on a residual vector (the general solvers)."""
    if not would_check(cfg, state.iter):
        return state
    return check_from_norm(cfg, state, ops.norm1(r))


def satisfied(cfg, state: StopState) -> torch.Tensor:
    """TRUE convergence (tolerance criteria met) for solverPerformance, as
    a 0-d bool tensor.  StopState.converged is the loop-exit flag, also
    raised on maxIter exhaustion; OpenFOAM reports converged=false when a
    solve merely ran out of iterations."""
    return _hit(cfg, state, state.res_norm)
