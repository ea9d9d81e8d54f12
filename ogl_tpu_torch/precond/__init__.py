"""Preconditioners of the port.

Counterpart: ogl_tpu/precond/__init__.py.  The port covers every name of
the reference: `none`, `BJ` (scalar, and blocked up to maxBlockSize 32:
precond/jacobi.py), `ISAI` and `GISAI` (precond/isai.py), `ILU`, `ILUT`,
`IRILU`, `IC` and `ICT` (precond/ilu.py; `triSolveSweeps`, `triSolve
exact`) and `Multigrid` (precond/amg.py); `build` raises
NotImplementedError for `precision bfloat16`, naming the ROADMAP.md item
that ports it.
`skipSorting false` sorts the COO row-major first, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core.formats import Coo

__all__ = ["PrecondOp", "build", "amg_of", "block_jacobi", "isai", "ilu0", "ilut", "ic0", "ict",
           "VALID"]

VALID = ("none", "BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI", "Multigrid")


class PrecondOp:
    """A preconditioner as (apply function, state): `state` holds the
    device tensors (invd for Jacobi, the levels for AMG, the factors for the
    ILU family), `apply_fn(state, r)` applies M⁻¹."""

    def __init__(self, apply_fn: Callable[[Any, Any], Any], state: Any):
        self.apply_fn = apply_fn
        self.state = state

    def __call__(self, r):
        return self.apply_fn(self.state, r)

    def bind(self, state):
        return lambda r: self.apply_fn(state, r)


from ogl_tpu_torch.precond import amg  # noqa: E402  (the module)
from ogl_tpu_torch.precond.ilu import ic0, ict, ilu0, ilut  # noqa: E402
from ogl_tpu_torch.precond.isai import isai  # noqa: E402
from ogl_tpu_torch.precond.jacobi import block_jacobi  # noqa: E402


def build(cfg: PrecondConfig, coo: Coo, device, verbose: int = 0) -> PrecondOp:
    """Factory mirroring init_preconditioner_impl (Preconditioner.H:83-351)
    for the ported names."""
    if cfg.value_precision == "bfloat16" and cfg.name != "none":
        raise NotImplementedError(
            "preconditioner precision bfloat16 (the state cast) is not ported yet "
            "(ROADMAP.md A10)")
    if verbose > 0 and cfg.name == "ICT":
        # the reference logs the knob and drops it (Preconditioner.H:201-204)
        print(f"Generate preconditioner ICT with approximate select "
              f"{int(cfg.approximate_select)} (log-only, as in the reference)")
    if verbose > 0 and cfg.name == "Multigrid":
        print(f"Generate preconditioner Multigrid MaxLevels {cfg.max_levels} "
              f"MinCoarseRows {cfg.min_coarse_rows} ZeroGuess "
              f"{int(cfg.zero_guess)} Cycle {cfg.cycle} "
              "(zeroGuess log-only, as in the reference)")
    if cfg.name == "none":
        return PrecondOp(lambda s, r: r, ())
    if not cfg.skip_sorting:
        import numpy as np

        rows, cols, vals = (np.asarray(a) for a in (coo.rows, coo.cols, coo.vals))
        order = np.lexsort((cols, rows))
        coo = Coo(rows=rows[order], cols=cols[order], vals=vals[order], shape=coo.shape)
    if cfg.name == "BJ":
        return block_jacobi(coo, cfg.max_block_size, device)
    if cfg.name == "ISAI":  # spd variant (Preconditioner.H:226-240)
        return isai(coo, device, sparsity_power=cfg.sparsity_power, spd=True)
    if cfg.name == "GISAI":  # general variant (:241-259)
        return isai(coo, device, sparsity_power=cfg.sparsity_power, spd=False)
    exact = cfg.tri_solve == "exact"
    if cfg.name == "ILU":
        return ilu0(coo, device, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if cfg.name == "ILUT":
        return ilut(coo, device, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if cfg.name == "IRILU":  # ILU with 5-step Richardson trisolves (:146-178)
        return ilu0(coo, device, sweeps=5)
    if cfg.name == "IC":
        return ic0(coo, device, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if cfg.name == "ICT":
        return ict(coo, device, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if cfg.name == "Multigrid":
        return amg_of(cfg, coo, device)
    raise ValueError(
        f"unsupported preconditioner: {cfg.name}\nValid choices: {', '.join(VALID)}")


def amg_of(cfg: PrecondConfig, coo: Coo, device) -> PrecondOp:
    """The AMG cycle with the Multigrid controls of `cfg` (also what
    GKOMultigrid iterates).  The smoother coefficients are packed in
    bfloat16, the reference's packing for its fused levels, unless
    `precision float32` keeps the state float32 — as the reference's state
    cast to float32 widens those packed blocks again."""
    smoother = torch.float32 if cfg.value_precision == "float32" else torch.bfloat16
    return amg.amg(coo, device, smoother_dtype=smoother, max_levels=cfg.max_levels,
                   min_coarse_rows=cfg.min_coarse_rows, cycle=cfg.cycle,
                   coarse_solver_iters=cfg.coarse_solver_iters,
                   aggregation=cfg.aggregation, width=cfg.coarsening_rate,
                   coarse_solver=cfg.coarse_solver, smooth_iters=cfg.smoother_sweeps)
