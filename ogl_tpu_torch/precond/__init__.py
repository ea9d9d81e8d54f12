"""Preconditioners of the port.

Counterpart: ogl_tpu/precond/__init__.py.  The slice covers `none` and
scalar `BJ` (maxBlockSize 1); `build` raises NotImplementedError for every
other name, naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

from typing import Any, Callable

from ogl_tpu_torch.config import PrecondConfig
from ogl_tpu_torch.core.formats import Coo

__all__ = ["PrecondOp", "build", "block_jacobi", "VALID", "PORTED"]

VALID = ("none", "BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI", "Multigrid")
PORTED = ("none", "BJ")


class PrecondOp:
    """A preconditioner as (apply function, state): `state` holds the
    device tensors (invd for Jacobi), `apply_fn(state, r)` applies M⁻¹."""

    def __init__(self, apply_fn: Callable[[Any, Any], Any], state: Any):
        self.apply_fn = apply_fn
        self.state = state

    def bind(self, state):
        return lambda r: self.apply_fn(state, r)


from ogl_tpu_torch.precond.jacobi import block_jacobi  # noqa: E402


def build(cfg: PrecondConfig, coo: Coo, device) -> PrecondOp:
    """Factory mirroring init_preconditioner_impl (Preconditioner.H:83-351)
    for the ported names."""
    if cfg.name == "none":
        return PrecondOp(lambda s, r: r, ())
    if cfg.name == "BJ":
        return block_jacobi(coo, cfg.max_block_size, device)
    if cfg.name in VALID:
        item = "A11" if cfg.name == "Multigrid" else "A10"
        raise NotImplementedError(
            f"preconditioner {cfg.name} is not ported yet (ROADMAP.md {item})")
    raise ValueError(
        f"unsupported preconditioner: {cfg.name}\nValid choices: {', '.join(VALID)}")
