"""Named solver classes — the reference's registered solver surface.

Counterpart: ogl_tpu/foam/api.py.  GKOCG, GKOBiCGStab, GKOGMRES and
GKOMultigrid are ported; GKOCG registers for symmetric matrices only (reference
GKOCG.C:16), GKOBiCGStab for both (the reference's sym and asym tables),
checked on LduMatrix.symmetric.
"""

from __future__ import annotations

from ogl_tpu_torch.core.ldu import LduMatrix
from ogl_tpu_torch.foam.solver import FoamSolver

__all__ = ["GKOCG", "GKOBiCGStab", "GKOGMRES", "GKOMultigrid"]


class _NamedSolver(FoamSolver):
    SOLVER: str = ""
    SYMMETRIC_ONLY = False

    def __init__(self, field_name: str, controls: dict | None = None):
        controls = dict(controls or {})
        controls["solver"] = self.SOLVER
        super().__init__(field_name, controls)

    def solve(self, m: LduMatrix, b, psi=None, time_value=None):
        if self.SYMMETRIC_ONLY and not m.symmetric:
            raise ValueError(
                f"{self.SOLVER} is registered for symmetric matrices only "
                "(reference registers it in the sym table alone, GKOCG.C:16)"
            )
        return super().solve(m, b, psi=psi, time_value=time_value)


class GKOCG(_NamedSolver):
    """Conjugate gradients (symmetric only, reference Solver/CG/)."""

    SOLVER = "GKOCG"
    SYMMETRIC_ONLY = True


class GKOBiCGStab(_NamedSolver):
    """BiCGStab (symmetric and asymmetric, reference Solver/BiCGStab/)."""

    SOLVER = "GKOBiCGStab"


class GKOGMRES(_NamedSolver):
    """Restarted GMRES (reference Solver/GMRES/)."""

    SOLVER = "GKOGMRES"


class GKOMultigrid(_NamedSolver):
    """AMG as the solver: Richardson around one AMG cycle (reference
    Solver/Multigrid/)."""

    SOLVER = "GKOMultigrid"
