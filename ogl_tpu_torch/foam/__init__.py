from ogl_tpu_torch.foam.solver import (
    FoamSolver as FoamSolver,
    SolverPerformance as SolverPerformance,
    solve as solve,
)
from ogl_tpu_torch.foam.api import GKOCG as GKOCG
from ogl_tpu_torch.foam.api import GKOBiCGStab as GKOBiCGStab
from ogl_tpu_torch.foam.api import GKOGMRES as GKOGMRES
from ogl_tpu_torch.foam.api import GKOMultigrid as GKOMultigrid
