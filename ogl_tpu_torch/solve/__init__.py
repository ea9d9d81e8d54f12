from ogl_tpu_torch.solve import stopping as stopping
from ogl_tpu_torch.solve import krylov as krylov
from ogl_tpu_torch.solve.cg import cg as cg
from ogl_tpu_torch.solve.cg_fused import cg_fused as cg_fused
from ogl_tpu_torch.solve.ir import ir as ir
