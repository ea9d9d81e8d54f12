from ogl_tpu_torch.core import formats as formats
from ogl_tpu_torch.core import ldu as ldu
