// The AMG loop kernel's float32 and bfloat16 variants of GKOCG + Multigrid (the
// CG loop) on a Gdia outer operator: K1 takes gdia_k1.cuh's row-quad body, the
// plane offsets staged per block.  The kernel, its phases and their design are
// amg_loop.cuh's; the entry points are amg_loop.cu's.  A source of its own, so
// that nvcc builds it beside the others.
#include "amg_loop.cuh"

OGL_AMG_LOOP_KERNELS(loop_kernel_gdia_cg, ogl::amg::kOuterGdia)
