// The AMG loop kernel's float32 and bfloat16 variants of GKOCG + Multigrid (the
// CG loop) on an Ell or Hybrid outer operator: K1 takes ell_rows.cuh's row body
// (with a Hybrid's tail).  The kernel, its phases and their design are
// amg_loop.cuh's; the entry points are amg_loop.cu's.  A source of its own, so
// that nvcc builds it beside the others.
#include "amg_loop.cuh"

OGL_AMG_LOOP_KERNELS(loop_kernel_ell_cg, ogl::amg::kOuterEll)
