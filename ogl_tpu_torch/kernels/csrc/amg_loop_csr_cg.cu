// The AMG loop kernel's float32 and bfloat16 variants of GKOCG + Multigrid (the
// CG loop) on a Csr outer operator (also the device Coo): K1 takes
// csr_rows.cuh's `csr_row`, one lane per row.  The kernel, its phases and their
// design are amg_loop.cuh's; the entry points are amg_loop.cu's.  A source of
// its own, so that nvcc builds it beside the others.
#include "amg_loop.cuh"

OGL_AMG_LOOP_KERNELS(loop_kernel_csr_cg, ogl::amg::kOuterCsr)
