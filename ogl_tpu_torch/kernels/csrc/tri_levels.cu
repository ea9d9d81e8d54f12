// Kernel 2 of the ILU family's apply (`triSolve exact`): level-scheduled
// forward and backward substitution over both triangular factors as ONE
// cooperative launch per preconditioner apply, the body tri_levels.cuh
// `level_apply`.
//
// Replaces no TPU kernel: the reference runs its sweep (XLA ops over the
// factors' fast-format SpMV) to the factor's dependency depth
// (ogl_tpu/precond/ilu.py:17-28, 45-62).  Plain twin: `tri_levels_plain` in
// ogl_tpu_torch/kernels/tri_solve.py, bit-equal, and bit-equal to kernel 1
// (tri_sweep.cu) run to the depth.
//
// Bound: each factor, r, d and the result move once (the bytes of one
// sweep), but the levels are sequential: levels - 1 grid barriers per
// factor (about 317 on the 128x128x64 grid's IC(0) factor) and one barrier
// between the factors, each behind one dependent row's loads.
//
// Design: one thread per row of a level, rows of a level contiguous in the
// level-ordered list, a grid sized by the wrapper to the widest level (at
// most the co-resident blocks), so each level is one step of every thread
// and a barrier costs as few blocks as the widest level needs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "loop.cuh"
#include "tri_levels.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct GridSync {
  cg::grid_group grid;
  __device__ __forceinline__ void operator()() { grid.sync(); }
};

__global__ void __launch_bounds__(kThreads)
    tri_levels_kernel(ogl::tri::Triangle lo, ogl::tri::Levels llv, ogl::tri::Triangle up,
                      ogl::tri::Levels ulv, const float* r, float* z, float* out) {
  GridSync sync{cg::this_grid()};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  ogl::tri::level_apply(lo, llv, up, ulv, r, z, out, first, stride, sync);
}

}  // namespace

// The co-resident blocks of 256 threads of the level kernel on the current
// device (occupancy x SMs).
extern "C" int ogl_tri_levels_grid(int64_t* blocks) {
  return ogl::coop_grid(reinterpret_cast<const void*>(tri_levels_kernel), kThreads, blocks);
}

// One cooperative launch of `blocks` blocks of 256 threads on `stream`: out
// = the exact apply of the two strict factors (as ogl_tri_sweep's operands,
// without sweep counts) to r.  l_order and u_order (n,) hold each factor's
// rows level after level, l_level_ptr and u_level_ptr (levels + 1,) the
// offsets of the levels; z is a scratch vector of n floats.  Returns the
// launch's error code (0 = launched).
extern "C" int ogl_tri_levels(const int* l_ptr, const int* l_cols, const float* l_vals,
                              const float* l_d, const int* l_order, const int* l_level_ptr,
                              int l_levels, const int* u_ptr, const int* u_cols,
                              const float* u_vals, const float* u_d, const int* u_order,
                              const int* u_level_ptr, int u_levels, const float* r, float* z,
                              float* out, int64_t n, int64_t blocks, void* stream) {
  if (n < 1 || l_levels < 1 || u_levels < 1 || blocks < 1 || blocks > INT32_MAX ||
      l_ptr == nullptr || u_ptr == nullptr || l_order == nullptr || u_order == nullptr ||
      l_level_ptr == nullptr || u_level_ptr == nullptr || r == nullptr || z == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ogl::tri::Triangle lo{ogl::CsrOperands{l_ptr, l_cols, l_vals}, l_d, 0};
  ogl::tri::Triangle up{ogl::CsrOperands{u_ptr, u_cols, u_vals}, u_d, 0};
  ogl::tri::Levels llv{l_order, l_level_ptr, l_levels};
  ogl::tri::Levels ulv{u_order, u_level_ptr, u_levels};
  void* args[] = {&lo, &llv, &up, &ulv, &r, &z, &out};
  return ogl::coop_launch(reinterpret_cast<const void*>(tri_levels_kernel), blocks, kThreads,
                          args, stream);
}
