// Kernel 1 of the ILU family's apply: the Jacobi sweeps of both triangular
// factors (ILU: L then U; IC: L then L^T) as ONE cooperative launch per
// preconditioner apply, the body tri_sweep.cuh `sweep_apply`.
//
// Replaces no TPU kernel: the reference runs the sweeps as XLA ops over its
// factors' fast-format SpMV (ogl_tpu/precond/ilu.py:65-110 `_sweep`,
// `make_lu_apply`, `make_ic_apply`).  Plain twin: `tri_sweep_plain` in
// ogl_tpu_torch/kernels/tri_solve.py, bit-equal.
//
// Bound: device-memory bandwidth.  A sweep of a factor with e entries per
// row reads its row offsets, columns and values, the source vector, b and
// d, and writes one vector: (4 + 8e + 16) bytes per row streamed (44 at the
// 7-point grid's IC(0), e = 3); at 1M rows the factors and vectors fit the
// 50 MB L2, so sweeps after the first may read them from there.  Besides:
// max(kL, 1) + max(kU, 1) - 1 grid barriers.
//
// Design: one thread per row (csr_row's chunks of four entries' loads in
// flight), rows walked grid-stride in a fixed order by a grid of at most the
// co-resident blocks (the wrapper caps it at 4 blocks of 256 per SM, fewer
// when the rows run out), so grid.sync() is legal; ping-pong buffers, the
// first sweep of each triangle reading b * d at its sources.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "loop.cuh"
#include "tri_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct GridSync {
  cg::grid_group grid;
  __device__ __forceinline__ void operator()() { grid.sync(); }
};

__global__ void __launch_bounds__(kThreads, 4)
    tri_sweep_kernel(ogl::tri::Triangle lo, ogl::tri::Triangle up, const float* r, float* t0,
                     float* t1, float* out, int64_t n) {
  GridSync sync{cg::this_grid()};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  ogl::tri::sweep_apply(lo, up, r, t0, t1, out, n, first, stride, sync);
}

}  // namespace

// The co-resident blocks of 256 threads of the sweep kernel on the current
// device (occupancy x SMs).
extern "C" int ogl_tri_sweep_grid(int64_t* blocks) {
  return ogl::coop_grid(reinterpret_cast<const void*>(tri_sweep_kernel), kThreads, blocks);
}

// One cooperative launch of `blocks` blocks of 256 threads on `stream`: the
// upper factor's sweeps over z, the lower factor's sweeps over r, into out.
// l_* and u_* are the two
// strict factors as Csr (row_ptr (n + 1,), cols and vals (nnz,)), l_d and
// u_d their scales (null: none), kl and ku their sweep counts; t0 and t1 are
// two scratch vectors of n floats, out receives the result.  Returns the
// launch's error code (0 = launched).
extern "C" int ogl_tri_sweep(const int* l_ptr, const int* l_cols, const float* l_vals,
                             const float* l_d, int kl, const int* u_ptr, const int* u_cols,
                             const float* u_vals, const float* u_d, int ku, const float* r,
                             float* t0, float* t1, float* out, int64_t n, int64_t blocks,
                             void* stream) {
  if (n < 1 || kl < 0 || ku < 0 || blocks < 1 || blocks > INT32_MAX || l_ptr == nullptr ||
      u_ptr == nullptr || r == nullptr || t0 == nullptr || t1 == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ogl::tri::Triangle lo{ogl::CsrOperands{l_ptr, l_cols, l_vals}, l_d, kl};
  ogl::tri::Triangle up{ogl::CsrOperands{u_ptr, u_cols, u_vals}, u_d, ku};
  void* args[] = {&lo, &up, &r, &t0, &t1, &out, &n};
  return ogl::coop_launch(reinterpret_cast<const void*>(tri_sweep_kernel), blocks, kThreads,
                          args, stream);
}
