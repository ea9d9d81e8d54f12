// Kernel 1 of the ILU family's apply: the Jacobi sweeps of both triangular
// factors (ILU: L then U; IC: L then L^T) as ONE cooperative launch per
// preconditioner apply, the body tri_sweep.cuh `sweep_apply`.
//
// Replaces no TPU kernel: the reference runs the sweeps as XLA ops over its
// factors' fast-format SpMV (ogl_tpu/precond/ilu.py:65-110 `_sweep`,
// `make_lu_apply`, `make_ic_apply`).  Plain twin: `tri_sweep_plain` in
// ogl_tpu_torch/kernels/tri_solve.py, bit-equal.
//
// Bound: device-memory bandwidth.  One apply must read each factor's row
// offsets, columns and values, r and each d once and write the result (39.8
// bytes per row at the 7-point grid's IC(0)); a sweep that streams its
// factor again reads 44 bytes per row per pass (16 passes: 700 bytes per
// row).  Besides: max(kL, 1) + max(kU, 1) - 1 grid barriers.
//
// Design: held (a factor of which at least the wrapper's SWEEP_HOLD_SHARE
// fits), one CTA of 1,024 threads per SM, each owning a contiguous range of
// rows balanced by entries (the host plan `sweep_plan`); at the start of
// each triangle the CTA brings its range's row offsets and entries into
// dynamic shared memory once, by bulk copies (tma.cuh), as far as its
// shared memory reaches (at 1M rows the IC(0) factor's whole range); every
// sweep reads those rows from shared memory and the rest from device memory,
// in the same pass, so of the factor only the part not held crosses the
// memory bus more than once.  Streamed (at 8.4M, about an eighth would fit):
// the same grid with no shared memory (so the SMs' memory serves L1), rows
// dealt over the grid.  A thread takes one row at a time, four entries'
// loads in flight;
// b and d of its first rows stay in registers; only the iterate crosses the
// grid barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "loop.cuh"
#include "tri_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

struct GridSync {
  cg::grid_group grid;
  __device__ __forceinline__ void operator()() { grid.sync(); }
};

constexpr int kThreads = 1024;  // the most threads per CTA

__global__ void __launch_bounds__(kThreads, 1)
    tri_sweep_kernel(ogl::tri::Triangle lo, ogl::tri::Part lo_part, ogl::tri::Triangle up,
                     ogl::tri::Part up_part, const float* r, float* t0, float* t1, float* out,
                     int64_t n, int64_t capacity) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  GridSync sync{cg::this_grid()};
  ogl::tri::sweep_apply(lo, lo_part, up, up_part, n, r, t0, t1, out, smem, capacity, &bar,
                        sync);
}

const void* sweep_kernel() { return reinterpret_cast<const void*>(&tri_sweep_kernel); }

// The most dynamic shared memory a CTA of the kernel can take on the current
// device (the opt-in limit less the kernel's static shared memory), allowed.
int allow_smem(const void* kernel, int64_t* capacity) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *capacity = bytes;
  return 0;
}

}  // namespace

// The co-resident CTAs of 1,024 threads of the sweep kernel with all the
// dynamic shared memory a CTA can take (one per SM), and that capacity in
// bytes, on the current device.
extern "C" int ogl_tri_sweep_grid(int64_t* blocks, int64_t* capacity) {
  const int err = allow_smem(sweep_kernel(), capacity);
  if (err != 0) return err;
  return ogl::coop_grid(sweep_kernel(), kThreads, blocks, static_cast<size_t>(*capacity));
}

// One cooperative launch of `blocks` CTAs of 1,024 threads with `capacity`
// bytes of dynamic shared memory (ogl_tri_sweep_grid's, or 0 when neither
// factor is held) on `stream`: the
// lower factor's sweeps over r, then the upper factor's over their result z,
// into out.  l_* and u_* are the two strict factors as Csr (row_ptr (n + 1,),
// cols and vals (nnz,), each 16-byte aligned), l_d and u_d their scales
// (null: none), kl and ku their sweep counts, l_bounds/u_bounds (blocks + 1,)
// and l_held/u_held (blocks,) their plans (tri_solve.py `sweep_plan`; both
// null: nothing held, the rows dealt over the grid); t0 and t1 are two
// scratch vectors of n floats.  Returns the launch's error code
// (0 = launched).
extern "C" int ogl_tri_sweep(const int* l_ptr, const int* l_cols, const float* l_vals,
                             const float* l_d, int kl, const int* l_bounds, const int* l_held,
                             const int* u_ptr, const int* u_cols, const float* u_vals,
                             const float* u_d, int ku, const int* u_bounds, const int* u_held,
                             const float* r, float* t0, float* t1, float* out, int64_t n,
                             int64_t blocks, int64_t capacity, void* stream) {
  if (n < 1 || kl < 0 || ku < 0 || blocks < 1 || blocks > INT32_MAX || capacity < 0 ||
      l_ptr == nullptr || u_ptr == nullptr || (l_bounds == nullptr) != (l_held == nullptr) ||
      (u_bounds == nullptr) != (u_held == nullptr) || r == nullptr || t0 == nullptr ||
      t1 == nullptr || out == nullptr || ogl::misaligned(l_ptr, 16) ||
      ogl::misaligned(l_cols, 16) || ogl::misaligned(l_vals, 16) ||
      ogl::misaligned(u_ptr, 16) || ogl::misaligned(u_cols, 16) ||
      ogl::misaligned(u_vals, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  ogl::tri::Triangle lo{ogl::CsrOperands{l_ptr, l_cols, l_vals}, l_d, kl};
  ogl::tri::Triangle up{ogl::CsrOperands{u_ptr, u_cols, u_vals}, u_d, ku};
  ogl::tri::Part lp{l_bounds, l_held}, upart{u_bounds, u_held};
  void* args[] = {&lo, &lp, &up, &upart, &r, &t0, &t1, &out, &n, &capacity};
  return ogl::coop_launch(sweep_kernel(), blocks, kThreads, args, stream,
                          static_cast<size_t>(capacity));
}
