// The AMG smoother on an Ell level, for Hopper:
//   ogl_amg_ell_sweep:  out[i] = x[i] + (relax * invd[i]) * (b[i] - (A x)[i])
//   ogl_amg_ell_resid:  out[i] = b[i] - (A x)[i]
// over the slot-major (K, n) Ell storage, each 32-row group stopping at its
// longest row (Ell.warp_slots), the values float32 or bfloat16.
//
// Replaces: no TPU kernel.  The reference smooths an Ell level with XLA ops:
// ogl_tpu/precond/amg.py `_smooth` (:420-430) around `_apply_mat` (:402-417),
// which on an Ell level is the XLA gather and row reduce `spmv_ell`
// (ogl_tpu/kernels/spmv.py:50).  It is the A x of every level of a kNN
// hierarchy, so the level's sweep and residual are one hand-written kernel
// each here, the elementwise work fused into the row's SpMV.
//
// Bound: device-memory bandwidth.  Per row the function needs its entries'
// columns (4 B) and values (4 B, 2 B in bfloat16) once, x, b (and invd) in
// and out written: nnz * (4 + value bytes) + (3 or 4) * n * 4 bytes, at
// 2 * nnz + 3 (sweep 5) flops per row; the gathers of x hit L2 mostly.
//
// Design: the Ell row body (ell_rows.cuh, amg_level.cuh `ell_smooth_row`),
// one thread per row on a grid-stride grid of whole warps (256 threads per
// block), so each warp holds one 32-row group and stops at its slot count;
// each row issues kEllChunk slots' loads before adding them.  A sweep reads
// x at other rows, so `out` is a buffer of its own (the wrapper refuses an
// overlap).  Every operation is rounded as the plain version rounds it: the
// kernel gives its twin's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "amg_level.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSweep, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_smooth_kernel(ogl::EllOperandsOf<T> m, const float* __restrict__ x,
                      const float* __restrict__ b, const float* __restrict__ invd, float relax,
                      float* __restrict__ out, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = ogl::ell_smooth_row<kSweep>(m, x, b, invd, relax, i, n);
}

template <bool kSweep, typename T>
int launch(const int* cols, const void* vals, const int* warp_slots, const float* x,
           const float* b, const float* invd, float relax, float* out, int64_t n,
           int64_t blocks, void* stream) {
  const ogl::EllOperandsOf<T> m{cols, static_cast<const T*>(vals), warp_slots, nullptr,
                                nullptr, nullptr};
  ell_smooth_kernel<kSweep, T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(m, x, b, invd, relax,
                                                                      out, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSweep>
int dispatch(const int* cols, const void* vals, int vals_bf16, const int* warp_slots,
             const float* x, const float* b, const float* invd, float relax, float* out,
             int64_t n, int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX || (vals_bf16 != 0 && vals_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return vals_bf16 ? launch<kSweep, __nv_bfloat16>(cols, vals, warp_slots, x, b, invd, relax,
                                                   out, n, blocks, stream)
                   : launch<kSweep, float>(cols, vals, warp_slots, x, b, invd, relax, out, n,
                                           blocks, stream);
}

}  // namespace

// cols (K, n) int32 and vals (K, n) float32 (vals_bf16 = 0) or bfloat16
// (vals_bf16 = 1), slot-major, warp_slots (ceil(n / 32),) int32, each at most
// K; x, b, invd, out (n,) float32, out not overlapping x.  Launches `blocks`
// blocks of 256 threads on `stream`; returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_amg_ell_sweep(const int* cols, const void* vals, int vals_bf16,
                                 const int* warp_slots, const float* x, const float* b,
                                 const float* invd, float relax, float* out, int64_t n,
                                 int64_t blocks, void* stream) {
  return dispatch<true>(cols, vals, vals_bf16, warp_slots, x, b, invd, relax, out, n, blocks,
                        stream);
}

extern "C" int ogl_amg_ell_resid(const int* cols, const void* vals, int vals_bf16,
                                 const int* warp_slots, const float* x, const float* b,
                                 float* out, int64_t n, int64_t blocks, void* stream) {
  return dispatch<false>(cols, vals, vals_bf16, warp_slots, x, b, nullptr, 0.0f, out, n,
                         blocks, stream);
}
