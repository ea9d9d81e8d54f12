// Ell SpMV for Hopper: y[i] = sum_k vals[k*n + i] * x[cols[k*n + i]] over the
// slot-major (K, n) storage, padding pointing at the row itself with value 0.
//
// Replaces: no TPU kernel.  The reference computes `spmv_ell`
// (ogl_tpu/kernels/spmv.py:50) as an XLA gather and row reduce; this
// hand-written kernel takes its place on the card, for `matrixFormat Ell`
// and for the format ladder's Ell landing (kernels/spmv.py pack_fast).
//
// Bound: device-memory bandwidth.  It reads n * K values and column
// indices (padding included, as the reference's byte model counts them),
// x once at the least and writes y once: n * K * 8 + 2 * n * 4 bytes.  The
// function itself needs nnz * 8 + 2 * n * 4 bytes and 2 * nnz flops, the
// bound chip_smoke.py reports; the padding is the format's cost.
//
// Design: ell_rows.cuh, one thread per row on a grid-stride grid sized by
// the caller; the slot-major layout makes each slot's loads coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const int* __restrict__ cols, const float* __restrict__ vals, int k_width,
                    const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  const ogl::XSource src{x};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    y[i] = ogl::ell_row(cols, vals, k_width, src, i, n);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_ell_spmv(const int* cols, const float* vals, int k_width, const float* x,
                            float* y, int64_t n, int64_t blocks, void* stream) {
  if (n < 0 || k_width < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  ell_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(cols, vals, k_width, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
