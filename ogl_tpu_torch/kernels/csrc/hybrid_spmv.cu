// Hybrid SpMV for Hopper: y = A x for an Ell bulk (slot-major (K, n)) plus a
// tail stored as a Csr, in one pass: thread i sums row i's Ell slots, then
// its run of the tail, [tail_ptr[i], tail_ptr[i+1]), and stores y[i] once.
//
// Replaces: no TPU kernel.  The reference computes `spmv_hybrid`
// (ogl_tpu/kernels/spmv.py:92) as two XLA ops added together, spmv_ell +
// spmv_coo; this hand-written kernel takes their place on the card, with no
// second launch adding into y.
//
// Bound: device-memory bandwidth.  It reads n * K Ell values and columns,
// the tail's values, columns and offsets, x once at the least and writes y
// once: n * K * 8 + t * 8 + (n + 1) * 4 + 2 * n * 4 bytes for t tail
// entries.  The function itself needs nnz * 8 + 2 * n * 4 bytes plus the
// tail's rows, min(t, n + 1) * 4, and 2 * nnz flops, the bound
// chip_smoke.py reports.
//
// Arithmetic: the Ell slots in order (ell_rows.cuh), then the tail entries
// in order, each product and sum rounded on its own — the plain version's
// order (kernels/gather_spmv.py spmv_hybrid), so the two give the same
// bits.
//
// Design: ell_rows.cuh for the bulk (coalesced slot loads); the tail is
// short (coo_to_hybrid's width is the 80th-percentile row length), and a
// row's tail entries are contiguous.  Grid-stride over rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    hybrid_spmv_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                       int k_width, const int* __restrict__ tail_ptr,
                       const int* __restrict__ tail_cols, const float* __restrict__ tail_vals,
                       const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  const ogl::XSource src{x};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    float acc = ogl::ell_row(cols, vals, k_width, src, i, n);
    const int64_t end = __ldg(tail_ptr + i + 1);
    for (int64_t j = __ldg(tail_ptr + i); j < end; ++j)
      acc = ogl::mul_add_rn(acc, __ldg(tail_vals + j), src.at(__ldg(tail_cols + j)));
    y[i] = acc;
  }
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_hybrid_spmv(const int* cols, const float* vals, int k_width,
                               const int* tail_ptr, const int* tail_cols,
                               const float* tail_vals, const float* x, float* y, int64_t n,
                               int64_t blocks, void* stream) {
  if (n < 0 || k_width < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  hybrid_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(cols, vals, k_width, tail_ptr,
                                                            tail_cols, tail_vals, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
