// Ell and Hybrid SpMV for Hopper: y = A x over the slot-major (K, n) Ell
// storage (each 32-row group stopping at its longest row), plus, for a
// Hybrid matrix, each row's tail entries in the same pass: thread i sums row
// i's slots, then its run of the tail, and stores y[i] once.
//
// Replaces: no TPU kernel.  The reference computes `spmv_ell`
// (ogl_tpu/kernels/spmv.py:50) as an XLA gather and row reduce, and
// `spmv_hybrid` (:92) as two XLA ops added together, spmv_ell + spmv_coo;
// this hand-written kernel takes their place on the card, for `matrixFormat
// Ell` and `Hybrid` and for the format ladder's Ell landing
// (kernels/spmv.py pack_fast), with no second launch adding into y.
//
// Bound: device-memory bandwidth.  The function needs each entry's value and
// column once, x once and y once: nnz * 8 + 2 * n * 4 bytes (plus, for
// Hybrid, the tail's rows: min(t, n + 1) * 4 for t tail entries) and 2 *
// nnz flops, the bound chip_smoke.py reports.  The kernel reads the slots
// below each group's longest row (kNN-6: 11.2 of K = 17 on mean, 98 bytes
// per row where all K took 144), the group's slot count, and the tail's
// offsets only when there is a tail.
//
// Arithmetic and design: ell_rows.cuh, one thread per row on a grid-stride
// grid of whole warps sized by the caller.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(ogl::EllOperands m, const float* __restrict__ x, float* __restrict__ y,
                    int64_t n) {
  const ogl::XSource src{x};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    y[i] = ogl::ell_row(m, src, i, n);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`: the Ell matrix (cols,
// vals (K, n), warp_slots (ceil(n / 32),), every entry at most K) with, when
// tail_ptr is not null, the Hybrid tail (tail_ptr (n + 1,), tail_cols,
// tail_vals).  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_ell_spmv(const int* cols, const float* vals, const int* warp_slots,
                            const int* tail_ptr, const int* tail_cols, const float* tail_vals,
                            const float* x, float* y, int64_t n, int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const ogl::EllOperands m{cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals};
  ell_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(m, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
