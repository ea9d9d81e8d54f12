// CSR SpMV for Hopper: y = A x over (row_ptr, cols, vals), int32 indices.
// Also the Coo SpMV: matrixFormat Coo is stored on the device as a Csr of its
// row-major sorted entries (core/formats.py DeviceCoo, coo_to_device).
//
// Replaces: no TPU kernel.  The reference computes `spmv_csr` and
// `spmv_coo` (ogl_tpu/kernels/spmv.py:33-47) as XLA ops, a gather of x and
// a segment sum; this hand-written kernel takes their place on the card.
//
// Bound: device-memory bandwidth.  It reads each value and column index
// once, the row offsets once, x once at the least (the gathers re-read it
// from L2) and writes y once: nnz * 8 + (n + 1) * 4 + 2 * n * 4 bytes for
// 2 * nnz flops.
//
// Design: csr_rows.cuh.  At one lane per row (G = 1: under 16 entries per
// row on mean, as on the 7-point stencil and the kNN-6 mesh) each lane sums
// its own row, four entries' loads in flight (csr_row); longer rows take G =
// 4 to 16 lanes per row (kernels/gather_spmv.py csr_group), their lanes
// reading neighbouring entries, the partial sums combined by a shuffle
// butterfly.  A grid-stride loop over row groups on a grid sized by the
// caller; every lane of a warp stays in the loop until its warp's rows are
// done (the warp's first row decides), so the shuffles see the whole warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                    const float* __restrict__ vals, const float* __restrict__ x,
                    float* __restrict__ y, int64_t n) {
  const ogl::XSource src{x};
  const int lane = threadIdx.x & (G - 1);
  const int64_t group = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  // the first row of this warp: the same on every lane, so the loop's trip
  // count is too (groups is a whole number of warps' groups)
  const int64_t warp_row0 = group - (threadIdx.x & 31) / G;
  for (int64_t row = group, first = warp_row0; first < n; row += groups, first += groups) {
    float sum;
    if constexpr (G > 1) {
      sum = ogl::csr_group_row<G>(row_ptr, cols, vals, src, row, lane, row < n);
    } else {
      sum = row < n ? ogl::csr_row(row_ptr, cols, vals, src, row) : 0.0f;
    }
    if (lane == 0 && row < n) y[row] = sum;
  }
}

template <int G>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals, const float* x,
                   float* y, int64_t n, int64_t blocks, cudaStream_t stream) {
  csr_spmv_kernel<G><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      row_ptr, cols, vals, x, y, n);
  return cudaGetLastError();
}

}  // namespace

// Launches `blocks` blocks of 256 threads, `group` (1, 2, 4, 8, 16 or 32)
// lanes per row, on `stream`.  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_csr_spmv(const int* row_ptr, const int* cols, const float* vals,
                            const float* x, float* y, int64_t n, int group, int64_t blocks,
                            void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return static_cast<int>(launch<1>(row_ptr, cols, vals, x, y, n, blocks, s));
    case 2: return static_cast<int>(launch<2>(row_ptr, cols, vals, x, y, n, blocks, s));
    case 4: return static_cast<int>(launch<4>(row_ptr, cols, vals, x, y, n, blocks, s));
    case 8: return static_cast<int>(launch<8>(row_ptr, cols, vals, x, y, n, blocks, s));
    case 16: return static_cast<int>(launch<16>(row_ptr, cols, vals, x, y, n, blocks, s));
    case 32: return static_cast<int>(launch<32>(row_ptr, cols, vals, x, y, n, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
