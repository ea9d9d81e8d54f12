// Sell (SELL-C-sigma, width buckets) SpMV for Hopper, all buckets in ONE
// launch: thread g takes slot g of the concatenated slot space and sums its
// lanes up to its slice's longest row (sell_rows.cuh), stored to
// y[slot_rows[g]].  slot_rows is a permutation of the rows plus pad slots
// pointing at n, which store nothing: plain stores, no atomics.
//
// Replaces: no TPU kernel.  The reference computes `spmv_sell`
// (ogl_tpu/kernels/spmv.py:55) as XLA ops, one gather and reduce per bucket
// and a scatter-add into y; this hand-written kernel takes their place on
// the card.
//
// Bound: device-memory bandwidth.  The function needs nnz * 8 + n * 4 (the
// row permutation) + 2 * n * 4 bytes and 2 * nnz flops, the bound
// chip_smoke.py reports.  The kernel reads the lanes below each slice's
// width (kNN-6: about 80 bytes per row, where the bucket widths stored
// 99.7), a byte and an int per slice, the slot table, x at least once, and
// writes y once.
//
// Design and arithmetic: sell_rows.cuh, one thread per slot on a
// grid-stride grid sized by the caller; each block stages the bucket table
// (at most kSellMaxBuckets buckets) once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sell_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(ogl::SellOperands m, const float* __restrict__ x, float* __restrict__ y,
                     int64_t n) {
  __shared__ ogl::SellBuckets s_buckets;
  ogl::stage_sell(m, s_buckets);
  __syncthreads();
  const ogl::XSource src{x};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < m.slots;
       g += step) {
    const float acc = ogl::sell_slot(m, s_buckets, src, g);
    // the slot's row is read after its sum, so the sum's loads do not wait
    // on it; a pad slot (row n) stores nothing
    const int row = __ldg(m.slot_rows + g);
    if (row < n) y[row] = acc;
  }
}

}  // namespace

// Launches `blocks` blocks of 256 threads over `slots` slots on `stream`:
// table (nb, 3) int64, slice_buckets (slots / C,) uint8, slice_widths
// (slots / C,) int32 (each at most its bucket's width), slot_rows (slots,).
// Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_sell_spmv(const long long* table, int nb, const unsigned char* slice_buckets,
                             const int* slice_widths, const int* slot_rows, const int* cols,
                             const float* vals, int64_t slots, int slice_height, const float* x,
                             float* y, int64_t n, int64_t blocks, void* stream) {
  if (n < 0 || slots < 0 || nb < 0 || nb > ogl::kSellMaxBuckets || slice_height < 1 ||
      slots % slice_height != 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || slots == 0) return 0;
  const ogl::SellOperands m{table, nb, slice_buckets, slice_widths, slot_rows, cols, vals,
                            slots, slice_height};
  sell_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(m, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
