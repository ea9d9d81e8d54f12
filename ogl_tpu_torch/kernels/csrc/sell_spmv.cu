// Sell (SELL-C-sigma, width buckets) SpMV for Hopper, all buckets in ONE
// launch over the bucket table: thread g takes slot g of the concatenated
// slot space, finds its bucket b (table[b] = first slot, first value,
// width) and sums its w_b lanes of the bucket's slot-major (w_b, S_b)
// storage (S_b = ns_b * C slots),
//   acc = sum_k vals[v0 + k*S_b + s] * x[cols[...]]   (s = g - first slot),
// stored to y[slot_rows[g]].  slot_rows is a permutation of the rows plus
// pad slots pointing at n, which store nothing: plain stores, no atomics.
//
// Replaces: no TPU kernel.  The reference computes `spmv_sell`
// (ogl_tpu/kernels/spmv.py:55) as XLA ops, one gather and reduce per bucket
// and a scatter-add into y; this hand-written kernel takes their place on
// the card.
//
// Bound: device-memory bandwidth.  It reads the stored (padded) values and
// columns once, the slot table once, x once at the least and writes y once:
// stored * 8 + slots * 4 + 2 * n * 4 bytes for 2 * stored flops.  The
// function itself needs nnz * 8 + n * 4 (the row permutation) + 2 * n * 4
// bytes and 2 * nnz flops, the bound chip_smoke.py reports.
//
// Arithmetic: lanes in order from 0.0f, every product and sum rounded on its
// own, padding (col 0, value 0) included — the plain version's order
// (kernels/gather_spmv.py spmv_sell), so the two give the same bits.
//
// Design: each bucket is slot-major, as Ell is: the threads of a warp read
// one lane of 32 neighbouring slots at neighbouring addresses (one 128-byte
// line per lane, no division by the slice height).  The bucket table (at
// most kMaxBuckets rows) is staged once per block in shared memory; a thread
// finds its bucket by a scan of it.  Grid-stride over slots; value indices
// are int64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 64;  // kernels/gather_spmv.py SELL_MAX_BUCKETS

__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const long long* __restrict__ table, int nb,
                     const int* __restrict__ slot_rows, const int* __restrict__ cols,
                     const float* __restrict__ vals, const float* __restrict__ x,
                     float* __restrict__ y, int64_t n, int64_t slots) {
  __shared__ long long s_tab[kMaxBuckets * 3];
  for (int t = threadIdx.x; t < nb * 3; t += blockDim.x) s_tab[t] = table[t];
  __syncthreads();
  const ogl::XSource src{x};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < slots;
       g += step) {
    int b = 0;
    while (b + 1 < nb && s_tab[(b + 1) * 3] <= g) ++b;
    const int64_t first = s_tab[b * 3];
    const int64_t bucket_slots = (b + 1 < nb ? s_tab[(b + 1) * 3] : slots) - first;
    const int w = static_cast<int>(s_tab[b * 3 + 2]);
    const int64_t base = s_tab[b * 3 + 1] + (g - first);
    float acc = 0.0f;
    for (int k = 0; k < w; ++k) {
      const int64_t e = base + k * bucket_slots;
      acc = ogl::mul_add_rn(acc, __ldg(vals + e), src.at(__ldg(cols + e)));
    }
    // the slot's row is read after its sum, so the sum's loads do not wait
    // on it; a pad slot (row n) sums its inert padding and stores nothing
    const int row = __ldg(slot_rows + g);
    if (row < n) y[row] = acc;
  }
}

}  // namespace

// Launches `blocks` blocks of 256 threads over `slots` slots on `stream`.
// Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_sell_spmv(const long long* table, int nb, const int* slot_rows,
                             const int* cols, const float* vals, const float* x, float* y,
                             int64_t n, int64_t slots, int64_t blocks, void* stream) {
  if (n < 0 || slots < 0 || nb < 0 || nb > kMaxBuckets || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || slots == 0) return 0;
  sell_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(table, nb, slot_rows, cols, vals, x,
                                                          y, n, slots);
  return static_cast<int>(cudaGetLastError());
}
