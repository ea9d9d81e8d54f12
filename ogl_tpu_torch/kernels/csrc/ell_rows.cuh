// The Ell row body for Hopper, over a SOURCE FUNCTOR (src.at(j), as in
// dia_rows.cuh): one thread per row of the slot-major (K, n) storage,
//   y[i] = sum_{k < w} vals[k*n + i] * src(cols[k*n + i])
// where w = warp_slots[i / 32], the longest row of the 32-row group that
// holds row i (padding points at the row itself with value 0), then, for a
// Hybrid matrix, the row's tail entries [tail_ptr[i], tail_ptr[i+1]).
// Shared by the Ell and Hybrid SpMV (ell_spmv.cu), the K1 phase of the CG
// loop's Ell variants (cg_loop.cu) and the two SpMV phases of the
// general-BiCGStab loop's Ell variants (bicgstab_gen_loop.cu), each over its
// own source.
//
// Arithmetic: the row accumulates in float32 in slot order from 0.0f, then
// its tail in order, every product and sum rounded on its own (mul_add_rn),
// the padding below w included — what the plain versions
// (kernels/gather_spmv.py spmv_ell, spmv_hybrid) compute, so the kernels and
// their twins give the same bits.  The slots from w to K hold padding only
// (0 * src(i)); for a finite source they add exact zeros, so skipping them
// changes no sum but the sign of a zero one.
//
// Design.  The storage is slot-major, so the threads of a warp read one slot
// of 32 neighbouring rows at neighbouring addresses (one 128-byte line for
// the values, one for the columns).  The callers walk rows on grid-stride
// grids of whole warps (blocks a multiple of 32 threads), so a warp holds
// the 32 rows of one group and stops at the group's w, not at K: on the
// kNN-6 mesh (K 17, 8.1 entries per row) the warps stop at 11.2 slots on
// mean.  A row issues its slots in chunks of kEllChunk: the chunk's column
// loads, then its value loads and source gathers, then the adds in slot
// order, so a warp keeps a chunk of loads in flight where one slot at a time
// waited for each gather before the next column load.  The group's w is one
// broadcast load.  Measured on the H100 (chip_smoke.py --turns-gather, in
// turns): chunks of 8 ran 4-8% slower at kNN 1M (64 registers in the
// loops), level at 8.4M; each lane stopping at its own row (int32 counts,
// 4 bytes per row) ran 1.6% faster at kNN 1M and 5% slower at 8.4M.  The
// tail (Hybrid) is short, a row's entries contiguous; a null tail_ptr (Ell,
// or a Hybrid with an empty tail) reads no offsets, a branch uniform over the
// launch.  Indices are int64 (k * n + i can pass 2^31).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource, K1Source

namespace ogl {

constexpr int kEllChunk = 4;  // slots whose loads a row issues before adding them

// An Ell matrix, or the Ell part and tail of a Hybrid one, as the row body
// reads it; everything is read-only for a launch.
struct EllOperands {
  const int* cols;        // (K, n) slot-major
  const float* vals;      // (K, n)
  const int* warp_slots;  // (ceil(n / 32),): the longest row of each 32-row group
  const int* tail_ptr;    // (n + 1,) Hybrid tail row offsets; null: no tail
  const int* tail_cols;
  const float* tail_vals;
};

// Row i's sum (0 <= i < n); the caller's warp holds i's 32-row group.
template <class Src>
__device__ __forceinline__ float ell_row(const EllOperands& m, const Src& src, int64_t i,
                                         int64_t n) {
  const int w = __ldg(m.warp_slots + (i >> 5));
  float acc = 0.0f;
  for (int k0 = 0; k0 < w; k0 += kEllChunk) {
    int c[kEllChunk];
    float v[kEllChunk], g[kEllChunk];
#pragma unroll
    for (int e = 0; e < kEllChunk; ++e)
      c[e] = k0 + e < w ? __ldg(m.cols + static_cast<int64_t>(k0 + e) * n + i) : 0;
#pragma unroll
    for (int e = 0; e < kEllChunk; ++e) {
      v[e] = k0 + e < w ? __ldg(m.vals + static_cast<int64_t>(k0 + e) * n + i) : 0.0f;
      g[e] = k0 + e < w ? src.at(c[e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kEllChunk; ++e)
      if (k0 + e < w) acc = mul_add_rn(acc, v[e], g[e]);
  }
  if (m.tail_ptr != nullptr) {
    const int end = __ldg(m.tail_ptr + i + 1);
    for (int j = __ldg(m.tail_ptr + i); j < end; ++j)
      acc = mul_add_rn(acc, __ldg(m.tail_vals + j), src.at(__ldg(m.tail_cols + j)));
  }
  return acc;
}

}  // namespace ogl
