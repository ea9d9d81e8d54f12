// The Sell slot body for Hopper, over a SOURCE FUNCTOR (src.at(j), as in
// dia_rows.cuh): one thread per slot g of the concatenated slot space,
//   y[slot_rows[g]] = sum_{k < w} vals[v + k * S_b] * src(cols[v + k * S_b])
// where b is the slot's bucket (each bucket slot-major, (w_b, S_b) with S_b
// = ns_b * C slots), v = first value of b + (g - first slot of b), and w the
// longest row of the slot's slice of C rows (`slice_widths`, at most w_b).
// Shared by the standalone Sell SpMV (sell_spmv.cu), the K1 phase of the CG
// loop's Sell variants (cg_loop.cu) and the two SpMV phases of the
// general-BiCGStab loop's Sell variants (bicgstab_gen_loop.cu), each over
// its own source.
//
// Arithmetic: the slot accumulates in float32 in lane order from 0.0f, every
// product and sum rounded on its own (mul_add_rn), the padding below w
// included — what the plain version (kernels/gather_spmv.py spmv_sell)
// computes, so the kernels and their twin give the same bits.  The lanes
// from w to w_b hold padding only (column 0, value 0); for a finite source
// they add exact zeros, so skipping them changes no sum but the sign of a
// zero one.
//
// Design.  A slot finds its bucket in one byte per slice (`slice_buckets`,
// built on the host once per sparsity) and the bucket's value base and lane
// stride in a table every block stages in shared memory (stage_sell): no
// scan of the buckets.  The C slots of a slice (C = 8: one 32-byte sector of
// a lane's values, one of its columns) stop together at the slice's width, a
// warp's four slices each at its own; a bucket's width is rounded to a power
// of two when a matrix has more than 8 distinct slice widths (the kNN-6 mesh
// has 10: 87.7 stored bytes of values and columns per row at the bucket
// widths, 67.6 read at the slice widths).  Buckets hold whole slices, so a
// slice never straddles two; a warp may, each slice reading its own bucket's
// entry.  A slot issues its lanes in whole chunks of kSellChunk — the chunk's
// column loads, then its value loads and source gathers, then the adds in
// lane order — and its last w % kSellChunk lanes one at a time, the lane
// addresses stepped by the bucket's stride.  Measured on the H100 in turns
// (PERF.md §6): chunks of 4 with each lane masked at w ran 13% slower than a
// plain loop over the bucket's width on the 8.4M-row Poisson grid (widths
// 5-7); whole chunks then single lanes run level with it there and 1.12x
// faster on the kNN-6 mesh; chunks of 2 or 8, and a tighter register budget,
// ran slower.  Value indices are int64.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource, K1Source

namespace ogl {

constexpr int kSellMaxBuckets = 64;  // kernels/gather_spmv.py SELL_MAX_BUCKETS
constexpr int kSellChunk = 4;        // lanes whose loads a slot issues before adding them

// A Sell matrix as the slot body reads it; everything is read-only for a
// launch.
struct SellOperands {
  const long long* table;              // (nb, 3): first slot, first value, width
  int nb;                              // buckets, at most kSellMaxBuckets
  const unsigned char* slice_buckets;  // (slots / C,): each slice's bucket
  const int* slice_widths;             // (slots / C,): each slice's longest row
  const int* slot_rows;                // (slots,): each slot's row, n for a pad slot
  const int* cols;                     // (stored,)
  const float* vals;                   // (stored,)
  int64_t slots;
  int slice_height;                    // C
};

// The bucket table as a block holds it in shared memory: lane k of slot g in
// bucket b is at base[b] + g + k * stride[b].
struct SellBuckets {
  long long base[kSellMaxBuckets];    // first value - first slot
  long long stride[kSellMaxBuckets];  // the bucket's slot count
};

// Fills `s` from the operands' table; the caller's __syncthreads() follows.
__device__ __forceinline__ void stage_sell(const SellOperands& m, SellBuckets& s) {
  for (int b = threadIdx.x; b < m.nb; b += blockDim.x) {
    const long long first = m.table[b * 3];
    const long long next = b + 1 < m.nb ? m.table[(b + 1) * 3] : m.slots;
    s.base[b] = m.table[b * 3 + 1] - first;
    s.stride[b] = next - first;
  }
}

// Slot g's sum (0 <= g < slots).
template <class Src>
__device__ __forceinline__ float sell_slot(const SellOperands& m, const SellBuckets& s,
                                           const Src& src, int64_t g) {
  const int slice = static_cast<int>(g) / m.slice_height;  // slots < 2^31: int32 rows
  const int b = __ldg(m.slice_buckets + slice);
  const int w = __ldg(m.slice_widths + slice);
  const int64_t stride = s.stride[b];
  const int* cp = m.cols + s.base[b] + g;  // lane k of the slot: cp[k * stride]
  const float* vp = m.vals + s.base[b] + g;
  float acc = 0.0f;
  int k = 0;
  for (; k + kSellChunk <= w; k += kSellChunk) {
    int c[kSellChunk];
    float v[kSellChunk], x[kSellChunk];
#pragma unroll
    for (int e = 0; e < kSellChunk; ++e) c[e] = __ldg(cp + e * stride);
#pragma unroll
    for (int e = 0; e < kSellChunk; ++e) v[e] = __ldg(vp + e * stride);
#pragma unroll
    for (int e = 0; e < kSellChunk; ++e) x[e] = src.at(c[e]);
#pragma unroll
    for (int e = 0; e < kSellChunk; ++e) acc = mul_add_rn(acc, v[e], x[e]);
    cp += kSellChunk * stride;
    vp += kSellChunk * stride;
  }
  for (; k < w; ++k, cp += stride, vp += stride)
    acc = mul_add_rn(acc, __ldg(vp), src.at(__ldg(cp)));
  return acc;
}

}  // namespace ogl
