// The CSR SpMV row bodies for Hopper, over a SOURCE FUNCTOR (src.at(j), as
// in dia_rows.cuh): each computes rows
//   y[i] = sum over j in [row_ptr[i], row_ptr[i+1]) of vals[j] * src(cols[j]).
// Used by the standalone CSR SpMV (csr_spmv.cu), which is also the Coo SpMV
// (a device Coo is stored as a Csr), by the K1 phase of the CG loop's Csr
// variants (cg_loop.cu) and by the two SpMV phases of the general-BiCGStab
// loop's Csr variants (bicgstab_gen_loop.cu).
//
// Arithmetic, which the plain version (kernels/gather_spmv.py spmv_csr)
// repeats step by step: lane l of a group of G lanes accumulates the row's
// entries l, l + G, l + 2G, ... in order from 0.0f, each product and sum
// rounded on its own (mul_add_rn: no fused multiply-add); then the G partial
// sums combine in a butterfly, v + shfl_xor(v, d) for d = G/2, ..., 1, and
// lane 0 holds the row's sum.  At G = 1 (one lane per row, no butterfly)
// every body below sums the row's entries in order, so all give the twin's
// bits.
//
// Bodies.
//   csr_group_row<G>  G lanes per row reading neighbouring entries (long
//                     rows: kernels/gather_spmv.py csr_group takes G > 1
//                     from 16 entries per row on mean); its caller keeps
//                     every lane of a warp in the body until the warp's rows
//                     are done (the shuffles take the full mask);
//   csr_row           one lane per row, its entries' loads issued kCsrChunk
//                     at a time before their adds (the standalone SpMV at G
//                     = 1 and the loops' phases).
// At G = 1 a lane walking its own row makes a warp's load instruction touch
// 32 sectors about 32 B apart (kNN-6: 8.1 entries per row), which the L1
// soaks up.  Measured on the H100 in turns (PERF.md §6): csr_row ran
// 1.04-1.05x faster than a loop with one entry's loads in flight at kNN 1M
// and at 8.4M rows; a body that staged each warp's entries in shared memory
// with coalesced loads ran slower than both.  The gathers of the
// source are random (x of a 1M-row mesh, 4 MB, sits in the 50 MB L2).  Entry
// indices are int64 (row_ptr is int32, so nnz < 2^31).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource

namespace ogl {

constexpr int kCsrChunk = 4;  // entries whose loads csr_row issues before adding them

// A Csr matrix as the loop phases read it; read-only for a launch.
struct CsrOperands {
  const int* row_ptr;  // (n + 1,)
  const int* cols;     // (nnz,)
  const float* vals;   // (nnz,)
};

// The sum of row `row` on every lane of its group (lane = this lane's index
// within the group); a lane whose `valid` is false adds nothing but still
// takes part in the shuffles.
template <int G, class Src>
__device__ __forceinline__ float csr_group_row(const int* __restrict__ row_ptr,
                                               const int* __restrict__ cols,
                                               const float* __restrict__ vals, const Src& src,
                                               int64_t row, int lane, bool valid) {
  float acc = 0.0f;
  if (valid) {
    const int64_t end = __ldg(row_ptr + row + 1);
    for (int64_t j = __ldg(row_ptr + row) + lane; j < end; j += G)
      acc = mul_add_rn(acc, __ldg(vals + j), src.at(__ldg(cols + j)));
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, d));
  return acc;
}

// Row i's sum at one lane per row (0 <= i < n).
template <class Src>
__device__ __forceinline__ float csr_row(const int* __restrict__ row_ptr,
                                         const int* __restrict__ cols,
                                         const float* __restrict__ vals, const Src& src,
                                         int64_t i) {
  const int64_t begin = __ldg(row_ptr + i), end = __ldg(row_ptr + i + 1);
  float acc = 0.0f;
  for (int64_t j0 = begin; j0 < end; j0 += kCsrChunk) {
    int c[kCsrChunk];
    float v[kCsrChunk], g[kCsrChunk];
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e) c[e] = j0 + e < end ? __ldg(cols + j0 + e) : 0;
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e) {
      v[e] = j0 + e < end ? __ldg(vals + j0 + e) : 0.0f;
      g[e] = j0 + e < end ? src.at(c[e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e)
      if (j0 + e < end) acc = mul_add_rn(acc, v[e], g[e]);
  }
  return acc;
}

}  // namespace ogl
