// The GMRES basis recombination for Hopper, as a body of its own:
//   acc[i] = sum_{k<j} y_k * V_k[i]   (float32 sums, basis float32 or bfloat16)
// run by the standalone launch ogl_gmres_combine (gmres.cu), and written so
// that a later GMRES device loop can take it as its recombination phase.
//
// Arithmetic: for each column, acc = acc + y_k * V_k in k order from 0.0f,
// every product and sum rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as gmres_combine_plain (kernels/gmres.py) writes it, so the
// body and its twin give the same bits in both basis types.
//
// Bound: device-memory bandwidth: the j live rows read once and acc written
// once (j * n * 4 + 4n bytes in float32, j * n * 2 + 4n in bfloat16).
//
// Design: each thread owns a column group of 4 entries (one 16-byte float32
// or 8-byte bfloat16 load per row) and walks the rows in batches of kBatch,
// issuing a batch's loads before it adds any of them; the groups are walked
// grid-stride by a grid of the co-resident CTAs.  Timed on the H100 at j =
// 100 against batches of 1, 3, 4, 6 and 8 rows and bfloat16 groups of 8
// entries (16-byte loads): 2 rows and 4 entries were fastest or within 1%
// at 1M and 8.4M rows in both types (PERF.md, §6, row 24) — the grid's
// threads and their balance, not the depth of a thread's batch, set the
// pace.  A row's storage holds n rounded up to 8 entries at least
// (kernels/gmres.py new_basis), so the last group's vector load stays
// inside the row; only the stores are masked at n.  The basis is read-only
// for the launch and takes the non-coherent path.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {
namespace combine {

constexpr int kThreads = 256;
constexpr int kBatch = 2;  // rows whose loads a thread has in flight at once

__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

// One load of a row's 4 entries starting at entry i (a multiple of 4) and
// the entries as float32: 16 bytes of float32 or 8 of bfloat16.
template <bool BF16>
struct Cols;

template <>
struct Cols<false> {
  using T = float;
  using Raw = float4;
  static constexpr int kCols = 4;
  static __device__ __forceinline__ Raw load(const float* row, int64_t i) {
    return __ldg(reinterpret_cast<const float4*>(row + i));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&e)[kCols]) {
    e[0] = r.x;
    e[1] = r.y;
    e[2] = r.z;
    e[3] = r.w;
  }
};

template <>
struct Cols<true> {
  using T = __nv_bfloat16;
  using Raw = uint2;
  static constexpr int kCols = 4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* row, int64_t i) {
    return __ldg(reinterpret_cast<const uint2*>(row + i));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&e)[kCols]) {
    e[0] = bf16_lo(r.x);
    e[1] = bf16_hi(r.x);
    e[2] = bf16_lo(r.y);
    e[3] = bf16_hi(r.y);
  }
};

// acc = sum_{k<j} y_k V_k at the kCols entries of the group starting at i,
// in k order, each product and sum rounded.
template <bool BF16>
__device__ __forceinline__ void group_sums(const typename Cols<BF16>::T* __restrict__ V,
                                           int64_t ld, const float* __restrict__ y, int j,
                                           int64_t i, float (&acc)[Cols<BF16>::kCols]) {
  using C = Cols<BF16>;
#pragma unroll
  for (int e = 0; e < C::kCols; ++e) acc[e] = 0.0f;
  int k0 = 0;
  for (; k0 + kBatch <= j; k0 += kBatch) {
    typename C::Raw raw[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) raw[b] = C::load(V + static_cast<int64_t>(k0 + b) * ld, i);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const float yk = __ldg(y + k0 + b);
      float e[C::kCols];
      C::widen(raw[b], e);
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(yk, e[c]));
    }
  }
  // the last j % kBatch rows: their loads issued together, then the adds
  const int left = j - k0;
  if (left > 0) {
    typename C::Raw raw[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (b < left) raw[b] = C::load(V + static_cast<int64_t>(k0 + b) * ld, i);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (b < left) {
        const float yk = __ldg(y + k0 + b);
        float e[C::kCols];
        C::widen(raw[b], e);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(yk, e[c]));
      }
    }
  }
}

// The groups first, first + step, ... of n entries: out[i] = acc[i] for
// i < n (as float4 where the whole group lies below n; out 16-byte
// aligned).
template <bool BF16>
__device__ __forceinline__ void combine_groups(const typename Cols<BF16>::T* __restrict__ V,
                                               int64_t ld, const float* __restrict__ y, int j,
                                               float* __restrict__ out, int64_t n,
                                               int64_t first, int64_t step) {
  constexpr int kCols = Cols<BF16>::kCols;
  const int64_t groups = (n + kCols - 1) / kCols;
  for (int64_t g = first; g < groups; g += step) {
    const int64_t i = g * kCols;
    float acc[kCols];
    group_sums<BF16>(V, ld, y, j, i, acc);
#pragma unroll
    for (int q = 0; q < kCols; q += 4) {
      if (i + q + 4 <= n) {
        *reinterpret_cast<float4*>(out + i + q) =
            make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + q + e < n) out[i + q + e] = acc[q + e];
      }
    }
  }
}

}  // namespace combine
}  // namespace ogl
