// The row body of K1B (the merged BiCGStab's stencil pass), shared by the
// standalone K1B (bicgstab.cu) and the two K1B phases of the persistent
// merged-BiCGStab loop (bicgstab_loop.cu), so both run the same arithmetic:
//   w(j) = a[j] + ca * b[j] + cb * c[j]         (c is b when kBisC)
//   q[i] = sum_k data[k*n + i] * w(i + off_k)   (terms outside [0, n) dropped)
//   w[i] = w(i) ;  sums += {rhat[i] * q[i] (kRhat), q[i] * w[i], q[i] * q[i]}
// w at the neighbours is recomputed from a, b and c rather than read back:
// other blocks own those rows and may not have written w yet.
//
// kBisC: b and c are one vector (the second K1B of an iteration, s = r -
// alpha * v'), read once per source: one stream less per source than the
// general form.  kRhat: read rhat and sum rhat . q (the loop's second phase
// needs only q.w and q.q, so it reads no rhat).
//
// Design: vec = 1 walks row QUADS t (rows 4t .. 4t+3; n % 4 == 0 and every
// stream 16-byte aligned): per diagonal one float4 load of the four
// coefficients, and w at the four sources i0 + off .. i0 + off + 3 taken from
// the aligned quads that hold them, u = t + (off >> 2) and, when off % 4 !=
// 0, u + 1: one or two float4 loads per vector where one thread per row
// issued four scalar loads (the TPU kernel shifts a halo window the same
// way, with lane rolls).  With n % 4 == 0 an aligned quad lies wholly
// inside or wholly outside [0, n), so a source quad outside contributes no
// term, as the plain version drops those terms.  The offset is the same for
// the whole grid, so the choice of quads and the shift off & 3 never
// diverge inside a warp.  The centre quad w(i0 .. i0+3) is formed once and
// also serves the diagonal of offset 0.  vec = 0 walks rows, one thread per
// row, for any n and alignment.  Each row accumulates in float32 in
// diagonal order (the plain version's order).  a, b, c go through plain
// pointers (inside the loop kernel other blocks rewrite them between grid
// barriers); data and rhat are read-only for a whole launch and take the
// non-coherent path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_k1.cuh"     // kMaxDiags, the offsets table each block stages
#include "dia_rows.cuh"  // elem

namespace ogl {

template <bool kBisC>
__device__ __forceinline__ float k1b_w(const float* a, const float* b, const float* c, float ca,
                                       float cb, int64_t j) {
  const float bj = b[j];
  return a[j] + ca * bj + cb * (kBisC ? bj : c[j]);
}

// w over the aligned quad u (rows 4u .. 4u+3), all four below n.
template <bool kBisC>
__device__ __forceinline__ float4 k1b_w4(const float* a, const float* b, const float* c,
                                         float ca, float cb, int64_t u) {
  const float4 av = reinterpret_cast<const float4*>(a)[u];
  const float4 bv = reinterpret_cast<const float4*>(b)[u];
  const float4 cv = kBisC ? bv : reinterpret_cast<const float4*>(c)[u];
  return make_float4(av.x + ca * bv.x + cb * cv.x, av.y + ca * bv.y + cb * cv.y,
                     av.z + ca * bv.z + cb * cv.z, av.w + ca * bv.w + cb * cv.w);
}

// Row i (vec = 0): writes w[i] and q[i], adds its terms to sums.
template <bool kBisC, bool kRhat>
__device__ __forceinline__ void k1b_row(const float* __restrict__ data, const int* s_off, int nd,
                                        const float* a, const float* b, const float* c,
                                        const float* __restrict__ rhat, float ca, float cb,
                                        float* w, float* q, int64_t i, int64_t n,
                                        float (&sums)[3]) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) acc += __ldg(data + (int64_t)k * n + i) * k1b_w<kBisC>(a, b, c, ca, cb, j);
  }
  const float wc = k1b_w<kBisC>(a, b, c, ca, cb, i);
  w[i] = wc;
  q[i] = acc;
  if (kRhat) sums[0] += __ldg(rhat + i) * acc;
  sums[1] += acc * wc;
  sums[2] += acc * acc;
}

// Row quad t (vec = 1, n % 4 == 0): writes w and q of rows 4t .. 4t+3 as
// float4, adds their terms to sums.
template <bool kBisC, bool kRhat>
__device__ __forceinline__ void k1b_quad(const float* __restrict__ data, const int* s_off, int nd,
                                         const float* a, const float* b, const float* c,
                                         const float* __restrict__ rhat, float ca, float cb,
                                         float* w, float* q, int64_t t, int64_t n,
                                         float (&sums)[3]) {
  const int64_t quads = n >> 2;
  const float4 wc = k1b_w4<kBisC>(a, b, c, ca, cb, t);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < nd; ++k) {
    const int off = s_off[k];
    const float4 d = __ldg(reinterpret_cast<const float4*>(data + (int64_t)k * n) + t);
    const float dk[4] = {d.x, d.y, d.z, d.w};
    if (off == 0) {
      const float wk[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += dk[e] * wk[e];
      continue;
    }
    const int sh = off & 3;  // the sources are elements sh .. sh + 3 of quads u, u + 1
    const int64_t u = t + (off >> 2);
    const bool lo_in = u >= 0 && u < quads;
    const bool hi_in = sh != 0 && u + 1 >= 0 && u + 1 < quads;
    const float4 lo = lo_in ? k1b_w4<kBisC>(a, b, c, ca, cb, u) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hi = hi_in ? k1b_w4<kBisC>(a, b, c, ca, cb, u + 1)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = sh + e;
      if (at < 4 ? lo_in : hi_in) acc[e] += dk[e] * (at < 4 ? elem(lo, at) : elem(hi, at - 4));
    }
  }
  reinterpret_cast<float4*>(w)[t] = wc;
  reinterpret_cast<float4*>(q)[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (kRhat) {
    const float4 rv = __ldg(reinterpret_cast<const float4*>(rhat) + t);
    sums[0] += rv.x * acc[0] + rv.y * acc[1] + rv.z * acc[2] + rv.w * acc[3];
  }
  sums[1] += acc[0] * wc.x + acc[1] * wc.y + acc[2] * wc.z + acc[3] * wc.w;
  sums[2] += acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3];
}

// The rows (vec = 0) or row quads (vec = 1) first, first + step, ...: this
// thread's share of K1B, its terms added to sums.
template <bool kBisC, bool kRhat>
__device__ __forceinline__ void k1b_span(const float* __restrict__ data, const int* s_off, int nd,
                                         const float* a, const float* b, const float* c,
                                         const float* __restrict__ rhat, float ca, float cb,
                                         float* w, float* q, int64_t n, int vec, int64_t first,
                                         int64_t step, float (&sums)[3]) {
  if (vec) {
    for (int64_t t = first; t < (n >> 2); t += step)
      k1b_quad<kBisC, kRhat>(data, s_off, nd, a, b, c, rhat, ca, cb, w, q, t, n, sums);
  } else {
    for (int64_t i = first; i < n; i += step)
      k1b_row<kBisC, kRhat>(data, s_off, nd, a, b, c, rhat, ca, cb, w, q, i, n, sums);
  }
}

}  // namespace ogl
