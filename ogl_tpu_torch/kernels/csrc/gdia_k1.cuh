// The Gdia row body, shared by the standalone K1 and SpMV (gdia.cu
// `ogl_gdia_k1`, `ogl_gdia_spmv`: the same body without p and beta) and
// the K1 phase of the persistent CG loop's Gdia variants (cg_loop.cu), as
// cg_k1.cuh serves the Dia K1.  Row i = r*128 + l of the (R, 128) view;
// plane k has block-row offset q_k and per-entry source lanes:
//   src_k(i) = (r + q_k) * 128 + lidx[k, r, l]
//   p'[i] = z[i] + beta * p[i] ;  q[i] = sum_k vals[k, r, l] * p'[src_k(i)]
// Sources outside [0, n) are dropped: padding slots (val 0, lane 0) and the
// tail of the last block row, where the TPU reads a zero-padded window.
//
// Design: one thread per row QUAD (rows 4t .. 4t+3, always inside one block
// row since 128 % 4 == 0).  Per plane the thread issues one 16-byte load of
// the four values and one 4-byte load of the four source lanes (the streams
// vals[k, r, l] and lidx[k, r, l] are contiguous in l; the planes are
// padded to R*128 entries, so the quad never reads past them), where four
// threads of one row each issued one load of each; the offsets q_k come from
// a table in shared memory, read as a broadcast.  The four rows' gathers are
// independent, so a thread keeps eight loads of z and p in flight per plane.
// p' at the sources is recomputed from z and p rather than read back: other
// blocks own those rows and may not have written p' yet.  z and p go
// through plain pointers (inside the loop kernel other blocks rewrite them
// between grid barriers); vals and lidx are read-only for a whole launch
// and take the non-coherent path.  Each row accumulates in float32 in plane
// order (the plain version's order); int64 indices.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

constexpr int kGdiaLanes = 128;
constexpr int kGdiaMaxPlanes = 1024;  // the plane-offset table each block stages in shared memory

// One plane's term of a K1 row (kK1: the source is p'(j) = z[j] + beta * p[j])
// or of an SpMV row (the source is z[j], the x of y = A x).
template <bool kK1>
__device__ __forceinline__ void gdia_gather(float& acc, float v, int64_t j, int64_t n,
                                            const float* z, const float* p, float beta) {
  if (j >= 0 && j < n) acc += v * (kK1 ? z[j] + beta * p[j] : z[j]);
}

// Row quad t.  kK1: q and p' of its rows below n; returns their sum of
// p' * q.  Else (the SpMV, z = x): q = A x of its rows (p, beta and pout
// unused); returns 0.  plane = R * 128 (the stride between planes); s_q:
// the np block-row offsets in shared memory; vec != 0: z, p, pout and q are
// 16-byte aligned, so a whole quad below n moves as float4.
template <bool kK1>
__device__ __forceinline__ float gdia_quad(const float* __restrict__ vals,
                                           const int8_t* __restrict__ lidx, const int* s_q,
                                           int np, int64_t plane, const float* z, const float* p,
                                           float beta, float* pout, float* q, int64_t t,
                                           int64_t n, int vec) {
  const int64_t i0 = t << 2;
  const int64_t row = i0 / kGdiaLanes;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int k = 0; k < np; ++k) {
    const int64_t at = static_cast<int64_t>(k) * plane + i0;
    const float4 v = __ldg(reinterpret_cast<const float4*>(vals + at));
    const char4 l = __ldg(reinterpret_cast<const char4*>(lidx + at));
    const int64_t base = (row + s_q[k]) * kGdiaLanes;
    gdia_gather<kK1>(a0, v.x, base + l.x, n, z, p, beta);
    gdia_gather<kK1>(a1, v.y, base + l.y, n, z, p, beta);
    gdia_gather<kK1>(a2, v.z, base + l.z, n, z, p, beta);
    gdia_gather<kK1>(a3, v.w, base + l.w, n, z, p, beta);
  }
  if (vec && i0 + 3 < n) {
    *reinterpret_cast<float4*>(q + i0) = make_float4(a0, a1, a2, a3);
    if (!kK1) return 0.0f;
    const float4 zv = *reinterpret_cast<const float4*>(z + i0);
    const float4 pv = *reinterpret_cast<const float4*>(p + i0);
    const float4 pw = make_float4(zv.x + beta * pv.x, zv.y + beta * pv.y, zv.z + beta * pv.z,
                                  zv.w + beta * pv.w);
    *reinterpret_cast<float4*>(pout + i0) = pw;
    return pw.x * a0 + pw.y * a1 + pw.z * a2 + pw.w * a3;
  }
  const float acc[4] = {a0, a1, a2, a3};
  float dot = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = i0 + e;
    if (i < n) {
      q[i] = acc[e];
      if (kK1) {
        const float pc = z[i] + beta * p[i];
        pout[i] = pc;
        dot += pc * acc[e];
      }
    }
  }
  return dot;
}

// The quads first, first + step, ... of ceil(n / 4); returns this thread's
// share of delta = sum p' * q (0 for the SpMV).
template <bool kK1>
__device__ __forceinline__ float gdia_span(const float* __restrict__ vals,
                                           const int8_t* __restrict__ lidx, const int* s_q,
                                           int np, int64_t plane, const float* z, const float* p,
                                           float beta, float* pout, float* q, int64_t n, int vec,
                                           int64_t first, int64_t step) {
  float dot = 0.0f;
  const int64_t quads = (n + 3) >> 2;
  for (int64_t t = first; t < quads; t += step)
    dot += gdia_quad<kK1>(vals, lidx, s_q, np, plane, z, p, beta, pout, q, t, n, vec);
  return dot;
}

}  // namespace ogl
