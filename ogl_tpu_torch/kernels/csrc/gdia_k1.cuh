// The Gdia row body, shared by the standalone K1 and SpMV (gdia.cu
// `ogl_gdia_k1`, `ogl_gdia_spmv`: the same body without p and beta), the K1
// phase of the persistent CG loop's Gdia variants (cg_loop.cu), as
// cg_k1.cuh serves the Dia K1, and the two SpMV phases of the
// general-BiCGStab loop's Gdia variants (bicgstab_gen_loop.cu), each over its
// own source functor (`gdia_quad_sums`).  Row i = r*128 + l of the (R, 128) view;
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
// order (the plain version's order), every product and sum rounded on its
// own (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// separate ops round, so a row's sum and p' are the plain version's bits;
// int64 indices.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // K1Source
#include "widen.cuh"      // load4_f32

namespace ogl {

constexpr int kGdiaLanes = 128;
constexpr int kGdiaMaxPlanes = 1024;  // the plane-offset table each block stages in shared memory

// The sources of the Gdia row body: a struct with `float at(int64_t j) const`,
// the source at row j (0 <= j < n).  K1's is p'(j) = z[j] + beta * p[j]
// (dia_rows.cuh K1Source, plain loads); the SpMV's is x[j]; the
// general-BiCGStab loop's Gdia phases (bicgstab_gen_loop.cu) pass their own,
// recomputed at each gathered row.

struct VecSource {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return x[j]; }
};

// One plane's term: the source at row j, dropped outside [0, n).
template <class Src>
__device__ __forceinline__ void gdia_gather(float& acc, float v, int64_t j, int64_t n,
                                            const Src& src) {
  if (j >= 0 && j < n) acc = __fadd_rn(acc, __fmul_rn(v, src.at(j)));
}

// The sums of the rows 4t .. 4t+3 of row quad t (rows at or past n read
// padding: value 0, lane 0, and their sums go unused).  plane = R * 128 (the
// stride between planes); s_q: the np block-row offsets in shared memory.
// The values are float, or bfloat16 for the AMG level smoother
// (amg_gdia_smooth.cu: one 8-byte load of a quad's four), widened to float.
template <typename T, class Src>
__device__ __forceinline__ void gdia_quad_sums(const T* __restrict__ vals,
                                               const int8_t* __restrict__ lidx, const int* s_q,
                                               int np, int64_t plane, const Src& src, int64_t t,
                                               int64_t n, float (&acc)[4]) {
  const int64_t i0 = t << 2;
  const int64_t row = i0 / kGdiaLanes;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int k = 0; k < np; ++k) {
    const int64_t at = static_cast<int64_t>(k) * plane + i0;
    const float4 v = load4_f32(vals + at);
    const char4 l = __ldg(reinterpret_cast<const char4*>(lidx + at));
    const int64_t base = (row + s_q[k]) * kGdiaLanes;
    gdia_gather(a0, v.x, base + l.x, n, src);
    gdia_gather(a1, v.y, base + l.y, n, src);
    gdia_gather(a2, v.z, base + l.z, n, src);
    gdia_gather(a3, v.w, base + l.w, n, src);
  }
  acc[0] = a0;
  acc[1] = a1;
  acc[2] = a2;
  acc[3] = a3;
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
  float acc[4];
  if (kK1)
    gdia_quad_sums(vals, lidx, s_q, np, plane, K1Source<false>{z, p, beta}, t, n, acc);
  else
    gdia_quad_sums(vals, lidx, s_q, np, plane, VecSource{z}, t, n, acc);
  const float a0 = acc[0], a1 = acc[1], a2 = acc[2], a3 = acc[3];
  if (vec && i0 + 3 < n) {
    *reinterpret_cast<float4*>(q + i0) = make_float4(a0, a1, a2, a3);
    if (!kK1) return 0.0f;
    const float4 zv = *reinterpret_cast<const float4*>(z + i0);
    const float4 pv = *reinterpret_cast<const float4*>(p + i0);
    const float4 pw = make_float4(
        __fadd_rn(zv.x, __fmul_rn(beta, pv.x)), __fadd_rn(zv.y, __fmul_rn(beta, pv.y)),
        __fadd_rn(zv.z, __fmul_rn(beta, pv.z)), __fadd_rn(zv.w, __fmul_rn(beta, pv.w)));
    *reinterpret_cast<float4*>(pout + i0) = pw;
    return pw.x * a0 + pw.y * a1 + pw.z * a2 + pw.w * a3;
  }
  float dot = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = i0 + e;
    if (i < n) {
      q[i] = acc[e];
      if (kK1) {
        const float pc = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
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
