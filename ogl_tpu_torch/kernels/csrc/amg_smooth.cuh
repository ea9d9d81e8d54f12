// The row body of the AMG smoother passes, shared by the standalone sweep
// and residual (amg_smooth.cu) and the smoothing phases of the device
// V-cycle (amg_loop.cuh), so both run the same arithmetic:
//   (A x)[i] = sum_k data[k*n + i] * x(i + off_k)   (terms outside [0, n) dropped)
//   sweep:  out[i] = x(i) + (relax * invd[i]) * (b[i] - (A x)[i])
//   resid:  out[i] = b[i] - (A x)[i]
// The coefficients are float or __nv_bfloat16 (the reference packs its
// smoother operators in bfloat16 to halve their bytes), widened to float;
// each row accumulates in float32 in diagonal order, the plain version's
// order.
//
// x(j) comes from a source: a buffer (BufSrc; kLdg: through the read-only
// path, for a buffer nobody writes during the launch) or the zero-guess
// first sweep x1 = relax * invd * b (ZeroGuessSrc: the cycle's pre-smooth
// starts from zero, so its first sweep needs no A x and the next sweep
// recomputes x1 at its neighbours instead of reading a stored x1).
//
// Design: vec = 1 walks row QUADS t (rows 4t .. 4t+3; n % 4 == 0 and every
// stream aligned): per diagonal one 16-byte load of four float
// coefficients or one 8-byte load of four bfloat16 ones, and x at the four
// sources i0 + off .. i0 + off + 3 from the aligned quads that hold them,
// u = t + (off >> 2) and, when off % 4 != 0, u + 1 (as bicgstab_k1b.cuh
// does): one or two float4 loads where one thread per row issued four
// scalar loads.  With n % 4 == 0 an aligned quad lies wholly inside or
// wholly outside [0, n), so an outside quad contributes no term.  The centre
// quad x(i0 .. i0+3) is loaded once and also serves the diagonal of offset
// 0.  vec = 0 walks rows, one thread per row, for any n and alignment.
// Vectors rewritten inside a loop launch (b = r, the x buffers) go through
// plain loads; the coefficients and invd are read-only for a whole launch.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_k1.cuh"  // kMaxDiags, the offsets table each block stages

namespace ogl {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float quad_elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The four coefficients data[idx .. idx+3] (idx a multiple of 4), widened.
__device__ __forceinline__ float4 coef4(const float* __restrict__ data, int64_t idx) {
  return __ldg(reinterpret_cast<const float4*>(data + idx));
}
__device__ __forceinline__ float4 coef4(const __nv_bfloat16* __restrict__ data, int64_t idx) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(data + idx));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool kLdg>
struct BufSrc {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return kLdg ? __ldg(x + j) : x[j]; }
  __device__ __forceinline__ float4 quad(int64_t u) const {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    return kLdg ? __ldg(x4 + u) : x4[u];
  }
};

// x1 = (relax * invd) * b, the zero-guess first sweep (b may be rewritten
// between barriers of a loop launch: plain loads).
struct ZeroGuessSrc {
  const float* __restrict__ invd;
  const float* b;
  float relax;
  __device__ __forceinline__ float at(int64_t j) const { return (relax * __ldg(invd + j)) * b[j]; }
  __device__ __forceinline__ float4 quad(int64_t u) const {
    const float4 d = __ldg(reinterpret_cast<const float4*>(invd) + u);
    const float4 v = reinterpret_cast<const float4*>(b)[u];
    return make_float4((relax * d.x) * v.x, (relax * d.y) * v.y, (relax * d.z) * v.z,
                       (relax * d.w) * v.w);
  }
};

// (A x)[i], one row.
template <typename T, class Src>
__device__ __forceinline__ float ax_row(const T* __restrict__ data, const int* s_off, int nd,
                                        const Src& src, int64_t i, int64_t n) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) acc += widen(data[(int64_t)k * n + i]) * src.at(j);
  }
  return acc;
}

// (A x) over the row quad t into acc; centre = x over quad t.
template <typename T, class Src>
__device__ __forceinline__ void ax_quad(const T* __restrict__ data, const int* s_off, int nd,
                                        const Src& src, int64_t t, int64_t n,
                                        const float4& centre, float (&acc)[4]) {
  const int64_t quads = n >> 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int off = s_off[k];
    const float4 d = coef4(data, (int64_t)k * n + 4 * t);
    const float dk[4] = {d.x, d.y, d.z, d.w};
    if (off == 0) {
      const float xk[4] = {centre.x, centre.y, centre.z, centre.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += dk[e] * xk[e];
      continue;
    }
    const int sh = off & 3;  // the sources are elements sh .. sh + 3 of quads u, u + 1
    const int64_t u = t + (off >> 2);
    const bool lo_in = u >= 0 && u < quads;
    const bool hi_in = sh != 0 && u + 1 >= 0 && u + 1 < quads;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 lo = lo_in ? src.quad(u) : zero;
    const float4 hi = hi_in ? src.quad(u + 1) : zero;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = sh + e;
      if (at < 4 ? lo_in : hi_in)
        acc[e] += dk[e] * (at < 4 ? quad_elem(lo, at) : quad_elem(hi, at - 4));
    }
  }
}

// One sweep value at row i: x(i) + (relax * invd[i]) * (b[i] - (A x)[i]).
template <typename T, class Src>
__device__ __forceinline__ float sweep_row(const T* __restrict__ data, const int* s_off, int nd,
                                           const Src& src, const float* b,
                                           const float* __restrict__ invd, float relax,
                                           int64_t i, int64_t n) {
  const float acc = ax_row(data, s_off, nd, src, i, n);
  return src.at(i) + (relax * __ldg(invd + i)) * (b[i] - acc);
}

// The sweep over row quad t into v[0..3].
template <typename T, class Src>
__device__ __forceinline__ void sweep_quad(const T* __restrict__ data, const int* s_off, int nd,
                                           const Src& src, const float* b,
                                           const float* __restrict__ invd, float relax,
                                           int64_t t, int64_t n, float (&v)[4]) {
  const float4 xc = src.quad(t);
  float acc[4];
  ax_quad(data, s_off, nd, src, t, n, xc, acc);
  const float4 bv = reinterpret_cast<const float4*>(b)[t];
  const float4 dv = __ldg(reinterpret_cast<const float4*>(invd) + t);
  v[0] = xc.x + (relax * dv.x) * (bv.x - acc[0]);
  v[1] = xc.y + (relax * dv.y) * (bv.y - acc[1]);
  v[2] = xc.z + (relax * dv.z) * (bv.z - acc[2]);
  v[3] = xc.w + (relax * dv.w) * (bv.w - acc[3]);
}

// The residual over row quad t into v[0..3].
template <typename T, class Src>
__device__ __forceinline__ void resid_quad(const T* __restrict__ data, const int* s_off, int nd,
                                           const Src& src, const float* b, int64_t t, int64_t n,
                                           float (&v)[4]) {
  float acc[4];
  ax_quad(data, s_off, nd, src, t, n, src.quad(t), acc);
  const float4 bv = reinterpret_cast<const float4*>(b)[t];
  v[0] = bv.x - acc[0];
  v[1] = bv.y - acc[1];
  v[2] = bv.z - acc[2];
  v[3] = bv.w - acc[3];
}

}  // namespace ogl
