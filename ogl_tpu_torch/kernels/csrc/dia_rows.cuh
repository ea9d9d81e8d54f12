// The Dia SpMV row body for Hopper, over a SOURCE FUNCTOR:
//   y[i] = sum_k data[k*n + i] * src(i + off_k)   (terms outside [0, n) dropped)
// shared by the standalone Dia SpMV (dia_spmv.cu, whose source is x[j]) and
// the two SpMV phases of the persistent general-BiCGStab loop
// (bicgstab_gen_loop.cu, whose sources are recomputed at each neighbour:
// M^-1 (r + beta (p - omega v)) and M^-1 (r - alpha v')), so all run the same
// arithmetic.  A source is a struct with
//   float  at(int64_t j) const;    // the source at row j, 0 <= j < n
//   float4 quad(int64_t u) const;  // the sources at rows 4u .. 4u+3, all < n
//
// Arithmetic: each row accumulates in float32 in diagonal order, every
// product and sum rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), which is what the plain version computes
// (dia_spmv_plain: y = y + data[k] * x_shifted, op by op), so the kernel and
// its twin give the same bits.
//
// Design: vec = 1 walks row QUADS t (rows 4t .. 4t+3; n % 4 == 0 and every
// stream 16-byte aligned): per diagonal one float4 load of the four
// coefficients, and the four sources i0 + off .. i0 + off + 3 taken from the
// aligned quads that hold them, u = t + (off >> 2) and, when off % 4 != 0,
// u + 1 — one or two float4 loads per source stream where one thread per
// row issued four scalar loads (the technique of bicgstab_k1b.cuh; the TPU
// kernel shifts a halo window with lane rolls).  With n % 4 == 0 an aligned
// quad lies wholly inside or wholly outside [0, n), so a quad outside
// contributes no term, as the plain version drops those terms.  The offset
// and its shift off & 3 are the same for the whole grid, so the choice of
// quads never diverges inside a warp.  The centre quad (the sources at the
// quad's own rows) is formed once by the caller, which also needs it (the
// loop writes p' and s there), and serves the diagonal of offset 0.  vec = 0
// walks rows, one thread per row, for any n and alignment.  The
// coefficients are read-only for a launch and take the non-coherent path;
// what the sources read is the functor's business.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_k1.cuh"  // kMaxDiags, the offsets table each block stages

namespace ogl {

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc + d * s with both operations rounded: the plain version's y + d * x.
__device__ __forceinline__ float mul_add_rn(float acc, float d, float s) {
  return __fadd_rn(acc, __fmul_rn(d, s));
}

// Row i (vec = 0); centre = src.at(i), which serves the diagonal of offset 0.
template <class Src>
__device__ __forceinline__ float dia_row(const float* __restrict__ data, const int* s_off, int nd,
                                         const Src& src, float centre, int64_t i, int64_t n) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int off = s_off[k];
    const int64_t j = i + off;
    if (j >= 0 && j < n)
      acc = mul_add_rn(acc, __ldg(data + (int64_t)k * n + i), off == 0 ? centre : src.at(j));
  }
  return acc;
}

// Row quad t (vec = 1, n % 4 == 0); centre = src.quad(t).
template <class Src>
__device__ __forceinline__ float4 dia_quad(const float* __restrict__ data, const int* s_off,
                                           int nd, const Src& src, const float4& centre,
                                           int64_t t, int64_t n) {
  const int64_t quads = n >> 2;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < nd; ++k) {
    const int off = s_off[k];
    const float4 d = __ldg(reinterpret_cast<const float4*>(data + (int64_t)k * n) + t);
    const float dk[4] = {d.x, d.y, d.z, d.w};
    if (off == 0) {
      const float ck[4] = {centre.x, centre.y, centre.z, centre.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = mul_add_rn(acc[e], dk[e], ck[e]);
      continue;
    }
    const int sh = off & 3;  // the sources are elements sh .. sh + 3 of quads u, u + 1
    const int64_t u = t + (off >> 2);
    const bool lo_in = u >= 0 && u < quads;
    const bool hi_in = sh != 0 && u + 1 >= 0 && u + 1 < quads;
    const float4 lo = lo_in ? src.quad(u) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hi = hi_in ? src.quad(u + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = sh + e;
      if (at < 4 ? lo_in : hi_in)
        acc[e] = mul_add_rn(acc[e], dk[e], at < 4 ? elem(lo, at) : elem(hi, at - 4));
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The source x[j] of the standalone SpMV: read-only for the launch.
struct XSource {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return __ldg(x + j); }
  __device__ __forceinline__ float4 quad(int64_t u) const {
    return __ldg(reinterpret_cast<const float4*>(x) + u);
  }
};

// K1's: p'(j) = z[j] + beta * p[j], rounded as `z + beta * p` rounds it.  The
// standalone K1 reads z and p through the read-only path (kLdg); a loop
// kernel rewrites them between grid barriers, so it takes plain loads (the
// non-coherent path could return values from before a barrier).
template <bool kLdg>
struct K1Source {
  const float* z;
  const float* p;
  float beta;
  __device__ __forceinline__ float load(const float* a, int64_t j) const {
    if constexpr (kLdg) {
      return __ldg(a + j);
    } else {
      return a[j];
    }
  }
  __device__ __forceinline__ float at(int64_t j) const {
    return __fadd_rn(load(z, j), __fmul_rn(beta, load(p, j)));
  }
};

}  // namespace ogl
