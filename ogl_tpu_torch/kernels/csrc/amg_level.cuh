// The row bodies of the AMG level operations on unstructured levels, shared by
// the Ell level smoother (amg_ell_smooth.cu), the Gdia level smoother
// (amg_gdia_smooth.cu) and the pgm transfers (amg_transfer.cu):
//   sweep:    out[i] = x[i] + (relax * invd[i]) * (b[i] - (A x)[i])
//   resid:    out[i] = b[i] - (A x)[i]
//   restrict: rc[c]  = sum of r over aggregate c's fine rows, in fine-row order
//   prolong:  out[i] = x[i] + ec[agg[i]]
// (A x)[i] is the Ell row body (ell_rows.cuh `ell_row`) or the Gdia row-quad
// body (gdia_k1.cuh `gdia_quad_sums`) over the source x, with the operator's
// values in float or bfloat16 (widen.cuh), accumulated in float32.
//
// Arithmetic: every product, sum and difference is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no fused multiply-add), in the order of
// the plain versions (kernels/amg_level.py): the sweep is x + ((relax * invd)
// * (b - A x)), as torch evaluates `x + relax * invd * (b - ax)`; an
// aggregate's sum starts from 0 and adds its members in ascending row order,
// which the plain version repeats member position by member position.  So
// each kernel gives its twin's bits.  Restriction reads an aggregate table
// (the members grouped by aggregate, CSR-style, built once per level on the
// host) and writes each coarse row once: no float atomics, so a result is
// the same on every run.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"
#include "gdia_k1.cuh"

namespace ogl {

// One smoother value from the row's (A x)[i] = ax.
template <bool kSweep>
__device__ __forceinline__ float smooth_value(float x, float b, float invd, float relax,
                                              float ax) {
  const float r = __fsub_rn(b, ax);
  return kSweep ? __fadd_rn(x, __fmul_rn(__fmul_rn(relax, invd), r)) : r;
}

// Row i of an Ell level (the caller's warp holds i's 32-row group).
template <bool kSweep, typename T>
__device__ __forceinline__ float ell_smooth_row(const EllOperandsOf<T>& m, const float* x,
                                                const float* b, const float* invd, float relax,
                                                int64_t i, int64_t n) {
  const float ax = ell_row(m, XSource{x}, i, n);
  return smooth_value<kSweep>(__ldg(x + i), __ldg(b + i), kSweep ? __ldg(invd + i) : 0.0f,
                              relax, ax);
}

// Row quad t of a Gdia level (rows 4t .. 4t+3 below n; plane = R * 128, s_q
// the np block-row offsets in shared memory).
template <bool kSweep, typename T>
__device__ __forceinline__ void gdia_smooth_quad(const T* __restrict__ vals,
                                                 const int8_t* __restrict__ lidx,
                                                 const int* s_q, int np, int64_t plane,
                                                 const float* x, const float* b,
                                                 const float* invd, float relax, float* out,
                                                 int64_t t, int64_t n) {
  float acc[4];
  gdia_quad_sums(vals, lidx, s_q, np, plane, VecSource{x}, t, n, acc);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = (t << 2) + e;
    if (i < n)
      out[i] = smooth_value<kSweep>(__ldg(x + i), __ldg(b + i),
                                    kSweep ? __ldg(invd + i) : 0.0f, relax, acc[e]);
  }
}

// Coarse row c of the restriction: members[starts[c] .. starts[c+1]) are its
// fine rows, ascending.
__device__ __forceinline__ float pgm_restrict_row(const int* __restrict__ starts,
                                                  const int* __restrict__ members,
                                                  const float* __restrict__ r, int64_t c) {
  float acc = 0.0f;
  const int end = __ldg(starts + c + 1);
  for (int k = __ldg(starts + c); k < end; ++k)
    acc = __fadd_rn(acc, __ldg(r + __ldg(members + k)));
  return acc;
}

// Fine row i of the prolongation added to x.
__device__ __forceinline__ float pgm_prolong_row(const float* __restrict__ x,
                                                 const float* __restrict__ ec,
                                                 const int* __restrict__ agg, int64_t i) {
  return __fadd_rn(__ldg(x + i), __ldg(ec + __ldg(agg + i)));
}

}  // namespace ogl
