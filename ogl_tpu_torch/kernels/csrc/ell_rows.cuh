// The Ell SpMV row body for Hopper, over a SOURCE FUNCTOR (src.at(j), as in
// dia_rows.cuh): one thread per row of the slot-major (K, n) storage,
//   y[i] = sum_k vals[k*n + i] * src(cols[k*n + i]),
// padding pointing at the row itself with value 0.  Shared by the Ell SpMV
// (ell_spmv.cu) and the Ell part of the Hybrid SpMV (hybrid_spmv.cu).
//
// Arithmetic: the row accumulates in float32 in slot order from 0.0f, every
// product and sum rounded on its own (mul_add_rn), padding included — what
// the plain version (kernels/gather_spmv.py spmv_ell: y = y + vals[k]
// * x[cols[k]], slot by slot) computes, so the two give the same bits.
//
// Design: the storage is slot-major, so the threads of a warp read one slot
// of 32 neighbouring rows at neighbouring addresses (one 128-byte line for
// the values, one for the columns); the reference's row-major (n, K) would
// read them K * 4 bytes apart.  The source gathers are random.  Indices are
// int64 (k * n + i can pass 2^31).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource

namespace ogl {

template <class Src>
__device__ __forceinline__ float ell_row(const int* __restrict__ cols,
                                         const float* __restrict__ vals, int k_width,
                                         const Src& src, int64_t i, int64_t n) {
  float acc = 0.0f;
  for (int k = 0; k < k_width; ++k) {
    const int64_t e = static_cast<int64_t>(k) * n + i;
    acc = mul_add_rn(acc, __ldg(vals + e), src.at(__ldg(cols + e)));
  }
  return acc;
}

}  // namespace ogl
