// The CSR SpMV row body for Hopper, over a SOURCE FUNCTOR (src.at(j), as in
// dia_rows.cuh): one GROUP of G lanes of a warp (G a power of two, 1..32;
// G = 1 is one thread per row) computes one row
//   y[i] = sum over j in [row_ptr[i], row_ptr[i+1]) of vals[j] * src(cols[j]).
// Used by the standalone CSR SpMV (csr_spmv.cu), which is also the Coo SpMV
// (a device Coo is stored as a Csr).
//
// Arithmetic, which the plain version (kernels/gather_spmv.py
// spmv_csr) repeats step by step: lane l of the group accumulates the
// row's entries l, l + G, l + 2G, ... in order from 0.0f, each product and
// sum rounded on its own (mul_add_rn: no fused multiply-add); then the G
// partial sums combine in a butterfly, v + shfl_xor(v, d) for d = G/2, ...,
// 1, and lane 0 holds the row's sum.  Both sides round the same operations,
// so the kernel and its twin give the same bits.
//
// Design: the lanes of a group read neighbouring entries of cols and vals,
// and neighbouring groups neighbouring rows, so a warp's loads stay within
// few cache lines; the gathers of the source are random (x of a 1M-row
// mesh, 4 MB, sits in the 50 MB L2).  Few lanes per row suit short rows:
// on the H100 G = 1 is the fastest at 7-8 entries per row, so
// kernels/gather_spmv.py csr_group takes G = 1 under 16 entries per row and
// about four entries per lane above.  The
// caller keeps every lane of a warp in the loop until the warp's last group
// is done, as the shuffles take the full mask.  Entry indices are int64 (row_ptr is int32, so nnz
// < 2^31).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // mul_add_rn, XSource

namespace ogl {

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

}  // namespace ogl
