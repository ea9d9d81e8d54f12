// The row body of K1, shared by the standalone K1 (cg_k1.cu) and the K1
// phases of the persistent CG loop (cg_loop.cu) and of the device V-cycle's
// CG loop (amg_loop.cuh), so all run the same arithmetic:
//   p'(j) = z[j] + beta * p[j]
//   q[i]  = sum_k data[k*n + i] * p'(i + off_k)   (terms outside [0, n) dropped)
// p' at the neighbours is recomputed from z and p rather than read back:
// other blocks own those rows and may not have written their p' yet.  z and
// p are read through plain pointers (no __restrict__, no __ldg): inside the
// loop kernel other blocks rewrite them between grid barriers, and the
// non-coherent read-only path could return values from before a barrier.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

constexpr int kMaxDiags = 64;  // the offsets table each block stages in shared memory

// q[i]; *pc = p'(i).  s_off: the nd offsets in shared memory.
__device__ __forceinline__ float k1_row(const float* __restrict__ data, const int* s_off,
                                        int nd, const float* z, const float* p, float beta,
                                        int64_t i, int64_t n, float* pc) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) {
      const float pw = z[j] + beta * p[j];
      acc += data[(int64_t)k * n + i] * pw;
    }
  }
  *pc = z[i] + beta * p[i];
  return acc;
}

}  // namespace ogl
