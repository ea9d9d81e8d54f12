// The row body of KA (the pipelined CG's stencil pass), shared by the
// standalone KA (cg_pipe.cu) and the KA phase of the persistent
// pipelined-CG loop (cg_pipe_loop.cu), so both run the same arithmetic:
//   u(j) = invd[j] * r[j]        (r[j] with identity)
//   w[i] = sum_k data[k*n + i] * u(i + off_k)   (terms outside [0, n) dropped)
//   sums += {r[i] * u(i), w[i] * u(i), |r[i]|}  (gamma, delta, ||r||_1)
// u at the neighbours is recomputed from r and invd rather than written, as
// K1 recomputes p' (cg_k1.cuh): no u stream.  r is read through a plain
// pointer (no __restrict__, no __ldg): inside the loop kernel other blocks
// rewrite it between grid barriers, and the non-coherent read-only path
// could return values from before a barrier.  data and invd are the same
// for a whole launch and may take that path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_k1.cuh"  // kMaxDiags, the offsets table each block stages

namespace ogl {

// Row i: writes w[i], adds its three terms to sums.  s_off: the nd offsets
// in shared memory.
template <bool kJacobi>
__device__ __forceinline__ void ka_row(const float* __restrict__ data, const int* s_off, int nd,
                                       const float* r, const float* __restrict__ invd, float* w,
                                       int64_t i, int64_t n, float (&sums)[3]) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) {
      const float u = kJacobi ? __ldg(invd + j) * r[j] : r[j];
      acc += data[(int64_t)k * n + i] * u;
    }
  }
  const float rc = r[i];
  const float uc = kJacobi ? __ldg(invd + i) * rc : rc;
  w[i] = acc;
  sums[0] += rc * uc;
  sums[1] += acc * uc;
  sums[2] += fabsf(rc);
}

}  // namespace ogl
