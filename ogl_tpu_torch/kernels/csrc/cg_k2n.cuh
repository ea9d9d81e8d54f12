// The body of K2n (the K2 of a CG preconditioned by a rich preconditioner,
// here the AMG cycle), shared by the standalone K2n (cg_k2n.cu) and the K2n
// phase of the device V-cycle's CG loop (amg_loop.cuh):
//   x[i] += alpha * p[i] ;  r[i] -= alpha * q[i]      (in place)
//   ab += |r'[i]|                                     (this thread's share)
// over rows first, first + step, ... (vec = 0) or over row quads (vec = 1:
// float4 loads and stores, which need n % 4 == 0 and all four streams
// 16-byte aligned).  z and rho come from the preconditioner's cycle, so no
// z is written and no r.z summed.  Every element is read and written by the
// thread that owns it, so in place is race-free.  The streams go through
// plain pointers: inside the loop kernel they are rewritten between grid
// barriers, so the non-coherent read-only path must not cache them.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

__device__ __forceinline__ void k2n_elem(float alpha, float& x, float& r, float p, float q,
                                         float& ab) {
  x = x + alpha * p;
  r = r - alpha * q;
  ab += fabsf(r);
}

__device__ __forceinline__ void k2n_span(float alpha, float* x, float* r, const float* p,
                                         const float* q, int64_t n, int vec, int64_t first,
                                         int64_t step, float& ab) {
  if (vec) {
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* r4 = reinterpret_cast<float4*>(r);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int64_t i = first; i < (n >> 2); i += step) {
      float4 xv = x4[i], rv = r4[i];
      const float4 pv = p4[i], qv = q4[i];
      k2n_elem(alpha, xv.x, rv.x, pv.x, qv.x, ab);
      k2n_elem(alpha, xv.y, rv.y, pv.y, qv.y, ab);
      k2n_elem(alpha, xv.z, rv.z, pv.z, qv.z, ab);
      k2n_elem(alpha, xv.w, rv.w, pv.w, qv.w, ab);
      x4[i] = xv;
      r4[i] = rv;
    }
  } else {
    for (int64_t i = first; i < n; i += step) {
      float xv = x[i], rv = r[i];
      k2n_elem(alpha, xv, rv, p[i], q[i], ab);
      x[i] = xv;
      r[i] = rv;
    }
  }
}

}  // namespace ogl
