// The body of K2 (the Jacobi-preconditioned K2), shared by the standalone K2
// (cg_k2.cu) and the K2 phase of the persistent CG loop's Jacobi variants
// (cg_loop.cu):
//   x[i] += alpha * p[i] ;  r[i] -= alpha * q[i] ;  z[i] = invd[i] * r'[i]   (in place)
//   rz += r'[i] * z'[i] ;  ab += |r'[i]|                                      (this thread's share)
// over rows first, first + step, ... (vec = 0) or over row quads (vec = 1:
// float4 loads and stores, which need n % 4 == 0 and all six streams
// 16-byte aligned).  Every element is read and written by the thread that
// owns it, so in place is race-free.  x, r, z, p and q go through plain
// pointers: inside the loop kernel they are rewritten between grid
// barriers, so the non-coherent read-only path must not cache them; invd
// is the same for the whole launch and may take that path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

__device__ __forceinline__ float k2_elem(float alpha, float& x, float& r, float& z, float p,
                                         float q, float invd, float& ab) {
  x = x + alpha * p;
  r = r - alpha * q;
  z = invd * r;
  ab += fabsf(r);
  return r * z;
}

__device__ __forceinline__ void k2_span(float alpha, float* x, float* r, float* z,
                                        const float* p, const float* q,
                                        const float* __restrict__ invd, int64_t n, int vec,
                                        int64_t first, int64_t step, float& rz, float& ab) {
  if (vec) {
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* r4 = reinterpret_cast<float4*>(r);
    float4* z4 = reinterpret_cast<float4*>(z);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* d4 = reinterpret_cast<const float4*>(invd);
    for (int64_t i = first; i < (n >> 2); i += step) {
      float4 xv = x4[i], rv = r4[i], zv;
      const float4 pv = p4[i], qv = q4[i], dv = __ldg(d4 + i);
      rz += k2_elem(alpha, xv.x, rv.x, zv.x, pv.x, qv.x, dv.x, ab);
      rz += k2_elem(alpha, xv.y, rv.y, zv.y, pv.y, qv.y, dv.y, ab);
      rz += k2_elem(alpha, xv.z, rv.z, zv.z, pv.z, qv.z, dv.z, ab);
      rz += k2_elem(alpha, xv.w, rv.w, zv.w, pv.w, qv.w, dv.w, ab);
      x4[i] = xv;
      r4[i] = rv;
      z4[i] = zv;
    }
  } else {
    for (int64_t i = first; i < n; i += step) {
      float xv = x[i], rv = r[i], zv;
      rz += k2_elem(alpha, xv, rv, zv, p[i], q[i], __ldg(invd + i), ab);
      x[i] = xv;
      r[i] = rv;
      z[i] = zv;
    }
  }
}

}  // namespace ogl
