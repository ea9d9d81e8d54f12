// The body of KB_update (the merged BiCGStab's vector update), shared by
// the standalone KB_update (bicgstab_kb_update.cu) and the KB_update phase
// of the persistent merged-BiCGStab loop (bicgstab_loop.cu):
//   x[i] = x[i] + alpha * p[i] + omega * s[i]      (in place)
//   r[i] = s[i] - omega * t[i]                     (r' into r's buffer)
//   rr += rhat[i] * r'[i] ;  ab += |r'[i]|         (this thread's share)
// vec = 1: over row quads first, first + step, ... of ceil(n / 4), a quad
// wholly below n as float4 loads and stores (x, p, s, t, rhat and r 16-byte
// aligned), the last quad of an n % 4 != 0 row by row; vec = 0: over rows.
// Every element is read and written by the thread that owns it, so in
// place is race-free (r may even be s).  x, p, s, t and r go through plain
// pointers: inside the loop kernel they are rewritten between grid
// barriers, so the non-coherent read-only path must not cache them; rhat
// is the same for the whole launch and may take that path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

__device__ __forceinline__ void kb_update_elem(float alpha, float omega, float& x, float p,
                                               float s, float t, float rhat, float& r,
                                               float& rr, float& ab) {
  x = x + alpha * p;
  x = x + omega * s;
  r = s - omega * t;
  rr += rhat * r;
  ab += fabsf(r);
}

__device__ __forceinline__ void kb_update_rows(float alpha, float omega, float* x, const float* p,
                                               const float* s, const float* t,
                                               const float* __restrict__ rhat, float* r,
                                               int64_t i, int64_t end, int64_t step, float& rr,
                                               float& ab) {
  for (; i < end; i += step) {
    float xv = x[i], rv;
    kb_update_elem(alpha, omega, xv, p[i], s[i], t[i], __ldg(rhat + i), rv, rr, ab);
    x[i] = xv;
    r[i] = rv;
  }
}

__device__ __forceinline__ void kb_update_span(float alpha, float omega, float* x, const float* p,
                                               const float* s, const float* t,
                                               const float* __restrict__ rhat, float* r,
                                               int64_t n, int vec, int64_t first, int64_t step,
                                               float& rr, float& ab) {
  if (!vec) {
    kb_update_rows(alpha, omega, x, p, s, t, rhat, r, first, n, step, rr, ab);
    return;
  }
  float4* x4 = reinterpret_cast<float4*>(x);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  float4* r4 = reinterpret_cast<float4*>(r);
  const int64_t whole = n >> 2;
  for (int64_t u = first; u < whole; u += step) {
    float4 xv = x4[u], rv;
    const float4 pv = p4[u], sv = s4[u], tv = t4[u];
    const float4 hv = __ldg(reinterpret_cast<const float4*>(rhat) + u);
    kb_update_elem(alpha, omega, xv.x, pv.x, sv.x, tv.x, hv.x, rv.x, rr, ab);
    kb_update_elem(alpha, omega, xv.y, pv.y, sv.y, tv.y, hv.y, rv.y, rr, ab);
    kb_update_elem(alpha, omega, xv.z, pv.z, sv.z, tv.z, hv.z, rv.z, rr, ab);
    kb_update_elem(alpha, omega, xv.w, pv.w, sv.w, tv.w, hv.w, rv.w, rr, ab);
    x4[u] = xv;
    r4[u] = rv;
  }
  // the last quad, n % 4 rows, is quad `whole`: its turn is this thread's
  // when whole = first (mod step)
  if ((n & 3) != 0 && first == whole % step)
    kb_update_rows(alpha, omega, x, p, s, t, rhat, r, whole << 2, n, 1, rr, ab);
}

}  // namespace ogl
