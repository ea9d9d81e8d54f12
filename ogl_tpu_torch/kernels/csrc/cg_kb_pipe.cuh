// The body of KB_pipe (the pipelined CG's vector update), shared by the
// standalone KB_pipe (cg_kb_pipe.cu) and the KB_pipe phase of the persistent
// pipelined-CG loop (cg_pipe_loop.cu):
//   u = invd[i] * r[i]  (r[i] with identity), formed before r is stored
//   p[i] = u + beta * p[i] ;  s[i] = w[i] + beta * s[i]
//   x[i] += alpha * p'[i] ;  r[i] -= alpha * s'[i]          (in place)
// No sums.  vec = 1: over row quads first, first + step, ... of ceil(n / 4),
// a quad wholly below n as float4 loads and stores (w, p, s, x, r and invd
// 16-byte aligned), the last quad of an n % 4 != 0 row by row; vec = 0:
// over rows.  Every element is read and written by the thread that owns it,
// so in place is race-free.  w, p, s, x and r go through plain pointers:
// inside the loop kernel they are rewritten between grid barriers, so the
// non-coherent read-only path must not cache them; invd is the same for
// the whole launch and may take that path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

template <bool kJacobi>
__device__ __forceinline__ void kb_pipe_elem(float alpha, float beta, float w, float& p,
                                             float& s, float& x, float& r, float invd) {
  const float u = kJacobi ? invd * r : r;
  p = u + beta * p;
  s = w + beta * s;
  x = x + alpha * p;
  r = r - alpha * s;
}

template <bool kJacobi>
__device__ __forceinline__ void kb_pipe_rows(float alpha, float beta, const float* w, float* p,
                                             float* s, float* x, float* r,
                                             const float* __restrict__ invd, int64_t i,
                                             int64_t end, int64_t step) {
  for (; i < end; i += step) {
    float pv = p[i], sv = s[i], xv = x[i], rv = r[i];
    kb_pipe_elem<kJacobi>(alpha, beta, w[i], pv, sv, xv, rv, kJacobi ? __ldg(invd + i) : 0.0f);
    p[i] = pv;
    s[i] = sv;
    x[i] = xv;
    r[i] = rv;
  }
}

template <bool kJacobi>
__device__ __forceinline__ void kb_pipe_span(float alpha, float beta, const float* w, float* p,
                                             float* s, float* x, float* r,
                                             const float* __restrict__ invd, int64_t n, int vec,
                                             int64_t first, int64_t step) {
  if (!vec) {
    kb_pipe_rows<kJacobi>(alpha, beta, w, p, s, x, r, invd, first, n, step);
    return;
  }
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* s4 = reinterpret_cast<float4*>(s);
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* r4 = reinterpret_cast<float4*>(r);
  const int64_t whole = n >> 2;
  for (int64_t t = first; t < whole; t += step) {
    const float4 wv = w4[t];
    float4 pv = p4[t], sv = s4[t], xv = x4[t], rv = r4[t];
    float4 dv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kJacobi) dv = __ldg(reinterpret_cast<const float4*>(invd) + t);
    kb_pipe_elem<kJacobi>(alpha, beta, wv.x, pv.x, sv.x, xv.x, rv.x, dv.x);
    kb_pipe_elem<kJacobi>(alpha, beta, wv.y, pv.y, sv.y, xv.y, rv.y, dv.y);
    kb_pipe_elem<kJacobi>(alpha, beta, wv.z, pv.z, sv.z, xv.z, rv.z, dv.z);
    kb_pipe_elem<kJacobi>(alpha, beta, wv.w, pv.w, sv.w, xv.w, rv.w, dv.w);
    p4[t] = pv;
    s4[t] = sv;
    x4[t] = xv;
    r4[t] = rv;
  }
  // the last quad, n % 4 rows, is quad `whole`: its turn is this thread's
  // when whole = first (mod step)
  if ((n & 3) != 0 && first == whole % step)
    kb_pipe_rows<kJacobi>(alpha, beta, w, p, s, x, r, invd, whole << 2, n, 1);
}

}  // namespace ogl
