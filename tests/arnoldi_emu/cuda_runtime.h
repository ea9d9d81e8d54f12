// A CPU stand-in for the CUDA pieces that csrc/gmres_arnoldi.cuh uses, so
// that its body runs as written: one std::thread per CUDA thread, a
// std::barrier per CTA for __syncthreads, one per warp for __syncwarp and the
// shuffles, and one over the grid for grid.sync (cooperative_groups.h).
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <barrier>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

// what the threads of one CTA share
struct Cta {
  std::barrier<>* bar;
  std::barrier<>* warp_bars[32];
  float shfl[32][32];
};
extern thread_local Cta* this_cta;

inline void __syncthreads() { this_cta->bar->arrive_and_wait(); }
inline void __syncwarp() { this_cta->warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_down_sync(unsigned, float v, int s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  this_cta->shfl[warp][lane] = v;
  this_cta->warp_bars[warp]->arrive_and_wait();
  const float r = lane + s < 32 ? this_cta->shfl[warp][lane + s] : v;
  this_cta->warp_bars[warp]->arrive_and_wait();
  return r;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __fdiv_rn(float a, float b) { return a / b; }
