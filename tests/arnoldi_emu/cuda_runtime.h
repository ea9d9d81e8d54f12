// A CPU stand-in for the CUDA pieces that csrc/gmres_arnoldi.cuh, the
// staged AMG level bodies of csrc/amg_stage.cuh and the level phases of the
// device V-cycle (csrc/amg_loop.cuh) use, so that their bodies run as
// written: one std::thread per CUDA thread, a std::barrier per CTA for
// __syncthreads, one per warp for __syncwarp and the shuffles, and one over
// the grid for grid.sync (cooperative_groups.h); the vector types, the
// read-only loads as plain loads and the rounded operations as the float
// operations they are (compile with -ffp-contract=off: no fused
// multiply-add).  The host API that loop.cuh's launch helpers name is
// declared and fails: nothing here launches a kernel.
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
#define __noinline__
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
// every lane's v, then lane `src(lane)`'s, read once all of the warp wrote
template <class Src>
inline float emu_shfl(float v, Src src) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  this_cta->shfl[warp][lane] = v;
  this_cta->warp_bars[warp]->arrive_and_wait();
  const float r = this_cta->shfl[warp][src(lane) & 31];
  this_cta->warp_bars[warp]->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  return emu_shfl(v, [src](int) { return src; });
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return emu_shfl(v, [mask](int lane) { return lane ^ mask; });
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
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }

struct float4 {
  float x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct char4 {
  signed char x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// the host API of loop.cuh's launch helpers: declared, and failing
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 720,
  cudaErrorNotSupported = 801,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrCooperativeLaunch = 95 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetDevice(int*) { return cudaErrorNotSupported; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, const void*, int, size_t) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, size_t,
                                               cudaStream_t) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
