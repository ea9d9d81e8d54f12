// A CPU stand-in for the CUDA pieces that csrc/block_jacobi.cuh,
// csrc/gmres_combine.cuh, csrc/tri_sweep.cuh, csrc/tri_levels.cuh and
// csrc/amg_level.cuh (with the Ell and Gdia row bodies) use, so
// that their bodies run as written: the
// built-in indices as thread-local variables (one std::thread per CUDA
// thread where the body synchronises, a plain loop over the threads where
// it does not), a std::barrier per CTA for __syncthreads, the vector types,
// the read-only loads as plain loads, __nanosleep as a yield, __trap as
// abort, and the rounded operations as the float operations they are
// (compile with -ffp-contract=off: no fused multiply-add).
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <cstdlib>
#include <thread>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

// the barrier of the calling thread's CTA
extern thread_local std::barrier<>* cta_barrier;
inline void __syncthreads() { cta_barrier->arrive_and_wait(); }

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
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
[[noreturn]] inline void __trap() { std::abort(); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
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
// csr_rows.cuh's many-lane body shuffles; the emulated bodies take its
// one-lane body only, so a shuffle here is a fault of the harness
inline float __shfl_xor_sync(unsigned, float, int) { std::abort(); }
