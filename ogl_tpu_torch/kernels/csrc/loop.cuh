// What the persistent cooperative loop kernels share (cg_loop.cu,
// xell_cg_loop.cu, cg_pipe_loop.cu, bicgstab_loop.cu, bicgstab_gen_loop.cu,
// amg_loop.cuh).
//   * the OpenFOAM criterion as it runs on the device (stopping.py
//     `check_from_norm`): the minIter/frequency gating on the iteration
//     index, the normalised residual in float32, tol and relTol as float;
//   * block_totals: the sums of the per-block partials that every block
//     takes after a grid barrier, in block order, so every block gets the
//     same bits and takes the same branch at the check;
//   * the record block 0 writes on exit;
//   * on the host, the occupancy query that sizes a cooperative grid and the
//     cooperative launch, whose refusal is returned and cleared.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace ogl {

struct Criterion {
  float tol;
  float rel_tol;
  int min_iter;
  int max_iter;
  int frequency;
};

__device__ __forceinline__ bool hit(const Criterion& c, float rn, float init_rn) {
  return rn < c.tol || (c.rel_tol > 0.0f && rn < c.rel_tol * init_rn);
}

// The check of iteration `it` from the summed ||r||_1: gated iterations
// change nothing and return false; a checked one sets rn (and, at
// iteration 0, init_rn) and returns true when the loop stops (maxIter
// reached or a tolerance met).
__device__ __forceinline__ bool stop_at(const Criterion& c, int it, float absr, float nf,
                                        float& rn, float& init_rn) {
  if ((it > 0 && it < c.min_iter) || it % c.frequency != 0) return false;
  rn = absr / nf;
  if (it == 0) init_rn = rn;
  return it >= c.max_iter || hit(c, rn, init_rn);
}

// {iterations (int32), final normalised residual, initial normalised
// residual, converged (tolerances met)}
__device__ __forceinline__ void write_record(float* record, int it, float rn, float init_rn,
                                             const Criterion& c) {
  reinterpret_cast<int*>(record)[0] = it;
  record[1] = rn;
  record[2] = init_rn;
  record[3] = hit(c, rn, init_rn) ? 1.0f : 0.0f;
}

// The N sums of rows v[k * count .. (k + 1) * count) as every thread of the
// block sees them: each thread adds its strided share in index order, then
// the block reduces in a fixed order, so every block gets the same bits.
template <int N>
__device__ __forceinline__ void block_totals(const float* v, int count, float (&out)[N]) {
  __shared__ float s_warps[N][32];
  __shared__ float s_total[N];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < count; b += blockDim.x) acc += v[(int64_t)k * count + b];
    acc = warp_sum(acc);
    if (lane == 0) s_warps[k][warp] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = warp_sum(lane < n_warps ? s_warps[k][lane] : 0.0f);
      if (lane == 0) s_total[k] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = s_total[k];
}

inline bool misaligned(const void* a, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(a) & (bytes - 1)) != 0;
}

// The co-resident blocks of `threads` of `kernel` with `smem` bytes of
// dynamic shared memory on the current device (occupancy x SMs).  Fails with
// cudaErrorNotSupported on a device without cooperative launch.
inline int coop_grid(const void* kernel, int threads, int64_t* blocks, size_t smem = 0) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  cudaGetLastError();  // a failed query must not surface at the next launch check
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = static_cast<int64_t>(per_sm) * sms;
  return 0;
}

// One cooperative launch with `smem` bytes of dynamic shared memory; a grid
// larger than the co-resident blocks is refused
// (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error code (0 =
// launched) and clears a refused launch's error, which would else surface at
// the next kernel's cudaGetLastError().
inline int coop_launch(const void* kernel, int64_t blocks, int threads, void** args,
                       void* stream, size_t smem = 0) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned int>(blocks)), dim3(threads), args, smem,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace ogl
