// One float per block: the sum of `v` over the block's threads, written to
// out[blockIdx.x] by thread 0 — warp shuffles, then the first warp over the
// warp sums in shared memory.  No float atomics, so a sum taken afterwards
// over the per-block partials (torch.sum) is deterministic.  Every thread of
// the block must call it (it synchronises); blockDim.x must be a multiple of
// 32, at most 1024.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ void block_sum_to(float v, float* out) {
  __shared__ float s_warp[32];
  v = warp_sum(v);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
    float w = lane < n_warps ? s_warp[lane] : 0.0f;
    w = warp_sum(w);
    if (lane == 0) out[blockIdx.x] = w;
  }
}

// N sums at once: out[k * gridDim.x + blockIdx.x] = the block's sum of v[k],
// so `out` is an (N, grid) array whose rows torch.sum(out, dim=1) finishes.
// One barrier for all N (calling block_sum_to N times would need a barrier
// between the calls, since they share s_warp).
template <int N>
__device__ __forceinline__ void block_sums_to(const float (&v)[N], float* out) {
  __shared__ float s_warps[N][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w = warp_sum(v[k]);
    if (lane == 0) s_warps[k][warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = warp_sum(lane < n_warps ? s_warps[k][lane] : 0.0f);
      if (lane == 0) out[(int64_t)k * gridDim.x + blockIdx.x] = w;
    }
  }
}

}  // namespace ogl
