// K2n of the merged-kernel CG with a rich preconditioner (the AMG cycle),
// for Hopper:
//   x[i] += alpha * p[i] ;  r[i] -= alpha * q[i]                (in place)
//   partials[block] = sum over the block's rows of |r'[i]|      (||r||_1)
// torch.sum(partials) finishes the sum outside the kernel, as the TPU
// version sums its per-tile partials outside the pallas_call.
//
// Replaces: ogl_tpu/kernels/fused.py `_k2n_kernel` (called through
// `CgKernels.k2n`, on the host-launched AMG route: a hierarchy the device
// V-cycle does not take).  Its body (cg_k2n.cuh) is also the K2n phase of
// the device V-cycle's CG loop (amg_loop.cuh).  Plain twin: `k2n_plain` in
// ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per row it reads x, r, p, q and writes x
// and r: 24 bytes for 6 flops.
//
// Design: as K2i (cg_k2i.cu): a grid-stride grid sized by the caller from
// the SM count walks row quads with float4 loads and stores when every
// stream is 16-byte aligned and n % 4 == 0, else rows.  alpha is read
// through a device pointer, so a launch never waits for the host.  One
// partial per block (block_sum.cuh): no float atomics, so the sum is
// deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k2n.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cg_k2n_kernel(const float* __restrict__ alpha_ptr, float* __restrict__ x,
                  float* __restrict__ r, const float* __restrict__ p,
                  const float* __restrict__ q, float* __restrict__ partials, int64_t n,
                  int vec) {
  const float alpha = *alpha_ptr;
  float ab = 0.0f;
  ogl::k2n_span(alpha, x, r, p, q, n, vec,
                static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<int64_t>(gridDim.x) * blockDim.x, ab);
  ogl::block_sum_to(ab, partials);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; `partials` holds
// `blocks` floats; vec != 0 takes the float4 branch, which needs n % 4 == 0
// and x, r, p, q 16-byte aligned.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_cg_k2n(const float* alpha, float* x, float* r, const float* p,
                          const float* q, float* partials, int64_t n, int vec,
                          int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                                reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q)) &
                               15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cg_k2n_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(alpha, x, r, p, q, partials, n, vec);
  return static_cast<int>(cudaGetLastError());
}
