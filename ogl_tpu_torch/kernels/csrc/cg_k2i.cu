// K2i of the merged-kernel CG (identity preconditioning: z = r), for Hopper:
//   x[i] += alpha * p[i] ;  r[i] -= alpha * q[i]                (in place)
//   partials[0, block] = sum over the block's rows of r'[i]^2    (rho)
//   partials[1, block] = sum over the block's rows of |r'[i]|    (||r||_1)
// torch.sum(partials, dim=1) finishes both sums outside the kernel, as the
// TPU version sums its per-tile partials outside the pallas_call.
//
// Replaces: ogl_tpu/kernels/fused.py `_k2i_kernel` (called through
// `CgKernels.k2i`, on the routes that keep the host loop: Gdia and Xell
// with preconditioner none).  Its body (cg_k2i.cuh) is also the K2i phase of
// the persistent CG loop (cg_loop.cu).  Plain twin: `k2i_plain` in
// ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per row it reads x, r, p, q and writes x
// and r: 24 bytes for 8 flops.
//
// Design: a grid-stride grid sized by the caller from the SM count
// (kernels/fused.py K2_BLOCKS_PER_SM: one row quad per thread up to 8.4M
// rows, each thread striding over several beyond) walks row quads with
// float4 loads and stores when every stream is 16-byte aligned and
// n % 4 == 0; otherwise the same kernel takes its scalar branch, one row
// per step.  alpha is read
// through a device pointer, so a launch never waits for the host.  One
// partial pair per block, from one shared-memory pass (block_sum.cuh): no
// float atomics, so the sums are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k2i.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cg_k2i_kernel(const float* __restrict__ alpha_ptr, float* __restrict__ x,
                  float* __restrict__ r, const float* __restrict__ p,
                  const float* __restrict__ q, float* __restrict__ partials, int64_t n,
                  int vec) {
  const float alpha = *alpha_ptr;
  float sums[2] = {0.0f, 0.0f};
  ogl::k2i_span(alpha, x, r, p, q, n, vec,
                static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<int64_t>(gridDim.x) * blockDim.x, sums[0], sums[1]);
  ogl::block_sums_to<2>(sums, partials);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; `partials` holds
// (2, blocks) floats; vec != 0 takes the float4 branch, which needs
// n % 4 == 0 and x, r, p, q 16-byte aligned.  Returns cudaGetLastError()
// (0 = launched).
extern "C" int ogl_cg_k2i(const float* alpha, float* x, float* r, const float* p,
                          const float* q, float* partials, int64_t n, int vec,
                          int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                                reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q)) &
                               15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cg_k2i_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(alpha, x, r, p, q, partials, n, vec);
  return static_cast<int>(cudaGetLastError());
}
