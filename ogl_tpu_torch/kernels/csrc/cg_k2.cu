// K2 of the merged-kernel CG (scalar Jacobi preconditioning), for Hopper:
//   x[i] += alpha * p[i] ;  r[i] -= alpha * q[i] ;  z[i] = invd[i] * r'[i]   (in place)
//   partials[0, block] = sum over the block's rows of r'[i] * z'[i]           (rho)
//   partials[1, block] = sum over the block's rows of |r'[i]|                 (||r||_1)
// torch.sum(partials, dim=1) finishes both sums outside the kernel, as the
// TPU version sums its per-tile partials outside the pallas_call.
//
// Replaces: ogl_tpu/kernels/fused.py `_k2_kernel` (called through
// `CgKernels.k2`, on the route that keeps the host loop: Xell with
// preconditioner BJ).  Its body (cg_k2.cuh) is also the K2 phase of the
// persistent CG loop's Jacobi variants (cg_loop.cu).  Plain twin:
// `k2_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per row it reads x, r, p, q and invd and
// writes x, r and z: 32 bytes for 9 flops.
//
// Design: as K2i (cg_k2i.cu): a grid-stride grid sized by the caller from
// the SM count (kernels/fused.py K2_BLOCKS_PER_SM: one row quad per thread
// up to 8.4M rows, each thread striding over several beyond) walks row
// quads with float4 loads and stores when every stream is 16-byte aligned
// and n % 4 == 0; otherwise the same kernel takes its scalar branch, one row
// per step.  alpha is read through a device pointer, so a launch never
// waits for the host.  One partial pair per block, from one shared-memory
// pass (block_sum.cuh): no float atomics, so the sums are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k2.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cg_k2_kernel(const float* __restrict__ alpha_ptr, float* __restrict__ x,
                 float* __restrict__ r, const float* __restrict__ p,
                 const float* __restrict__ q, const float* __restrict__ invd,
                 float* __restrict__ z, float* __restrict__ partials, int64_t n, int vec) {
  const float alpha = *alpha_ptr;
  float sums[2] = {0.0f, 0.0f};
  ogl::k2_span(alpha, x, r, z, p, q, invd, n, vec,
               static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
               static_cast<int64_t>(gridDim.x) * blockDim.x, sums[0], sums[1]);
  ogl::block_sums_to<2>(sums, partials);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; `partials` holds
// (2, blocks) floats; vec != 0 takes the float4 branch, which needs
// n % 4 == 0 and x, r, p, q, invd, z 16-byte aligned.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_cg_k2(const float* alpha, float* x, float* r, const float* p,
                         const float* q, const float* invd, float* z, float* partials,
                         int64_t n, int vec, int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 ||
              ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q) |
                reinterpret_cast<uintptr_t>(invd) | reinterpret_cast<uintptr_t>(z)) & 15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cg_k2_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(alpha, x, r, p, q, invd, z, partials, n,
                                                      vec);
  return static_cast<int>(cudaGetLastError());
}
