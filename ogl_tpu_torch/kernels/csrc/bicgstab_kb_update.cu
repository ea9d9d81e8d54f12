// KB_update of the merged BiCGStab, for Hopper:
//   x[i] = x[i] + alpha * p[i] + omega * s[i]      (in place)
//   r[i] = s[i] - omega * t[i]                     (r' into r's buffer)
//   partials[0, block] = sum over the block's rows of rhat[i] * r'[i]   (rho')
//   partials[1, block] = sum over the block's rows of |r'[i]|           (||r'||_1)
// torch.sum(partials, dim=1) finishes both sums outside the kernel.
//
// Replaces: ogl_tpu/kernels/fused.py `_kb_update_kernel` (called through
// `CgKernels.kb_update`, on the route that keeps the host loop: a plan that
// is not CgKernels itself).  Its body (bicgstab_kb_update.cuh) is also the
// KB_update phase of the persistent merged-BiCGStab loop
// (bicgstab_loop.cu).  Plain twin: `kb_update_plain` in
// ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per row it reads x, p, s, t and rhat and
// writes x and r: 28 bytes for 10 flops.
//
// Design: as KB_pipe (cg_kb_pipe.cu): a grid-stride grid sized by the
// caller from the SM count (kernels/fused.py K2_BLOCKS_PER_SM: one row quad
// per thread up to 8.4M rows) walks row quads with float4 loads and stores
// when every stream is 16-byte aligned, the last quad of an n % 4 != 0 row
// by row; otherwise the same kernel walks rows.  alpha and omega are read
// through device pointers, so a launch never waits for the host.  One
// partial pair per block, from one shared-memory pass (block_sum.cuh): no
// float atomics, so the sums are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bicgstab_kb_update.cuh"
#include "block_sum.cuh"
#include "loop.cuh"  // misaligned

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bicgstab_kb_update_kernel(const float* __restrict__ alpha, const float* __restrict__ omega,
                              float* x, const float* p, const float* s, const float* t,
                              const float* __restrict__ rhat, float* r, float* partials,
                              int64_t n, int vec) {
  float sums[2] = {0.0f, 0.0f};
  ogl::kb_update_span(*alpha, *omega, x, p, s, t, rhat, r, n, vec,
                      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                      static_cast<int64_t>(gridDim.x) * blockDim.x, sums[0], sums[1]);
  ogl::block_sums_to<2>(sums, partials);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; `partials` holds
// (2, blocks) floats; vec != 0 takes the float4 branch, which needs x, p,
// s, t, rhat and r 16-byte aligned.  x must not overlap p, s, t or r; r
// may be s, no other input.  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_bicgstab_kb_update(const float* alpha, const float* omega, float* x,
                                      const float* p, const float* s, const float* t,
                                      const float* rhat, float* r, float* partials, int64_t n,
                                      int vec, int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (ogl::misaligned(x, 16) || ogl::misaligned(p, 16) || ogl::misaligned(s, 16) ||
              ogl::misaligned(t, 16) || ogl::misaligned(rhat, 16) || ogl::misaligned(r, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  bicgstab_kb_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(alpha, omega, x, p, s, t,
                                                                   rhat, r, partials, n, vec);
  return static_cast<int>(cudaGetLastError());
}
