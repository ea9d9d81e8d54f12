// KB_pipe of the pipelined (Chronopoulos-Gear) CG, for Hopper:
//   u = invd[i] * r[i]  (r[i] when invd is null: identity)
//   p[i] = u + beta * p[i] ;  s[i] = w[i] + beta * s[i]
//   x[i] += alpha * p'[i] ;  r[i] -= alpha * s'[i]          (in place)
//
// Replaces: ogl_tpu/kernels/fused.py `_kb_pipe_kernel` (called through
// `CgKernels.kb_pipe`, on the route that keeps the host loop: a plan that
// is not CgKernels itself).  Its body (cg_kb_pipe.cuh) is also the KB_pipe
// phase of the persistent pipelined-CG loop (cg_pipe_loop.cu).  Plain twin:
// `kb_pipe_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per row it reads w, p, s, x and r and
// writes p, s, x and r: 36 bytes for 8 flops; Jacobi adds invd (40 bytes).
//
// Design: as K2 (cg_k2.cu): a grid-stride grid sized by the caller from the
// SM count (kernels/fused.py K2_BLOCKS_PER_SM: one row quad per thread up to
// 8.4M rows) walks row quads with float4 loads and stores when every stream
// is 16-byte aligned, the last quad of an n % 4 != 0 row by row; otherwise
// the same kernel walks rows.  alpha and beta are read through device
// pointers, so a launch never waits for the host.  No sums.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_kb_pipe.cuh"
#include "loop.cuh"  // misaligned

namespace {

constexpr int kThreads = 256;

template <bool kJacobi>
__global__ void __launch_bounds__(kThreads)
    cg_kb_pipe_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                      const float* w, float* p, float* s, float* x, float* r,
                      const float* __restrict__ invd, int64_t n, int vec) {
  ogl::kb_pipe_span<kJacobi>(*alpha, *beta, w, p, s, x, r, invd, n, vec,
                             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                             static_cast<int64_t>(gridDim.x) * blockDim.x);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; invd may be null
// (identity); vec != 0 takes the float4 branch, which needs w, p, s, x, r
// (and invd) 16-byte aligned.  w must not overlap p, s, x or r.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_cg_kb_pipe(const float* alpha, const float* beta, const float* w, float* p,
                              float* s, float* x, float* r, const float* invd, int64_t n,
                              int vec, int64_t blocks, void* stream) {
  if (n < 0 || blocks < 1 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (ogl::misaligned(w, 16) || ogl::misaligned(p, 16) || ogl::misaligned(s, 16) ||
              ogl::misaligned(x, 16) || ogl::misaligned(r, 16) ||
              (invd != nullptr && ogl::misaligned(invd, 16))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (invd != nullptr)
    cg_kb_pipe_kernel<true><<<grid, kThreads, 0, st>>>(alpha, beta, w, p, s, x, r, invd, n, vec);
  else
    cg_kb_pipe_kernel<false><<<grid, kThreads, 0, st>>>(alpha, beta, w, p, s, x, r, nullptr, n,
                                                        vec);
  return static_cast<int>(cudaGetLastError());
}
