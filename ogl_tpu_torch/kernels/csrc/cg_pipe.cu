// KA of the pipelined (Chronopoulos-Gear) CG, for Hopper:
//   u[j] = invd[j] * r[j]        (u = r when invd is null: identity)
//   w[i] = sum_k data[k*n + i] * u[i + off_k]   (terms outside [0, n) dropped)
//   partials[0, block] = sum over the block's rows of r[i] * u[i]    (gamma)
//   partials[1, block] = sum over the block's rows of w[i] * u[i]    (delta)
//   partials[2, block] = sum over the block's rows of |r[i]|         (||r||_1)
// torch.sum(partials, dim=1) finishes the three sums outside the kernel, as
// the TPU version sums its per-tile partials outside the pallas_call.
//
// Replaces: ogl_tpu/kernels/fused.py `_ka_kernel` (called through
// `CgKernels.ka`).  Plain twin: `ka_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Minimum traffic per row: nd coefficients
// + r in + w out = (nd + 2) * 4 bytes (36 B at 7 diagonals), + 4 B for invd
// with Jacobi; about 2 * nd + 7 flops.
//
// Design: one thread per row, so every stream is coalesced.  The stencil
// needs u at the neighbours i + off_k, which the TPU kernel forms over its
// halo window; here each thread recomputes invd[j] * r[j] at every source,
// as K1 recomputes p' (csrc/cg_k1.cu): u is never written, so the kernel
// moves no byte beyond the minimum.  The neighbour reads of r and invd are
// shared with adjacent rows and mostly hit L1/L2.  Identity and Jacobi are
// two instantiations of one template (no ones vector is streamed).  The
// row body (cg_ka.cuh) is also the KA phase of the persistent pipelined-CG
// loop (cg_pipe_loop.cu).  The three block partials come out of one
// shared-memory pass (block_sum.cuh); no float atomics, so the sums are
// deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_ka.cuh"

namespace {

template <bool kJacobi>
__global__ void cg_ka_kernel(const float* __restrict__ data,
                             const int* __restrict__ offsets, int nd,
                             const float* __restrict__ r,
                             const float* __restrict__ invd,
                             float* __restrict__ w,
                             float* __restrict__ partials, int64_t n) {
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float sums[3] = {0.0f, 0.0f, 0.0f};
  if (i < n) ogl::ka_row<kJacobi>(data, s_off, nd, r, invd, w, i, n, sums);
  ogl::block_sums_to<3>(sums, partials);
}

}  // namespace

// Launches `grid` blocks of `threads` on `stream`; `partials` holds 3 * grid
// floats; `invd` may be null (identity).  threads must be a multiple of 32 in
// [32, 1024] and grid must cover n.  w must not overlap r or invd (other
// blocks read them at the neighbours).  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_cg_ka(const float* data, const int* offsets, int nd,
                         const float* r, const float* invd, float* w,
                         float* partials, int64_t n, int threads, int64_t grid,
                         void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || n < 0 || grid * threads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (invd != nullptr)
    cg_ka_kernel<true><<<blocks, threads, 0, s>>>(data, offsets, nd, r, invd,
                                                  w, partials, n);
  else
    cg_ka_kernel<false><<<blocks, threads, 0, s>>>(data, offsets, nd, r,
                                                   nullptr, w, partials, n);
  return static_cast<int>(cudaGetLastError());
}
