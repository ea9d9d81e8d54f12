// K1 of the merged-kernel CG, for Hopper:
//   p'[i] = z[i] + beta * p[i]
//   q[i]  = sum_k data[k*n + i] * p'[i + off_k]   (terms outside [0, n) dropped)
//   partials[block] = sum over the block's rows of p'[i] * q[i]
// delta = sum(partials) is taken outside the kernel (torch.sum), as the TPU
// version sums its per-tile partials outside the pallas_call.
//
// Replaces: ogl_tpu/kernels/fused.py `_k1_kernel` (called through
// `CgKernels.k1`, and `CgKernels.apply` = K1 with z = p = x, beta = 0).
// The persistent CG loop (cg_loop.cu) runs the same row body as its K1
// phase (cg_k1.cuh).
//
// Bound: device-memory bandwidth.  Minimum traffic per row: nd coefficients
// + z and p in + p' and q out = (nd + 4) * n * 4 bytes, about 2*nd + 4 flops.
//
// Design: one thread per row, so every stream is coalesced.  The stencil
// needs p' at the neighbours i + off_k, which other blocks own and may not
// have written yet, so each thread recomputes z[j] + beta * p[j] at every
// neighbour instead of reading p' back — the TPU kernel likewise recomputes
// p' over its whole halo window.  The neighbour reads of z and p are shared
// with adjacent rows and mostly hit L1/L2.  p' goes to its own buffer
// (writing it into p would race with neighbouring blocks still reading p);
// z and p are only read, so they may alias (apply passes z == p == x).
// beta arrives as a device pointer, so launching needs no host sync.  The
// dot is reduced per block with warp shuffles, then shared memory, into one
// float per block: no float atomics, so the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k1.cuh"

namespace {

__global__ void cg_k1_kernel(const float* __restrict__ data,
                             const int* __restrict__ offsets, int nd,
                             const float* z, const float* p,
                             const float* __restrict__ beta_ptr,
                             float* __restrict__ pout, float* __restrict__ q,
                             float* __restrict__ partials, int64_t n) {
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const float beta = *beta_ptr;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float prod = 0.0f;
  if (i < n) {
    float pc;
    const float acc = ogl::k1_row(data, s_off, nd, z, p, beta, i, n, &pc);
    pout[i] = pc;
    q[i] = acc;
    prod = pc * acc;
  }
  ogl::block_sum_to(prod, partials);
}

}  // namespace

// Launches `grid` blocks of `threads` on `stream`; `partials` holds `grid`
// floats.  threads must be a multiple of 32 in [32, 1024] and grid must
// cover n.  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_cg_k1(const float* data, const int* offsets, int nd,
                         const float* z, const float* p, const float* beta,
                         float* pout, float* q, float* partials, int64_t n,
                         int threads, int64_t grid, void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || n < 0 || grid * threads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  cg_k1_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      data, offsets, nd, z, p, beta, pout, q, partials, n);
  return static_cast<int>(cudaGetLastError());
}
