// Gdia SpMV and merged-CG K1 for Hopper.  Row i = r*128 + l of the (R, 128)
// view; plane k has block-row offset q_k and per-entry source lanes:
//   src_k(i) = (r + q_k) * 128 + lidx[k, r, l]
//   SpMV:  y[i] = sum_k vals[k, r, l] * x[src_k(i)]
//   K1:    p'[i] = z[i] + beta * p[i];  q[i] = sum_k vals[k, r, l] * p'[src_k(i)];
//          partials[block] = sum over the block's rows of p'[i] * q[i]
// Sources outside [0, n) are dropped: padding slots (val 0, lane 0) and the
// tail of the last block row, where the TPU reads a zero-padded window.
//
// Replaces: ogl_tpu/kernels/gdia.py `_gdia_kernel` (`_gdia_padded`,
// `gdia_matvec`) and ogl_tpu/kernels/fused.py `_k1_gdia_kernel`
// (`GdiaCgKernels.k1`, and `apply` = K1 with z = p = x, beta = 0).  The TPU
// kernels DMA a halo window of block rows per tile and gather lanes in
// registers (`take_along_axis`); on the GPU the gather is a plain load.
// Both run the row body of gdia_k1.cuh, which is also the K1 phase of the
// persistent CG loop's Gdia variants (cg_loop.cu).
//
// Bound: device-memory bandwidth.  Minimum traffic per row: np values (4 B)
// and np lanes (1 B) + x in and y out = np*5 + 8 bytes for the SpMV;
// + z, p in and p', q out = np*5 + 16 bytes for K1, at 2*np (+4) flops.
//
// Design: gdia_k1.cuh — one thread per row quad, 16-byte loads of the value
// and 4-byte loads of the lane streams, the plane offsets in shared memory —
// over a grid of one quad per thread, for both kernels (the SpMV is the K1
// body without p, beta and p').  Float32 accumulation in plane order (the
// plain version's order); int64 indices.  beta arrives through a device
// pointer, so a launch never waits for the host; z and p may alias.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "gdia_k1.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kK1>
__global__ void __launch_bounds__(kThreads)
    gdia_kernel(const float* __restrict__ vals, const int8_t* __restrict__ lidx,
                const int* __restrict__ qoffs, int np, int64_t r, const float* z,
                const float* p, const float* __restrict__ beta_ptr, float* pout, float* q,
                float* __restrict__ partials, int64_t n, int vec) {
  __shared__ int s_q[ogl::kGdiaMaxPlanes];
  for (int k = threadIdx.x; k < np; k += blockDim.x) s_q[k] = qoffs[k];
  __syncthreads();
  const float dot = ogl::gdia_span<kK1>(
      vals, lidx, s_q, np, r * ogl::kGdiaLanes, z, p, kK1 ? *beta_ptr : 0.0f, pout, q, n, vec,
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<int64_t>(gridDim.x) * blockDim.x);
  if (kK1) ogl::block_sum_to(dot, partials);
}

// 0 when the shapes, the grid and the alignment suit the kernels, else the
// error to return: vals must be 16-byte and lidx 4-byte aligned; vec != 0
// needs the vectors 16-byte aligned.
int bad_launch(const float* vals, const int8_t* lidx, int np, int64_t r, int64_t n,
               int64_t blocks, int vec, const void* a, const void* b, const void* c,
               const void* d) {
  if (np < 1 || np > ogl::kGdiaMaxPlanes || n < 0 || r * 128 < n || blocks < 1 ||
      blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t vectors = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                            reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  if ((reinterpret_cast<uintptr_t>(vals) & 15) || (reinterpret_cast<uintptr_t>(lidx) & 3) ||
      (vec && (vectors & 15)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

// y = A x: `blocks` blocks of 256 threads, each thread striding over row
// quads (one quad each when blocks = ceil(ceil(n / 4) / 256)); vec != 0
// takes the float4 path for x and y.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_gdia_spmv(const float* vals, const int8_t* lidx, const int* qoffs, int np,
                             int64_t r, const float* x, float* y, int64_t n, int vec,
                             int64_t blocks, void* stream) {
  if (const int bad = bad_launch(vals, lidx, np, r, n, blocks, vec, x, y, x, y)) return bad;
  gdia_kernel<false><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(vals, lidx, qoffs, np, r, x, x,
                                                            nullptr, nullptr, y, nullptr, n,
                                                            vec);
  return static_cast<int>(cudaGetLastError());
}

// K1, on the grid of the SpMV; `partials` holds `blocks` floats; vec != 0
// takes the float4 path for z, p, pout and q.
extern "C" int ogl_gdia_k1(const float* vals, const int8_t* lidx,
                           const int* qoffs, int np, int64_t r, const float* z,
                           const float* p, const float* beta, float* pout,
                           float* q, float* partials, int64_t n, int vec,
                           int64_t blocks, void* stream) {
  if (const int bad = bad_launch(vals, lidx, np, r, n, blocks, vec, z, p, pout, q)) return bad;
  gdia_kernel<true><<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(vals, lidx, qoffs, np, r, z, p, beta,
                                                           pout, q, partials, n, vec);
  return static_cast<int>(cudaGetLastError());
}
