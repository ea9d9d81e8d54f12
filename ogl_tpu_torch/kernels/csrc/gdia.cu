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
//
// Bound: device-memory bandwidth.  Minimum traffic per row: np values (4 B)
// and np lanes (1 B) + x in and y out = np*5 + 8 bytes for the SpMV;
// + z, p in and p', q out = np*5 + 16 bytes for K1, at 2*np (+4) flops.
//
// Design: one thread per row, rows contiguous across a warp, so the value
// and lane streams (k*R*128 + i) and the outputs are coalesced; a warp's 32
// rows lie in one block row, so its gathered sources fall in one 128-row
// block (+ q_k): one or two 128-byte lines per plane.  The plane offsets are
// read by every thread from one address (a broadcast).  K1 recomputes
// z[j] + beta*p[j] at every source instead of reading p' back (other blocks
// may not have written it yet; z and p may alias).  beta arrives through a
// device pointer, so a launch never waits for the host.  Float32
// accumulation in plane order (the plain version's order); int64 indices.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

template <bool kK1>
__global__ void gdia_kernel(const float* __restrict__ vals,
                            const int8_t* __restrict__ lidx,
                            const int* __restrict__ qoffs, int np, int64_t r,
                            const float* z, const float* p,
                            const float* __restrict__ beta_ptr,
                            float* __restrict__ pout, float* __restrict__ q,
                            float* __restrict__ partials, int64_t n) {
  const float beta = kK1 ? *beta_ptr : 0.0f;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = r * 128;
  float prod = 0.0f;
  if (i < n) {
    const int64_t row = i >> 7;
    float acc = 0.0f;
    for (int k = 0; k < np; ++k) {
      const int64_t at = (int64_t)k * plane + i;
      const int64_t j = (row + __ldg(qoffs + k)) * 128 + (int64_t)lidx[at];
      if (j >= 0 && j < n) {
        const float src = kK1 ? z[j] + beta * p[j] : z[j];
        acc += vals[at] * src;
      }
    }
    q[i] = acc;
    if (kK1) {
      const float pc = z[i] + beta * p[i];
      pout[i] = pc;
      prod = pc * acc;
    }
  }
  if (kK1) ogl::block_sum_to(prod, partials);
}

bool bad_launch(int np, int64_t r, int64_t n, int threads, int64_t grid) {
  return np < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
         n < 0 || r * 128 < n || grid * threads < n;
}

}  // namespace

// y = A x.  Launches ceil(n / threads) blocks on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_gdia_spmv(const float* vals, const int8_t* lidx,
                             const int* qoffs, int np, int64_t r,
                             const float* x, float* y, int64_t n, int threads,
                             void* stream) {
  const int64_t grid = (n + threads - 1) / (threads > 0 ? threads : 1);
  if (bad_launch(np, r, n, threads, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  gdia_kernel<false><<<static_cast<unsigned int>(grid), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, lidx, qoffs, np, r, x, x, nullptr, nullptr, y, nullptr, n);
  return static_cast<int>(cudaGetLastError());
}

// K1; `partials` holds `grid` floats and grid must cover n.
extern "C" int ogl_gdia_k1(const float* vals, const int8_t* lidx,
                           const int* qoffs, int np, int64_t r, const float* z,
                           const float* p, const float* beta, float* pout,
                           float* q, float* partials, int64_t n, int threads,
                           int64_t grid, void* stream) {
  if (bad_launch(np, r, n, threads, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  gdia_kernel<true><<<static_cast<unsigned int>(grid), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, lidx, qoffs, np, r, z, p, beta, pout, q, partials, n);
  return static_cast<int>(cudaGetLastError());
}
