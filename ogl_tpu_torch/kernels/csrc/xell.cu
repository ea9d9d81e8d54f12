// Xell SpMV and merged-CG K1 for Hopper, with the COO spill tail applied
// in-kernel.  Destination row i = (tile*128 + t)*128 + l; for each slot k
// of its tile (main storage (nt, K, 128, 128), flat slot base
// S = (tile*K + k) * 16384):
//   v   = vals[S + t*128 + l]            (coalesced)
//   b   = ll[S + t*128 + l]              (int8 source residue, coalesced)
//   blk = bbT[S + b*128 + t]             (int16, transposed (residue, t)
//                                         order: indexed by the SOURCE
//                                         residue b, inside one 32 KB table)
//   j   = (tile*128 + blk - c_left*128)*128 + b
// then the row's spill entries s in [sp_ptr[i], sp_ptr[i+1]): source
// sp_cols[s], value sp_vals[sp_gidx[s]] (the gather index lets the value
// update write spill.vals in its own order).  Sources outside [0, n) are
// dropped: padding slots (val 0, indices 0) decode to arbitrary j, where
// the TPU reads a zero-padded window.
//   SpMV:  y[i] = sum of v * x[j] over the slots, then the spill
//   K1:    p'[i] = z[i] + beta*p[i];  q[i] = the same sum over p';
//          partials[block] = sum over the block's rows of p'[i]*q[i]
// so q and delta include the spill, as the reference's in-kernel spill makes
// them.
//
// Replaces: ogl_tpu/kernels/xell.py `_xell_kernel` (`_xell_padded`,
// `xell_matvec`), `_k1x_kernel` (`XellCgKernels.k1`, and `apply` = K1 with
// z = p = x, beta = 0), and the helper `_spill_corr` inside both.  The TPU
// kernels cross two in-register lane gathers with MXU identity-matmul
// transposes and apply the spill as one-hot MXU matmuls, because a TPU has
// no fast gather; the GPU gathers x[j] directly and the spill is a short
// per-row loop.
//
// Bound: device-memory bandwidth (and gather latency).  Minimum traffic per
// row: K*(4 + 1 + 2) bytes of slots + x in and y out = K*7 + 8 bytes for the
// SpMV, plus 12 bytes per spill entry and 4 for sp_ptr; K1 adds z, p in and
// p', q out.  The bbT load of a warp touches 32 different 256-byte rows of
// its table (one per source residue); the table is 32 KB per (tile, slot),
// so those reads are served from L1/L2 rather than device memory.
//
// Design: one thread per row, as csrc/cg_k1.cu: coalesced slot streams and
// outputs; K1 recomputes z[j] + beta*p[j] at every source (no read-back of
// p' across blocks; z and p may alias); beta through a device pointer; one
// float32 partial per block (no atomics); int64 indices; float32
// accumulation, slots in order and then the spill in row order (the plain
// version's order).  sp_ptr == NULL means no spill.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

template <bool kK1>
__global__ void xell_kernel(const float* __restrict__ vals,
                            const int8_t* __restrict__ ll,
                            const int16_t* __restrict__ bbT, int n_slots,
                            int c_left, const int* __restrict__ sp_ptr,
                            const int* __restrict__ sp_cols,
                            const int* __restrict__ sp_gidx,
                            const float* __restrict__ sp_vals, const float* z,
                            const float* p, const float* __restrict__ beta_ptr,
                            float* __restrict__ pout, float* __restrict__ q,
                            float* __restrict__ partials, int64_t n) {
  const float beta = kK1 ? *beta_ptr : 0.0f;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float prod = 0.0f;
  if (i < n) {
    const int64_t tile = i >> 14;
    const int64_t t = (i >> 7) & 127;
    const int64_t base = (tile * 128 - (int64_t)c_left * 128) * 128;
    float acc = 0.0f;
    for (int k = 0; k < n_slots; ++k) {
      const int64_t slot = (tile * n_slots + k) << 14;
      const int64_t at = slot + (i & 16383);
      const int64_t b = (int64_t)ll[at] & 127;
      const int64_t j = base + (int64_t)bbT[slot + (b << 7) + t] * 128 + b;
      if (j >= 0 && j < n) {
        const float src = kK1 ? z[j] + beta * p[j] : z[j];
        acc += vals[at] * src;
      }
    }
    if (sp_ptr != nullptr) {
      const int end = sp_ptr[i + 1];
      for (int s = sp_ptr[i]; s < end; ++s) {
        const int64_t j = sp_cols[s];
        const float src = kK1 ? z[j] + beta * p[j] : z[j];
        acc += sp_vals[sp_gidx[s]] * src;
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

bool bad_launch(int n_slots, int c_left, int64_t n, int threads, int64_t grid) {
  return n_slots < 1 || c_left < 0 || threads < 32 || threads > 1024 ||
         threads % 32 != 0 || n < 0 || grid * threads < n;
}

}  // namespace

// y = A x.  Launches ceil(n / threads) blocks on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_xell_spmv(const float* vals, const int8_t* ll,
                             const int16_t* bbT, int n_slots, int c_left,
                             const int* sp_ptr, const int* sp_cols,
                             const int* sp_gidx, const float* sp_vals,
                             const float* x, float* y, int64_t n, int threads,
                             void* stream) {
  const int64_t grid = (n + threads - 1) / (threads > 0 ? threads : 1);
  if (bad_launch(n_slots, c_left, n, threads, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  xell_kernel<false><<<static_cast<unsigned int>(grid), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, x, x,
      nullptr, nullptr, y, nullptr, n);
  return static_cast<int>(cudaGetLastError());
}

// K1; `partials` holds `grid` floats and grid must cover n.
extern "C" int ogl_xell_k1(const float* vals, const int8_t* ll,
                           const int16_t* bbT, int n_slots, int c_left,
                           const int* sp_ptr, const int* sp_cols,
                           const int* sp_gidx, const float* sp_vals,
                           const float* z, const float* p, const float* beta,
                           float* pout, float* q, float* partials, int64_t n,
                           int threads, int64_t grid, void* stream) {
  if (bad_launch(n_slots, c_left, n, threads, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  xell_kernel<true><<<static_cast<unsigned int>(grid), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, z, p,
      beta, pout, q, partials, n);
  return static_cast<int>(cudaGetLastError());
}
