// Xell SpMV and merged-CG K1 for Hopper, with the COO spill tail applied
// in-kernel, both over the band body of xell_band.cuh (the layout, the
// order of the sums and the design are described there):
//   SpMV:  y[i] = sum of v * x[j] over the slots, then the spill
//   K1:    p'[i] = z[i] + beta*p[i];  q[i] = the same sum over p';
//          partials[band] = sum over the band's rows of p'[i]*q[i]
// so q and delta include the spill, as the reference's in-kernel spill makes
// them.  Every product and sum is rounded on its own, so y, and K1's p' and
// q, are the plain versions' bits (run on the CPU).
//
// Replaces: ogl_tpu/kernels/xell.py `_xell_kernel` (`_xell_padded`,
// `xell_matvec`), `_k1x_kernel` (`XellCgKernels.k1`, and `apply` = K1 with
// z = p = x, beta = 0), and the helper `_spill_corr` inside both.  The TPU
// kernels stream (tile, slot) planes through VMEM, cross two in-register
// lane gathers with MXU identity-matmul transposes and apply the spill as
// one-hot MXU matmuls, because a TPU has no fast gather; the GPU gathers
// the source at j directly and the spill is a short per-row loop.
//
// Bound: device-memory bytes, and the latency of a chain of three
// dependent reads per slot (ll, then bbT at the residue ll names, then the
// source at j).  Minimum traffic per row: K*(4 + 1 + 2) bytes of slots + x
// in and y out = K*7 + 8 bytes (K1: z and p in, p' and q out, K*7 + 16),
// plus 12 bytes per spill entry and 4 for sp_ptr.
//
// Both kernels launch one block of 512 threads per band of 2,048 rows (grid
// `kernels/xell.py band_grid(n)`) with the 59,392-byte ring as dynamic
// shared memory.  The SpMV gathers x through the read-only path and writes y
// as one float4 per thread.  K1 reads z and p (which may alias) through the
// read-only path, recomputes z[j] + beta*p[j] at every source (no read-back
// of p' across blocks), writes p' and q as one float4 each when every vector
// is 16-byte aligned (else row by row), and one float32 partial of
// sum p'*q per band (no atomics); beta arrives through a device pointer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "xell_band.cuh"

namespace {

__global__ void __launch_bounds__(ogl::kBandThreads, 2)
    xell_band_kernel(ogl::XellOperands m, const float* __restrict__ x, float* __restrict__ y,
                     int64_t n) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int64_t band = blockIdx.x;
  const int64_t i0 = ogl::band_row0(band);
  float acc[4];
  ogl::band_apply(m, ogl::XellLdgSource{x}, n, ring, band, acc);
  if (i0 + 3 < n) {
    reinterpret_cast<float4*>(y + i0)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e < n) y[i0 + e] = acc[e];
  }
}

__global__ void __launch_bounds__(ogl::kBandThreads, 2)
    xell_k1_kernel(ogl::XellOperands m, const float* z, const float* p,
                   const float* __restrict__ beta_ptr, float* pout, float* q,
                   float* __restrict__ partials, int64_t n, int vec) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int64_t band = blockIdx.x;
  const ogl::K1Source<true> src{z, p, *beta_ptr};
  float acc[4];
  ogl::band_apply(m, src, n, ring, band, acc);
  const float dot = ogl::band_k1_store(src, acc, pout, q, ogl::band_row0(band), n, vec);
  ogl::block_sum_to(dot, partials);
}

bool misaligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
}

// The checks both launches share: the band count and the operands' alignment.
int check_operands(const float* vals, const int8_t* ll, const int16_t* bbT, int n_slots,
                   int c_left, int64_t n, int64_t bands) {
  if (n_slots < 1 || c_left < 0 || n < 0 || bands != (n + ogl::kBandRows - 1) / ogl::kBandRows ||
      bands > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(vals, 16) || misaligned(ll, 16) || misaligned(bbT, 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

// y = A x over `bands` = ceil(n / 2048) blocks of 2,048 rows on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int ogl_xell_spmv(const float* vals, const int8_t* ll,
                             const int16_t* bbT, int n_slots, int c_left,
                             const int* sp_ptr, const int* sp_cols,
                             const int* sp_gidx, const float* sp_vals,
                             const float* x, float* y, int64_t n, int64_t bands,
                             void* stream) {
  const int bad = check_operands(vals, ll, bbT, n_slots, c_left, n, bands);
  if (bad) return bad;
  if (misaligned(y, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (bands == 0) return 0;
  static const cudaError_t ring = ogl::allow_ring(reinterpret_cast<const void*>(xell_band_kernel));
  if (ring != cudaSuccess) return static_cast<int>(ring);
  const ogl::XellOperands m{vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals};
  xell_band_kernel<<<static_cast<unsigned int>(bands), ogl::kBandThreads, ogl::kRingBytes,
                     static_cast<cudaStream_t>(stream)>>>(m, x, y, n);
  return static_cast<int>(cudaGetLastError());
}

// K1 over `bands` = ceil(n / 2048) blocks of 2,048 rows; `partials` holds
// `bands` floats.  vec != 0: z, p, pout and q are 16-byte aligned (p' and q
// go out as float4).  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_xell_k1(const float* vals, const int8_t* ll,
                           const int16_t* bbT, int n_slots, int c_left,
                           const int* sp_ptr, const int* sp_cols,
                           const int* sp_gidx, const float* sp_vals,
                           const float* z, const float* p, const float* beta,
                           float* pout, float* q, float* partials, int64_t n,
                           int vec, int64_t bands, void* stream) {
  const int bad = check_operands(vals, ll, bbT, n_slots, c_left, n, bands);
  if (bad) return bad;
  if (vec && (misaligned(z, 16) || misaligned(p, 16) || misaligned(pout, 16) ||
              misaligned(q, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (bands == 0) return 0;
  static const cudaError_t ring = ogl::allow_ring(reinterpret_cast<const void*>(xell_k1_kernel));
  if (ring != cudaSuccess) return static_cast<int>(ring);
  const ogl::XellOperands m{vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals};
  xell_k1_kernel<<<static_cast<unsigned int>(bands), ogl::kBandThreads, ogl::kRingBytes,
                   static_cast<cudaStream_t>(stream)>>>(m, z, p, beta, pout, q, partials, n,
                                                        vec);
  return static_cast<int>(cudaGetLastError());
}
