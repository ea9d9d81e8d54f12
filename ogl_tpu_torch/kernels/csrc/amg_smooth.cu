// AMG smoother passes for Hopper, one Dia stencil apply each:
//   ogl_amg_sweep:  out[i] = x[i] + (relax * invd[i]) * (b[i] - (A x)[i])
//   ogl_amg_resid:  out[i] = b[i] - (A x)[i]
// with (A x)[i] = sum_k data[k*n + i] * x[i + off_k], terms with i + off_k
// outside [0, n) dropped.
//
// Replaces: ogl_tpu/kernels/fused.py `_sweep_kernel` (through
// `CgKernels.ksweep`) and `_resid_kernel` (through `CgKernels.kresid`),
// whose shared stencil body is `_stencil_acc`.  The TPU kernels DMA a halo
// window of x per sequential tile (double-buffered) and shift it with lane
// rolls; on the GPU a shift is an address offset, so none of that carries
// over.
//
// Bound: device-memory bandwidth.  Per row: nd coefficients (4 bytes each in
// float32, 2 in bfloat16), x, b (and invd) in, out written; the shifted x
// re-reads are shared by neighbouring rows and mostly hit L1/L2.  About
// 2 * nd + 4 flops per row, far below the compute roofline.  On the coarse
// levels (16,384 rows at the 1M-cell case: 64 blocks of 256 threads) the
// card is far from full and the launch itself dominates.
//
// Design: one thread per row, so every stream is coalesced; the offsets
// (nd <= 64) are staged once per block in shared memory; row and
// coefficient indices are int64.  The coefficient type is a template
// parameter, float or __nv_bfloat16 (the reference packs its smoother
// operators in bfloat16 to halve the coefficient bytes); each coefficient is
// widened to float and the sum accumulates in float32, in offset order, the
// order of the plain version.  A sweep reads x at rows that other blocks
// own, so `out` must be a buffer of its own: the wrapper refuses an `out`
// that overlaps any operand.  relax arrives by value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDiags = 64;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// SWEEP: out = x + (relax * invd) * (b - A x); otherwise out = b - A x
// (invd unused, may be null).
template <typename T, bool SWEEP>
__global__ void amg_smooth_kernel(const T* __restrict__ data,
                                  const int* __restrict__ offsets, int nd,
                                  const float* __restrict__ x,
                                  const float* __restrict__ b,
                                  const float* __restrict__ invd, float relax,
                                  float* __restrict__ out, int64_t n) {
  __shared__ int s_off[kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) acc += widen(data[(int64_t)k * n + i]) * x[j];
  }
  const float res = b[i] - acc;
  if constexpr (SWEEP)
    out[i] = x[i] + (relax * invd[i]) * res;
  else
    out[i] = res;
}

template <bool SWEEP>
int launch(const void* data, int data_bf16, const int* offsets, int nd,
           const float* x, const float* b, const float* invd, float relax,
           float* out, int64_t n, int threads, void* stream) {
  if (nd < 0 || nd > kMaxDiags || threads <= 0 || threads > 1024 || n < 0 ||
      (data_bf16 != 0 && data_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (data_bf16)
    amg_smooth_kernel<__nv_bfloat16, SWEEP><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), offsets, nd, x, b, invd,
        relax, out, n);
  else
    amg_smooth_kernel<float, SWEEP><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(data), offsets, nd, x, b, invd, relax, out,
        n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (nd, n) coefficients, float32 (data_bf16 = 0) or bfloat16
// (data_bf16 = 1); x, b, invd, out: (n,) float32, out not overlapping x.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ogl_amg_sweep(const void* data, int data_bf16,
                             const int* offsets, int nd, const float* x,
                             const float* b, const float* invd, float relax,
                             float* out, int64_t n, int threads, void* stream) {
  return launch<true>(data, data_bf16, offsets, nd, x, b, invd, relax, out, n,
                      threads, stream);
}

extern "C" int ogl_amg_resid(const void* data, int data_bf16,
                             const int* offsets, int nd, const float* x,
                             const float* b, float* out, int64_t n,
                             int threads, void* stream) {
  return launch<false>(data, data_bf16, offsets, nd, x, b, nullptr, 0.0f, out,
                       n, threads, stream);
}
