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
// rolls; here the shift is the choice of one or two aligned quads.  The row
// body is amg_smooth.cuh, also the smoothing phases of the device V-cycle
// (amg_loop.cuh).
//
// Bound: device-memory bandwidth.  Per row: nd coefficients (4 bytes each in
// float32, 2 in bfloat16), x, b (and invd) in, out written; the shifted x
// re-reads are shared by neighbouring rows and mostly hit L1/L2.  About
// 2 * nd + 4 flops per row, far below the compute roofline.
//
// Design: one thread per row QUAD when n % 4 == 0 and every stream is
// aligned (16 bytes; 8 for bfloat16 coefficients): the coefficients of a
// diagonal in one 16- or 8-byte load, x, b, invd and out as float4, the
// sources of each diagonal from one or two aligned x quads; otherwise one
// thread per row.  The branch is chosen here from n and the pointers, so
// the C signature is the one-thread-per-row kernel's.  The offsets (nd <=
// 64) are staged once per block in shared memory; indices are int64.  A
// sweep reads x at rows that other blocks own, so `out` must be a buffer of
// its own: the wrapper refuses an `out` that overlaps any operand.  relax
// arrives by value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "amg_smooth.cuh"
#include "loop.cuh"  // misaligned

namespace {

// SWEEP: out = x + (relax * invd) * (b - A x); otherwise out = b - A x
// (invd unused, may be null).
template <typename T, bool SWEEP>
__global__ void amg_smooth_kernel(const T* __restrict__ data,
                                  const int* __restrict__ offsets, int nd,
                                  const float* __restrict__ x,
                                  const float* __restrict__ b,
                                  const float* __restrict__ invd, float relax,
                                  float* __restrict__ out, int64_t n, int vec) {
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const ogl::BufSrc<true> src{x};
  if (vec) {
    if (id >= (n >> 2)) return;
    float v[4];
    if constexpr (SWEEP)
      ogl::sweep_quad(data, s_off, nd, src, b, invd, relax, id, n, v);
    else
      ogl::resid_quad(data, s_off, nd, src, b, id, n, v);
    reinterpret_cast<float4*>(out)[id] = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  if (id >= n) return;
  if constexpr (SWEEP)
    out[id] = ogl::sweep_row(data, s_off, nd, src, b, invd, relax, id, n);
  else
    out[id] = b[id] - ogl::ax_row(data, s_off, nd, src, id, n);
}

template <bool SWEEP>
int launch(const void* data, int data_bf16, const int* offsets, int nd,
           const float* x, const float* b, const float* invd, float relax,
           float* out, int64_t n, int threads, void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || threads <= 0 || threads > 1024 || n < 0 ||
      (data_bf16 != 0 && data_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = (n & 3) == 0 && !ogl::misaligned(data, data_bf16 ? 8 : 16) &&
                   !ogl::misaligned(x, 16) && !ogl::misaligned(b, 16) &&
                   !ogl::misaligned(out, 16) && !(SWEEP && ogl::misaligned(invd, 16));
  const int64_t items = vec ? (n >> 2) : n;
  const unsigned int blocks = static_cast<unsigned int>((items + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (data_bf16)
    amg_smooth_kernel<__nv_bfloat16, SWEEP><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), offsets, nd, x, b, invd,
        relax, out, n, vec);
  else
    amg_smooth_kernel<float, SWEEP><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(data), offsets, nd, x, b, invd, relax, out,
        n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (nd, n) coefficients, float32 (data_bf16 = 0) or bfloat16
// (data_bf16 = 1); x, b, invd, out: (n,) float32, out not overlapping x.
// Launches on `stream` (one thread per row quad or per row, `threads` per
// block); returns cudaGetLastError() (0 = launched).
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
