// Dia (stencil) SpMV for Hopper: y[i] = sum_k data[k*n + i] * x[i + off_k],
// terms with i + off_k outside [0, n) dropped.
//
// Replaces: ogl_tpu/kernels/pallas_spmv.py `_kernel` (called through
// `_dia_spmv_padded`, `dia_matvec`, `dia_spmv`).  The TPU kernel streams
// (nd, T, 128) coefficient blocks and builds the shifted x from a DMA'd
// halo window with lane rolls; on the GPU a shift is just an address
// offset, so none of that carries over.
//
// Bound: device-memory bandwidth.  Per row it reads nd coefficients and
// writes one y, and reads x at nd shifted positions that neighbouring rows
// share, so the minimum traffic is (nd + 2) * n * 4 bytes for about
// 2 * nd flops — far below the compute roofline.
//
// Design: one thread per row, rows contiguous across a warp, so every
// data[k*n + i] load and the y store are fully coalesced and the shifted
// x[i + off] loads are coalesced too (the same 32 consecutive words, moved
// by off); the x re-reads across the nd offsets hit L1/L2.  The offsets
// (nd <= 64) are staged once per block in shared memory.  Accumulation is
// float32 in offset order — the order of the plain version.  Row and
// coefficient indices are int64 (k*n + i must not rely on n*nd < 2^31).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDiags = 64;

__global__ void dia_spmv_kernel(const float* __restrict__ data,
                                const int* __restrict__ offsets, int nd,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t n) {
  __shared__ int s_off[kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + s_off[k];
    if (j >= 0 && j < n) acc += data[(int64_t)k * n + i] * x[j];
  }
  y[i] = acc;
}

}  // namespace

extern "C" const char* ogl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ogl_dia_spmv(const float* data, const int* offsets, int nd,
                            const float* x, float* y, int64_t n, int threads,
                            void* stream) {
  if (nd < 0 || nd > kMaxDiags || threads <= 0 || threads > 1024 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + threads - 1) / threads;
  dia_spmv_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(data, offsets, nd, x,
                                                          y, n);
  return static_cast<int>(cudaGetLastError());
}
