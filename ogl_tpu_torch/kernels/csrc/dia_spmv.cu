// Dia (stencil) SpMV for Hopper: y[i] = sum_k data[k*n + i] * x[i + off_k],
// terms with i + off_k outside [0, n) dropped.
//
// Replaces: ogl_tpu/kernels/pallas_spmv.py `_kernel` (called through
// `_dia_spmv_padded`, `dia_matvec`, `dia_spmv`).  The TPU kernel streams
// (nd, T, 128) coefficient blocks and builds the shifted x from a DMA'd
// halo window with lane rolls; on the GPU a shift is an address offset.
// Its row body (dia_rows.cuh) is also the two SpMV phases of the persistent
// general-BiCGStab loop (bicgstab_gen_loop.cu), with recomputed sources.
//
// Bound: device-memory bandwidth.  Per row it reads nd coefficients and
// writes one y, and reads x at nd shifted positions that neighbouring rows
// share, so the minimum traffic is (nd + 2) * n * 4 bytes for about
// 2 * nd flops — far below the compute roofline.
//
// Design: dia_rows.cuh over the source x[j] — row quads (float4 loads of the
// coefficients and of the one or two aligned x quads that hold a diagonal's
// sources, a float4 store of y) when n % 4 == 0 and data, x and y are
// 16-byte aligned, else one thread per row — on a grid-stride grid sized by
// the caller from the SM count (kernels/dia_spmv.py `persistent_launch`: one
// quad per thread up to 8.4M rows).  The offsets (nd <= 64) are staged once
// per block in shared memory.  Accumulation is float32 in offset order, each
// product and sum rounded as the plain version rounds them.  Row and
// coefficient indices are int64 (k*n + i must not rely on n*nd < 2^31).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"
#include "loop.cuh"  // misaligned

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const float* __restrict__ data, const int* __restrict__ offsets, int nd,
                    const float* __restrict__ x, float* __restrict__ y, int64_t n, int vec) {
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();
  const ogl::XSource src{x};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (vec) {
    for (int64_t t = first; t < (n >> 2); t += step)
      reinterpret_cast<float4*>(y)[t] = ogl::dia_quad(data, s_off, nd, src, src.quad(t), t, n);
  } else {
    for (int64_t i = first; i < n; i += step)
      y[i] = ogl::dia_row(data, s_off, nd, src, src.at(i), i, n);
  }
}

}  // namespace

extern "C" const char* ogl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches `blocks` blocks of 256 threads on `stream`; vec != 0 takes the
// row-quad branch (n % 4 == 0, data, x and y 16-byte aligned).  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_dia_spmv(const float* data, const int* offsets, int nd, const float* x,
                            float* y, int64_t n, int vec, int64_t blocks, void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ogl::misaligned(data, 16) || ogl::misaligned(x, 16) ||
              ogl::misaligned(y, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  dia_spmv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(data, offsets, nd, x, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}
