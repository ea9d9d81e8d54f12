// The AMG smoother on a Gdia level, for Hopper:
//   ogl_amg_gdia_sweep:  out[i] = x[i] + (relax * invd[i]) * (b[i] - (A x)[i])
//   ogl_amg_gdia_resid:  out[i] = b[i] - (A x)[i]
// with (A x)[i] = sum_k vals[k, r, l] * x[(r + q_k) * 128 + lidx[k, r, l]] on
// the (R, 128) view of row i = r * 128 + l (sources outside [0, n) dropped),
// the values float32 or bfloat16.
//
// Replaces: ogl_tpu/kernels/gdia.py `_gdia_kernel` (:183), which the
// reference's cycle runs as the A x of a Gdia level of at least 32k rows
// (ogl_tpu/precond/amg.py `_apply_mat`, :402-417, through `gdia_matvec`),
// with the smoother's elementwise work around it in XLA (`_smooth`,
// :420-430).  Here the SpMV and the elementwise work are one kernel.
//
// Bound: device-memory bandwidth.  Per row: np values (4 B, 2 B in
// bfloat16) and np source lanes (1 B), x, b (and invd) in, out written:
// np * (1 + value bytes) + (3 or 4) * 4 bytes, at 2 * np + 3 (sweep 5)
// flops per row; the gathered x re-reads hit L1/L2 mostly.
//
// Design: the Gdia row-quad body (gdia_k1.cuh `gdia_quad_sums`, amg_level.cuh
// `gdia_smooth_quad`): one thread per row quad, per plane one 16-byte (float)
// or 8-byte (bfloat16) load of the four values and one 4-byte load of the
// four lanes, the plane offsets staged in shared memory (at most
// kGdiaMaxPlanes), one quad per thread.  A sweep reads x at other rows, so
// `out` is a buffer of its own (the wrapper refuses an overlap).  Every
// operation is rounded as the plain version rounds it: the kernel gives its
// twin's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "amg_level.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSweep, typename T>
__global__ void __launch_bounds__(kThreads)
    gdia_smooth_kernel(const T* __restrict__ vals, const int8_t* __restrict__ lidx,
                       const int* __restrict__ qoffs, int np, int64_t r,
                       const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ invd, float relax, float* __restrict__ out,
                       int64_t n) {
  __shared__ int s_q[ogl::kGdiaMaxPlanes];
  for (int k = threadIdx.x; k < np; k += blockDim.x) s_q[k] = qoffs[k];
  __syncthreads();
  const int64_t quads = (n + 3) >> 2;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < quads;
       t += step)
    ogl::gdia_smooth_quad<kSweep>(vals, lidx, s_q, np, r * ogl::kGdiaLanes, x, b, invd, relax,
                                  out, t, n);
}

template <bool kSweep>
int launch(const void* vals, int vals_bf16, const int8_t* lidx, const int* qoffs, int np,
           int64_t r, const float* x, const float* b, const float* invd, float relax,
           float* out, int64_t n, int64_t blocks, void* stream) {
  if (np < 1 || np > ogl::kGdiaMaxPlanes || n < 0 || r * 128 < n || blocks < 1 ||
      blocks > INT32_MAX || (vals_bf16 != 0 && vals_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(vals) & (vals_bf16 ? 7 : 15)) ||
      (reinterpret_cast<uintptr_t>(lidx) & 3))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    gdia_smooth_kernel<kSweep, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), lidx, qoffs, np, r, x, b, invd, relax, out, n);
  else
    gdia_smooth_kernel<kSweep, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(vals), lidx, qoffs, np, r, x, b, invd, relax, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (np, R, 128) float32 (vals_bf16 = 0, 16-byte aligned) or bfloat16
// (vals_bf16 = 1, 8-byte aligned), lidx (np, R, 128) int8 (4-byte aligned),
// qoffs (np,) int32 on the device; x, b, invd, out (n,) float32, out not
// overlapping x.  Launches `blocks` blocks of 256 threads on `stream`, each
// thread striding over row quads; returns cudaGetLastError() (0 = launched).
extern "C" int ogl_amg_gdia_sweep(const void* vals, int vals_bf16, const int8_t* lidx,
                                  const int* qoffs, int np, int64_t r, const float* x,
                                  const float* b, const float* invd, float relax, float* out,
                                  int64_t n, int64_t blocks, void* stream) {
  return launch<true>(vals, vals_bf16, lidx, qoffs, np, r, x, b, invd, relax, out, n, blocks,
                      stream);
}

extern "C" int ogl_amg_gdia_resid(const void* vals, int vals_bf16, const int8_t* lidx,
                                  const int* qoffs, int np, int64_t r, const float* x,
                                  const float* b, float* out, int64_t n, int64_t blocks,
                                  void* stream) {
  return launch<false>(vals, vals_bf16, lidx, qoffs, np, r, x, b, nullptr, 0.0f, out, n,
                       blocks, stream);
}
