// The block-Jacobi apply ("BJ" with maxBlockSize > 1), for Hopper:
//   y[b * bs + i] = sum_k inv[b, i, k] * r[b * bs + k]
// over uniform contiguous blocks of bs rows (the last one padded with
// identity rows, as the set-up pads it), for bs from 2 to 32.
//
// Replaces no TPU kernel: the reference applies its (nb, bs, bs) inverses as
// one XLA einsum (ogl_tpu/precond/jacobi.py:56-59).  Plain twin:
// `block_jacobi_plain` in ogl_tpu_torch/kernels/block_jacobi.py.
//
// Bound: device-memory bandwidth.  Per row it reads one row of its block's
// inverse (bs floats) and r, and writes y: (bs + 2) * 4 bytes, for 2 * bs
// flops (24 bytes at bs 4: 7.2 us at 1M rows against 3.35 TB/s).
//
// Design: the body of block_jacobi.cuh over the source r[g] (one thread per
// output row, whole Jacobi blocks per CTA tile, the source staged in shared
// memory, the transposed inverses read coalesced), CTAs of 256 threads
// walking the tiles grid-stride.  Every product and every sum is rounded
// separately, in k order from 0.0f, as the plain twin writes them, so
// kernel and twin give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_jacobi.cuh"

namespace {

constexpr int kThreads = 256;

// The standalone apply's source and sink: w = r[g], y[g] = the sum.
struct RSource {
  const float* r;
  __device__ __forceinline__ float at(int64_t g) const { return __ldg(r + g); }
};

struct YSink {
  float* y;
  __device__ __forceinline__ void operator()(int64_t g, float, float acc) const { y[g] = acc; }
};

__global__ void __launch_bounds__(kThreads)
    block_jacobi_kernel(const float* __restrict__ inv_t, const float* __restrict__ r,
                        float* __restrict__ y, int64_t n, int bs) {
  __shared__ float stage[kThreads];
  ogl::bj::apply_tiles(inv_t, ogl::bj::tiling(n, bs), RSource{r}, YSink{y}, n, stage,
                       blockIdx.x, gridDim.x);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; inv_t holds
// ceil(n / bs) blocks of bs x bs floats.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_block_jacobi(const float* inv_t, const float* r, float* y, int64_t n,
                                int bs, int64_t blocks, void* stream) {
  if (n < 0 || bs < ogl::bj::kMinBlock || bs > ogl::bj::kMaxBlock || blocks < 1 ||
      blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  block_jacobi_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(inv_t, r, y, n, bs);
  return static_cast<int>(cudaGetLastError());
}
