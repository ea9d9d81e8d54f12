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
// Design: one thread per output row.  A CUDA block takes whole Jacobi blocks
// (floor(256 / bs) of them, R rows) and walks the padded rows grid-stride.
// The inverses are stored transposed within each block, inv_t[b, k, i] =
// inv[b, i, k], so for each k the threads of a block read consecutive
// floats.  Each thread stages its own r in shared memory; after a barrier
// every thread of a Jacobi block reads that block's bs values from there.
// Every product and every sum is rounded separately (__fmul_rn, __fadd_rn),
// in k order from 0.0f, as the plain twin writes them, so kernel and twin
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    block_jacobi_kernel(const float* __restrict__ inv_t, const float* __restrict__ r,
                        float* __restrict__ y, int64_t n, int bs) {
  __shared__ float s_r[kThreads];
  const int per = (kThreads / bs) * bs;  // rows per tile: whole Jacobi blocks
  const int local = threadIdx.x;
  const int i = local % bs;
  const int64_t padded = (n + bs - 1) / bs * bs;
  const int64_t tiles = (padded + per - 1) / per;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g = tile * per + local;
    const bool row = local < per && g < padded;
    s_r[local] = (local < per && g < n) ? r[g] : 0.0f;
    __syncthreads();
    if (row) {
      const float* inv = inv_t + (g - i) * bs + i;  // block g / bs, column i
      const float* rb = s_r + (local - i);
      float acc = 0.0f;
      for (int k = 0; k < bs; ++k)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(inv + static_cast<int64_t>(k) * bs), rb[k]));
      if (g < n) y[g] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; inv_t holds
// ceil(n / bs) blocks of bs x bs floats.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_block_jacobi(const float* inv_t, const float* r, float* y, int64_t n,
                                int bs, int64_t blocks, void* stream) {
  if (n < 0 || bs < 2 || bs > 32 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  block_jacobi_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(inv_t, r, y, n, bs);
  return static_cast<int>(cudaGetLastError());
}
