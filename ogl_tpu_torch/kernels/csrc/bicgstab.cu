// K1B of the merged BiCGStab, for Hopper:
//   w[j] = a[j] + ca * b[j] + cb * c[j]
//   q[i] = sum_k data[k*n + i] * w[i + off_k]   (terms outside [0, n) dropped)
//   partials[0, block] = sum over the block's rows of rhat[i] * q[i]
//   partials[1, block] = sum over the block's rows of q[i] * w[i]
//   partials[2, block] = sum over the block's rows of q[i] * q[i]
// w is written at every row (the centre value, whether or not the Dia has
// offset 0); torch.sum(partials, dim=1) finishes the sums outside the kernel.
//
// Replaces: ogl_tpu/kernels/fused.py `_k1b_kernel` (called through
// `CgKernels.k1b`).  Plain twin: `k1b_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Minimum traffic per row: nd coefficients
// + a, b, c, rhat in + w, q out = (nd + 6) * 4 bytes (52 B at 7 diagonals),
// 48 B when b and c are one tensor; about 2 * nd + 10 flops.
//
// Design: one thread per row (coalesced streams).  The TPU kernel forms w
// over three halo windows; here each thread recomputes a + ca*b + cb*c at
// every source, as K1 recomputes p' (csrc/cg_k1.cu), so w is written once and
// never read back.  Other blocks read a, b and c at the neighbours while this
// block writes w and q, so the wrapper refuses outputs that overlap an
// operand.  a, b, c, rhat and data are only read, so __restrict__ holds for
// them even when b and c are one tensor (the second K1B of an iteration
// passes v twice); the outputs carry no __restrict__.  ca and cb arrive
// through device pointers (the solver computes beta*omega and -alpha on the
// device), so a launch never waits for the host.  The three block partials
// come out of one shared-memory pass (block_sum.cuh), no float atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kMaxDiags = 64;

__global__ void bicgstab_k1b_kernel(const float* __restrict__ data,
                                    const int* __restrict__ offsets, int nd,
                                    const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    const float* __restrict__ c,
                                    const float* __restrict__ rhat,
                                    const float* __restrict__ ca_ptr,
                                    const float* __restrict__ cb_ptr, float* w,
                                    float* q, float* partials, int64_t n) {
  __shared__ int s_off[kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const float ca = *ca_ptr;
  const float cb = *cb_ptr;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float sums[3] = {0.0f, 0.0f, 0.0f};
  if (i < n) {
    float acc = 0.0f;
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + s_off[k];
      if (j >= 0 && j < n) acc += data[(int64_t)k * n + i] * (a[j] + ca * b[j] + cb * c[j]);
    }
    const float wc = a[i] + ca * b[i] + cb * c[i];
    w[i] = wc;
    q[i] = acc;
    sums[0] = rhat[i] * acc;
    sums[1] = acc * wc;
    sums[2] = acc * acc;
  }
  ogl::block_sums_to<3>(sums, partials);
}

}  // namespace

// Launches `grid` blocks of `threads` on `stream`; `partials` holds 3 * grid
// floats.  b and c may be the same tensor; w and q must overlap none of the
// inputs.  threads must be a multiple of 32 in [32, 1024] and grid must cover
// n.  Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_bicgstab_k1b(const float* data, const int* offsets, int nd,
                                const float* a, const float* b, const float* c,
                                const float* rhat, const float* ca,
                                const float* cb, float* w, float* q,
                                float* partials, int64_t n, int threads,
                                int64_t grid, void* stream) {
  if (nd < 0 || nd > kMaxDiags || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || n < 0 || grid * threads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  bicgstab_k1b_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      data, offsets, nd, a, b, c, rhat, ca, cb, w, q, partials, n);
  return static_cast<int>(cudaGetLastError());
}
