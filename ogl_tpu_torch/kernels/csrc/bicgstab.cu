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
// `CgKernels.k1b`, on the route that keeps the host loop: a plan that is not
// CgKernels itself).  Its row body (bicgstab_k1b.cuh) is also the two K1B
// phases of the persistent merged-BiCGStab loop (bicgstab_loop.cu).  Plain
// twin: `k1b_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Minimum traffic per row: nd coefficients
// + a, b, c, rhat in + w, q out = (nd + 6) * 4 bytes (52 B at 7 diagonals),
// 48 B when b and c are one tensor; about 2 * nd + 10 flops.
//
// Design: a grid-stride grid sized by the caller from the SM count
// (kernels/fused.py K2_BLOCKS_PER_SM: one row quad per thread up to 8.4M
// rows) walks row quads with float4 loads of the coefficients, the centre
// vectors and the aligned quads that hold each diagonal's sources when
// n % 4 == 0 and every stream is 16-byte aligned; otherwise the same kernel
// walks rows (bicgstab_k1b.cuh).  When b and c are one tensor (the second
// K1B of an iteration passes v' twice) the kernel reads it once per source.
// Other blocks read a, b and c at the neighbours while this block writes w
// and q, so the wrapper refuses outputs that overlap an operand.  ca and cb
// arrive through device pointers (the solver computes beta*omega and -alpha
// on the device), so a launch never waits for the host.  The three block
// partials come out of one shared-memory pass (block_sum.cuh), no float
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bicgstab_k1b.cuh"
#include "block_sum.cuh"
#include "loop.cuh"  // misaligned

namespace {

constexpr int kThreads = 256;

template <bool kBisC>
__global__ void __launch_bounds__(kThreads)
    bicgstab_k1b_kernel(const float* __restrict__ data, const int* __restrict__ offsets, int nd,
                        const float* a, const float* b, const float* c,
                        const float* __restrict__ rhat, const float* __restrict__ ca_ptr,
                        const float* __restrict__ cb_ptr, float* w, float* q, float* partials,
                        int64_t n, int vec) {
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();
  float sums[3] = {0.0f, 0.0f, 0.0f};
  ogl::k1b_span<kBisC, true>(data, s_off, nd, a, b, c, rhat, *ca_ptr, *cb_ptr, w, q, n, vec,
                             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                             static_cast<int64_t>(gridDim.x) * blockDim.x, sums);
  ogl::block_sums_to<3>(sums, partials);
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; `partials` holds
// (3, blocks) floats.  b and c may be the same tensor; w and q must overlap
// none of the inputs.  vec != 0 takes the row-quad branch, which needs
// n % 4 == 0 and data, a, b, c, rhat, w and q 16-byte aligned.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_bicgstab_k1b(const float* data, const int* offsets, int nd,
                                const float* a, const float* b, const float* c,
                                const float* rhat, const float* ca, const float* cb, float* w,
                                float* q, float* partials, int64_t n, int vec, int64_t blocks,
                                void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ogl::misaligned(data, 16) || ogl::misaligned(a, 16) ||
              ogl::misaligned(b, 16) || ogl::misaligned(c, 16) || ogl::misaligned(rhat, 16) ||
              ogl::misaligned(w, 16) || ogl::misaligned(q, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == c)
    bicgstab_k1b_kernel<true><<<grid, kThreads, 0, st>>>(data, offsets, nd, a, b, nullptr, rhat,
                                                         ca, cb, w, q, partials, n, vec);
  else
    bicgstab_k1b_kernel<false><<<grid, kThreads, 0, st>>>(data, offsets, nd, a, b, c, rhat, ca,
                                                          cb, w, q, partials, n, vec);
  return static_cast<int>(cudaGetLastError());
}
