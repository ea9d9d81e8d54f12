// Plane sum for Hopper — the read-dominant streaming probe of the roofline:
// y[i] = c * d[0*n + i] + sum_{k>=1} d[k*n + i], c a device scalar.
//
// Replaces: ogl_tpu/kernels/roofline.py `_read_peak_kernel` -> `_rk`.  The
// TPU kernel streams (nd, tile, 128) coefficient blocks through VMEM with
// the SpMV's block pipeline but no x window, so it is a ceiling that the
// SpMV can demonstrate against on the same traffic shape.
//
// Bound: device-memory bandwidth.  Per row it reads nd floats and writes
// one, (nd + 1) * n * 4 bytes for nd flops.  Reaching the bandwidth takes
// enough bytes in flight per SM and few instructions per byte.
//
// Design: a persistent grid (a few blocks per SM, the count from the
// caller, who sizes it from the SM count) strides over row quads.  Each
// thread issues the loads of up to kChunk planes of its quad as float4
// loads through the read-only path (__ldg) before the first add, so a
// thread keeps kChunk 16-byte loads in flight, and stores y as one float4
// (the evict-first streaming load __ldcs read slower on the H100).
// The vector branch needs every plane 16-byte aligned (n % 4 == 0 and d
// aligned) and y aligned; otherwise — an odd n, a short n, a base
// that is not aligned — the same kernel takes its scalar branch, one row
// per step with the same load-then-add order.  c is read through a device
// pointer, so a chain's scalar carry never crosses to the host.
// Accumulation is float32 in plane order, as `_rk`; the product and the
// sums are rounded one by one (__fmul_rn, __fadd_rn: no fused multiply-add),
// which is the plain version's arithmetic exactly.  Row and plane indices
// are int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;     // planes whose loads are in flight together
constexpr int kThreads = 256;

__device__ __forceinline__ float4 mul4(float4 a, float c) {
  return make_float4(__fmul_rn(a.x, c), __fmul_rn(a.y, c), __fmul_rn(a.z, c),
                     __fmul_rn(a.w, c));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One row (T = float) or one quad of rows (T = float4) at index `at` of
// planes of `stride` elements: c * d[0] + d[1] + ... in plane order.
template <class T>
__device__ __forceinline__ T plane_sum_at(const T* __restrict__ d, int nd, int64_t stride,
                                          int64_t at, float c) {
  T acc;
  for (int k0 = 0; k0 < nd; k0 += kChunk) {
    T v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (k0 + u < nd) v[u] = __ldg(d + (k0 + u) * stride + at);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < nd) {
        if constexpr (sizeof(T) == sizeof(float4))
          acc = k0 + u == 0 ? mul4(v[0], c) : add4(acc, v[u]);
        else
          acc = k0 + u == 0 ? __fmul_rn(v[0], c) : __fadd_rn(acc, v[u]);
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    read_peak_kernel(const float* __restrict__ c_ptr, const float* __restrict__ d,
                     int nd, float* __restrict__ y, int64_t n, int vec) {
  const float c = __ldg(c_ptr);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = first; i < n4; i += step) y4[i] = plane_sum_at(d4, nd, n4, i, c);
  } else {
    for (int64_t i = first; i < n; i += step) y[i] = plane_sum_at(d, nd, n, i, c);
  }
}

}  // namespace

// Launches `blocks` blocks of 256 threads on `stream`; vec != 0 takes the
// float4 branch, which needs n % 4 == 0 and d and y 16-byte aligned.
// Returns cudaGetLastError() (0 = launched).
extern "C" int ogl_read_peak(const float* c, const float* d, int nd, float* y, int64_t n,
                             int vec, int64_t blocks, void* stream) {
  if (nd < 1 || n < 0 || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || (reinterpret_cast<uintptr_t>(d) & 15) != 0 ||
              (reinterpret_cast<uintptr_t>(y) & 15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  read_peak_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(c, d, nd, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}
