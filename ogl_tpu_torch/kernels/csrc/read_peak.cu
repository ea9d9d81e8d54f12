// Plane sum for Hopper — the read-dominant streaming probe of the roofline:
// y[i] = c * d[0*n + i] + sum_{k>=1} d[k*n + i], c a device scalar.
//
// Replaces: ogl_tpu/kernels/roofline.py `_read_peak_kernel` -> `_rk`.  The
// TPU kernel streams (nd, tile, 128) coefficient blocks through VMEM with
// the SpMV's block pipeline but no x window, so it is a ceiling that the
// SpMV can demonstrate against on the same traffic shape.  On the GPU the
// same role is played by the port's Dia kernels' own access pattern
// (csrc/dia_spmv.cu, csrc/cg_k1.cu) without their x reads.
//
// Bound: device-memory bandwidth.  Per row it reads nd floats and writes
// one, (nd + 1) * n * 4 bytes for nd flops.
//
// Design: one thread per row, rows contiguous across a warp, so every
// d[k*n + i] load and the y store are fully coalesced; the nd loads of a
// thread are independent, so a warp has nd loads in flight.  c is read
// through a device pointer, so a chain's scalar carry never crosses to the
// host.  Accumulation is float32 in plane order, as `_rk`; the product and
// the sums are rounded one by one (__fmul_rn, __fadd_rn: no fused
// multiply-add), which is the plain version's arithmetic exactly.  Row and
// plane indices are int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void read_peak_kernel(const float* __restrict__ c,
                                 const float* __restrict__ d, int nd,
                                 float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = __fmul_rn(d[i], __ldg(c));
  for (int k = 1; k < nd; ++k) acc = __fadd_rn(acc, d[(int64_t)k * n + i]);
  y[i] = acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ogl_read_peak(const float* c, const float* d, int nd, float* y,
                             int64_t n, int threads, void* stream) {
  if (nd < 1 || threads <= 0 || threads > 1024 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + threads - 1) / threads;
  read_peak_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(c, d, nd, y, n);
  return static_cast<int>(cudaGetLastError());
}
