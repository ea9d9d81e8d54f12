// Coefficients stored as float or __nv_bfloat16, widened to float where a
// row body reads them: the AMG level smoothers (amg_ell_smooth.cu,
// amg_gdia_smooth.cu) read their operators packed in bfloat16 by default,
// every other caller of the same row bodies (ell_rows.cuh, gdia_k1.cuh)
// reads float.  Widening a bfloat16 is exact (its 16 bits become the high
// half of a float), so it is done on the bits: one value (`to_f32`) or four
// neighbouring ones (`load4_f32`, one 16- or 8-byte load; the address a
// multiple of four values).  amg_smooth.cuh keeps its own `widen`/`coef4`
// for the Dia smoother, over the bfloat16 intrinsics.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16);
}

__device__ __forceinline__ float4 load4_f32(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* __restrict__ p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

}  // namespace ogl
