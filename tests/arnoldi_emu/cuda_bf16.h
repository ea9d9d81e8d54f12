// bfloat16 of the CPU stand-in: round to nearest even, as the card does.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short v;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(unsigned{b.v} << 16); }
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
struct float2 {
  float x, y;
};
inline float2 __bfloat1622float2(__nv_bfloat162 b) {
  return float2{__bfloat162float(b.x), __bfloat162float(b.y)};
}
