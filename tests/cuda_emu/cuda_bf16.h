// bfloat16 of the CPU stand-in: the storage type only (the bodies read its
// bits and widen them themselves).
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short v;
};
