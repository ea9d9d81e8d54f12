// Exact substitution of the ILU family's apply for Hopper (`triSolve
// exact`): the rows of a strict triangular factor walked level by level,
//   x[i] = (b[i] - sum_j F[i, j] * x[j]) * d[i]   for the rows i of level l,
// level 0 first, a grid barrier between levels, first the lower factor
// (b = r, into z), then the upper one (b = z, into out).  A row's level is
// 0 without entries, else 1 + the largest level of its sources
// (precond/ilu.py `factor_levels`), so every source of a row was written
// before the barrier that opens its level.
//
// Each row is tri_sweep.cuh's `row_value` over the finished vector, the
// function a sweep computes, so a row's bits are those of kernel 1 run to
// the factor's dependency depth (every row is then exact, and computed from
// the same exact sources in the same order).
//
// The rows of a level are a contiguous run of the level-ordered row list
// (`order`, rows ascending within a level; `level_ptr` has levels + 1
// offsets), spread over the grid: rows first, first + stride, ... of each
// run.  Bound: the barriers.  One pass over each factor moves its bytes once,
// but a level of a 7-point grid's factor holds a wavefront of a few thousand
// rows, so the grid is sized to the widest level and the time is the
// levels' count times a barrier and one dependent row.  A design without
// grid barriers (each row waiting on ready flags of its sources) is a later
// redesign.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_sweep.cuh"  // Triangle, Stored, row_value

namespace ogl {
namespace tri {

// The level schedule of one factor: read-only for the launch.
struct Levels {
  const int* order;      // (n,) the rows, level after level
  const int* level_ptr;  // (levels + 1,) offsets into order
  int levels;            // >= 1
};

// One triangle's levels: rows of level l write x, `sync()` between levels.
template <class Sync>
__device__ __forceinline__ void triangle_levels(const Triangle& t, const Levels& lv,
                                                const float* b, float* x, int64_t first,
                                                int64_t stride, Sync& sync) {
  const Stored src{x};
  for (int l = 0; l < lv.levels; ++l) {
    if (l > 0) sync();
    const int64_t end = __ldg(lv.level_ptr + l + 1);
    for (int64_t k = __ldg(lv.level_ptr + l) + first; k < end; k += stride) {
      const int64_t i = __ldg(lv.order + k);
      x[i] = row_value(t, true, b, src, i);
    }
  }
}

// The whole exact apply: r -> z over the lower factor, a barrier, z -> out.
template <class Sync>
__device__ __forceinline__ void level_apply(const Triangle& lo, const Levels& llv,
                                            const Triangle& up, const Levels& ulv,
                                            const float* r, float* z, float* out, int64_t first,
                                            int64_t stride, Sync& sync) {
  triangle_levels(lo, llv, r, z, first, stride, sync);
  sync();
  triangle_levels(up, ulv, z, out, first, stride, sync);
}

}  // namespace tri
}  // namespace ogl
