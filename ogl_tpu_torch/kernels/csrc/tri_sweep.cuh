// The triangular sweep of the ILU family's apply for Hopper: k Jacobi sweeps
// of a strict triangular factor F (Csr, one lane per row) with the scale d,
//   x_0 = b * d,   x_{s+1}[i] = (b[i] - sum_j F[i, j] * x_s[j]) * d[i],
// first over the lower factor (b = r), then over the upper one (b = z, the
// lower's result).  d null means no scaling (ILU's unit lower factor).  ILU:
// L with d null, then U with 1/diag(U); IC: L with 1/diag(L), then L^T with
// the same.  Run to the factor's dependency depth the sweeps are exact
// substitution (tri_levels.cuh computes that in one pass per level).
//
// The row function `row_value` is csr_rows.cuh's `csr_row` over a source
// functor with the epilogue (b[i] - acc) * d[i] fused into it; kernel 1
// (tri_sweep.cu) and kernel 2 (tri_levels.cu) both call it, so a row's bits
// depend only on its sources.  Arithmetic, which the plain twins
// (kernels/tri_solve.py) repeat step by step: the row's entries summed in
// order from 0.0f, each product and sum rounded on its own (mul_add_rn),
// then one rounded subtraction and one rounded product.  With no sweep
// (k = 0) the pass skips the factor: (b - 0) * d is b * d to the bit.
//
// The sweeps are Jacobi: every row reads the previous sweep's vector, never
// this sweep's, so the result does not depend on the order of the rows or
// of the blocks (an in-place Gauss-Seidel sweep would compute another
// function).  The first sweep of a triangle reads x_0 = b * d recomputed at
// each source, so x_0 is never written; the sweeps ping-pong between two
// scratch vectors, the upper triangle's last sweep landing in `out`.
// Vectors written inside the launch (the scratch, z, out) are read through
// plain loads after a grid barrier; only the factors, r and d are read-only
// for the launch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_rows.cuh"  // csr_row, CsrOperands, mul_add_rn

namespace ogl {
namespace tri {

// One strict triangular factor of the apply and its scale (d null: 1).
struct Triangle {
  CsrOperands f;
  const float* d;
  int sweeps;  // k >= 0
};

// x_0 = b * d at source j (b possibly written inside the launch: plain loads).
struct Scaled {
  const float* b;
  const float* d;
  __device__ __forceinline__ float at(int64_t j) const {
    const float v = b[j];
    return d ? __fmul_rn(v, __ldg(d + j)) : v;
  }
};

// A vector of the launch, read after a grid barrier (plain loads).
struct Stored {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return x[j]; }
};

// (b[i] - sum_j F[i, j] * src(j)) * d[i]; with use_f false the sum is 0.
template <class Src>
__device__ __forceinline__ float row_value(const Triangle& t, bool use_f, const float* b,
                                           const Src& src, int64_t i) {
  const float acc = use_f ? csr_row(t.f.row_ptr, t.f.cols, t.f.vals, src, i) : 0.0f;
  const float v = __fsub_rn(b[i], acc);
  return t.d ? __fmul_rn(v, __ldg(t.d + i)) : v;
}

// The passes of one triangle over rows first, first + stride, ... < n:
// max(k, 1) of them, `sync()` before each but the first; the last writes
// `last`, the others alternate so that no pass writes what it reads.
// Returns the vector the last pass wrote.
template <class Sync>
__device__ __forceinline__ float* triangle_sweeps(const Triangle& t, const float* b,
                                                  float* last, float* other, int64_t n,
                                                  int64_t first, int64_t stride, Sync& sync) {
  const int passes = t.sweeps > 0 ? t.sweeps : 1;
  const float* prev = nullptr;
  for (int q = 0; q < passes; ++q) {
    float* dst = ((passes - 1 - q) & 1) == 0 ? last : other;
    if (q > 0) sync();
    if (q == 0) {
      const Scaled src{b, t.d};
      for (int64_t i = first; i < n; i += stride) dst[i] = row_value(t, t.sweeps > 0, b, src, i);
    } else {
      const Stored src{prev};
      for (int64_t i = first; i < n; i += stride) dst[i] = row_value(t, true, b, src, i);
    }
    prev = dst;
  }
  return const_cast<float*>(prev);
}

// The whole apply: the lower triangle's sweeps from r into t0 or t1, a
// barrier, the upper triangle's from that z into out (t1 or t0 beside it).
template <class Sync>
__device__ __forceinline__ void sweep_apply(const Triangle& lo, const Triangle& up,
                                            const float* r, float* t0, float* t1, float* out,
                                            int64_t n, int64_t first, int64_t stride,
                                            Sync& sync) {
  const float* z = triangle_sweeps(lo, r, t0, t1, n, first, stride, sync);
  float* spare = z == t0 ? t1 : t0;
  sync();
  triangle_sweeps(up, z, out, spare, n, first, stride, sync);
}

}  // namespace tri
}  // namespace ogl
