// The triangular sweep of the ILU family's apply for Hopper: k Jacobi sweeps
// of a strict triangular factor F (Csr) with the scale d,
//   x_0 = b * d,   x_{s+1}[i] = (b[i] - sum_j F[i, j] * x_s[j]) * d[i],
// first over the lower factor (b = r), then over the upper one (b = z, the
// lower's result).  d null means no scaling (ILU's unit lower factor).  ILU:
// L with d null, then U with 1/diag(U); IC: L with 1/diag(L), then L^T with
// the same.  Run to the factor's dependency depth the sweeps are exact
// substitution (tri_levels.cuh computes that in one pass).
//
// The row arithmetic, shared with kernel 2 (tri_levels.cuh) and repeated
// step by step by the plain twins (kernels/tri_solve.py): the row's entries
// summed in entry order from 0.0f, each product and sum rounded on its own
// (mul_add_rn), then `finish`: one rounded subtraction and one rounded
// product.  So a row's bits depend only on its sources, whichever kernel,
// layout or order computes it.  With no sweep (k = 0) the pass skips the
// factor: (b - 0) * d is b * d to the bit.
//
// The sweeps are Jacobi: every row reads the previous sweep's vector, never
// this sweep's, so the result does not depend on the order of the rows or
// of the CTAs.  The first sweep of a triangle reads x_0 = b * d recomputed at
// each source, so x_0 is never written; the sweeps ping-pong between two
// scratch vectors, the upper triangle's last sweep landing in `out`.
//
// Layout (kernel 1, tri_sweep.cu).  Held: one CTA per SM owns a contiguous
// range of rows, balanced by entries on the host (kernels/tri_solve.py
// `sweep_plan`); at the start of each triangle the CTA brings the row
// offsets and the entries of its range's first rows, as many as its shared
// memory holds, into shared memory once, by bulk copies; every sweep reads
// those rows from there and the rest of its range from device memory, in
// the same pass.  Streamed (a factor of which too little would fit): the
// rows dealt over the whole grid, every pass reading them from device
// memory, and the SMs' memory left to L1.  A thread takes one row at a
// time, the loads of kCsrChunk entries in flight before their adds
// (csr_rows.cuh `csr_row`), and keeps b and d of its first kRegRows rows in
// registers.  The vectors written in the launch are read with plain loads
// after the grid barrier (its device-scope release and acquire make every
// CTA's stores visible to them; through L1 they cost less than through L2
// alone: ogl_tpu_torch/tri_tune.py).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_rows.cuh"  // CsrOperands, kCsrChunk, mul_add_rn
#include "tma.cuh"
#include "tri_sync.cuh"

namespace ogl {
namespace tri {

constexpr int kRegRows = 4;  // rows per thread whose b and d stay in registers

// One strict triangular factor of the apply and its scale (d null: 1).
struct Triangle {
  CsrOperands f;
  const float* d;
  int sweeps;  // k >= 0
};

// (b - acc) * d, or b - acc unscaled: the epilogue of every row.
__device__ __forceinline__ float finish(float b, float acc, bool scaled, float d) {
  const float v = __fsub_rn(b, acc);
  return scaled ? __fmul_rn(v, d) : v;
}

// A factor's rows in device memory (read-only for the launch).
struct GlobalRows {
  CsrOperands f;
  __device__ __forceinline__ int begin(int64_t i) const { return __ldg(f.row_ptr + i); }
  __device__ __forceinline__ int col(int64_t k) const { return __ldg(f.cols + k); }
  __device__ __forceinline__ float val(int64_t k) const { return __ldg(f.vals + k); }
};

// The CTA's copy of some rows in shared memory: row offsets from row
// ptr_base on, entries from entry_base on (both 4-aligned, so every array
// sits at the 16-byte phase of its source).
struct SharedRows {
  const int* ptr;
  const int* cols;
  const float* vals;
  int64_t ptr_base, entry_base;
  __device__ __forceinline__ int begin(int64_t i) const { return ptr[i - ptr_base]; }
  __device__ __forceinline__ int col(int64_t k) const { return cols[k - entry_base]; }
  __device__ __forceinline__ float val(int64_t k) const { return vals[k - entry_base]; }
};

// b at row j: read-only for the launch (r) or written in it (z).
__device__ __forceinline__ float load_b(const float* b, bool written, int64_t j) {
  return written ? b[j] : __ldg(b + j);
}

// x_0 = b * d at source j.
struct Scaled {
  const float* b;
  const float* d;
  bool written;
  __device__ __forceinline__ float at(int64_t j) const {
    const float v = load_b(b, written, j);
    return d ? __fmul_rn(v, __ldg(d + j)) : v;
  }
};

// The previous sweep's vector.
struct Stored {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return x[j]; }
};

// Each CTA's rows of one triangle (kernels/tri_solve.py `sweep_plan`):
// CTA c owns rows [bounds[c], bounds[c + 1]) and holds [bounds[c], held[c])
// in shared memory.  Read-only for the launch.  Null bounds: nothing held,
// the rows dealt over the whole grid, row i to thread i mod the grid's.
struct Part {
  const int* bounds;  // (ctas + 1,)
  const int* held;    // (ctas,)
};

// This thread's view of its CTA's range of one triangle: its rows first,
// first + stride, ... < r1.
struct Span {
  int64_t r0, r1, rh;  // owned [r0, r1), held [r0, rh)
  int64_t first, stride;
  SharedRows shared;
  GlobalRows global;
  const float* b;
  bool b_written;
  const float* d;
};

__device__ __forceinline__ int64_t round4(int64_t v) { return (v + 3) & ~int64_t{3}; }

// The 4-aligned middle [a, z) of [lo, hi) (a = z when it holds none).
__device__ __forceinline__ void aligned_middle(int64_t lo, int64_t hi, int64_t& a, int64_t& z) {
  a = round4(lo) < hi ? round4(lo) : hi;
  z = (hi & ~int64_t{3}) > a ? (hi & ~int64_t{3}) : a;
}

// Elements [lo, hi) of src into dst (element k at dst[k - base], base
// 4-aligned): the aligned middle by bulk copies that thread 0 issues on
// `bar`, the ragged ends by plain loads of all threads.
template <class T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int64_t base, int64_t lo,
                                          int64_t hi, uint64_t* bar) {
  constexpr int64_t kPiece = 32768 / sizeof(T);  // elements per bulk copy
  int64_t a, z;
  aligned_middle(lo, hi, a, z);
  if (threadIdx.x == 0)
    for (int64_t k = a; k < z; k += kPiece) {
      const int64_t m = z - k < kPiece ? z - k : kPiece;
      tma::copy(dst + (k - base), src + k, static_cast<uint32_t>(m * sizeof(T)), bar);
    }
  for (int64_t k = lo + threadIdx.x; k < a; k += blockDim.x) dst[k - base] = src[k];
  for (int64_t k = z + threadIdx.x; k < hi; k += blockDim.x) dst[k - base] = src[k];
}

__device__ __forceinline__ uint32_t bulk_bytes(int64_t lo, int64_t hi) {
  int64_t a, z;
  aligned_middle(lo, hi, a, z);
  return static_cast<uint32_t>(4 * (z - a));
}

// The CTA's copy of rows [r0, rh) of f (their offsets r0..rh and their
// entries) in `smem` of `capacity` bytes: issued (bulk copies completing on
// `bar`, thread 0 arriving with their bytes first, so the phase cannot
// complete before they are counted; ragged ends stored by every thread), not
// waited for.  A range too large for the capacity traps: the host plan keeps
// every range below it.
__device__ __forceinline__ SharedRows stage_rows(const CsrOperands& f, int64_t r0, int64_t rh,
                                                 unsigned char* smem, int64_t capacity,
                                                 uint64_t* bar) {
  if (rh <= r0) {
    if (threadIdx.x == 0) tma::arrive_expect_tx(bar, 0);
    return SharedRows{nullptr, nullptr, nullptr, 0, 0};
  }
  const int64_t p0 = r0 & ~int64_t{3};
  const int64_t e0 = __ldg(f.row_ptr + r0), eh = __ldg(f.row_ptr + rh);
  const int64_t a0 = e0 & ~int64_t{3};
  const int64_t np = round4(rh + 1 - p0), ne = round4(eh - a0);
  if (4 * np + 8 * ne > capacity) __trap();
  int* ptr = reinterpret_cast<int*>(smem);
  int* cols = ptr + np;
  float* vals = reinterpret_cast<float*>(cols + ne);
  if (threadIdx.x == 0) {
    tri::proxy_fence();
    tma::arrive_expect_tx(bar, bulk_bytes(r0, rh + 1) + 2 * bulk_bytes(e0, eh));
  }
  stage_run(ptr, f.row_ptr, p0, r0, rh + 1, bar);
  stage_run(cols, f.cols, a0, e0, eh, bar);
  stage_run(vals, f.vals, a0, e0, eh, bar);
  return SharedRows{ptr, cols, vals, p0, a0};
}

// sum_j F[i, j] * src(j) over the rows of `f`: the row's entries in order
// from 0.0f, the loads of kCsrChunk of them in flight before their adds,
// each product and sum rounded (csr_rows.cuh `csr_row`'s bits).
template <class Rows, class Src>
__device__ __forceinline__ float row_sum(const Rows& f, const Src& src, int64_t i) {
  const int begin = f.begin(i), end = f.begin(i + 1);
  float acc = 0.0f;
  for (int j0 = begin; j0 < end; j0 += kCsrChunk) {
    int c[kCsrChunk];
    float v[kCsrChunk], g[kCsrChunk];
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e) c[e] = j0 + e < end ? f.col(j0 + e) : 0;
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e) {
      v[e] = j0 + e < end ? f.val(j0 + e) : 0.0f;
      g[e] = j0 + e < end ? src.at(c[e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kCsrChunk; ++e)
      if (j0 + e < end) acc = mul_add_rn(acc, v[e], g[e]);
  }
  return acc;
}

// One pass over the thread's rows of the span into dst (use_f false: the
// factor skipped); b and d of its first kRegRows rows come from registers.
template <class Src>
__device__ __forceinline__ void sweep_rows(const Span& s, const Src& src, bool use_f,
                                           const float (&breg)[kRegRows],
                                           const float (&dreg)[kRegRows], float* dst) {
  const bool scaled = s.d != nullptr;
  int k = 0;
  for (int64_t i = s.first; i < s.r1; i += s.stride, ++k) {
    const float acc = !use_f ? 0.0f
                      : i < s.rh ? row_sum(s.shared, src, i)
                                 : row_sum(s.global, src, i);
    float b, d;
    if (k < kRegRows) {
#pragma unroll
      for (int q = 0; q < kRegRows; ++q)
        if (q == k) {
          b = breg[q];
          d = dreg[q];
        }
    } else {
      b = load_b(s.b, s.b_written, i);
      d = scaled ? __ldg(s.d + i) : 1.0f;
    }
    dst[i] = finish(b, acc, scaled, d);
  }
}

// The passes of one triangle over the CTA's range: max(k, 1) of them,
// `sync()` before each but the first (and, with `after_barrier`, before the
// first: b is then the lower triangle's result, written in this launch);
// the last writes `last`, the others alternate so that no pass writes what
// it reads.  The factor's held rows are staged before that first barrier,
// so the copies overlap it, into shared memory that the CTA's previous
// triangle no longer reads.  Returns the vector the last pass wrote.
template <class Sync>
__device__ __forceinline__ float* triangle_sweeps(const Triangle& t, const Part& part, int64_t n,
                                                  const float* b, bool after_barrier,
                                                  float* last, float* other,
                                                  unsigned char* smem, int64_t capacity,
                                                  uint64_t* bar, uint32_t parity, Sync& sync) {
  Span s;
  if (part.bounds) {
    s.r0 = __ldg(part.bounds + blockIdx.x);
    s.r1 = __ldg(part.bounds + blockIdx.x + 1);
    s.rh = t.sweeps > 0 ? __ldg(part.held + blockIdx.x) : s.r0;
    s.first = s.r0 + threadIdx.x;
    s.stride = blockDim.x;
  } else {
    s.r0 = s.rh = 0;
    s.r1 = n;
    s.first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    s.stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  }
  s.global = GlobalRows{t.f};
  s.b = b;
  s.b_written = after_barrier;
  s.d = t.d;
  __syncthreads();  // the CTA's reads of the shared memory are over
  s.shared = stage_rows(t.f, s.r0, s.rh, smem, capacity, bar);
  if (after_barrier) sync();
  tma::wait(bar, parity);
  __syncthreads();  // the ragged ends, stored by every thread

  float breg[kRegRows], dreg[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int64_t i = s.first + k * s.stride;
    breg[k] = i < s.r1 ? load_b(b, after_barrier, i) : 0.0f;
    dreg[k] = i < s.r1 && t.d ? __ldg(t.d + i) : 1.0f;
  }
  const int passes = t.sweeps > 0 ? t.sweeps : 1;
  const float* prev = nullptr;
  for (int q = 0; q < passes; ++q) {
    float* dst = ((passes - 1 - q) & 1) == 0 ? last : other;
    if (q > 0) sync();
    if (q == 0)
      sweep_rows(s, Scaled{b, t.d, after_barrier}, t.sweeps > 0, breg, dreg, dst);
    else
      sweep_rows(s, Stored{prev}, true, breg, dreg, dst);
    prev = dst;
  }
  return const_cast<float*>(prev);
}

// The whole apply: the lower triangle's sweeps from r into t0 or t1, a
// barrier, the upper triangle's from that z into out (t1 or t0 beside it).
// `smem` is the CTA's dynamic shared memory of `capacity` bytes, `bar` an
// mbarrier in shared memory (two phases: one per triangle).
template <class Sync>
__device__ __forceinline__ void sweep_apply(const Triangle& lo, const Part& lo_part,
                                            const Triangle& up, const Part& up_part, int64_t n,
                                            const float* r, float* t0, float* t1, float* out,
                                            unsigned char* smem, int64_t capacity, uint64_t* bar,
                                            Sync& sync) {
  if (threadIdx.x == 0) {
    tma::bar_init(bar, 1);
    tma::fence_init();
  }
  __syncthreads();
  const float* z =
      triangle_sweeps(lo, lo_part, n, r, false, t0, t1, smem, capacity, bar, 0, sync);
  float* spare = z == t0 ? t1 : t0;
  triangle_sweeps(up, up_part, n, z, true, out, spare, smem, capacity, bar, 1, sync);
  __syncthreads();  // every wait on the barrier is over
  if (threadIdx.x == 0) tma::bar_inval(bar);
}

}  // namespace tri
}  // namespace ogl
