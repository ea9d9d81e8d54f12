// The whole general (unfused) BiCGStab loop as ONE persistent cooperative
// kernel for Hopper, in eighteen variants: the SpMV of a Dia, a Gdia, an
// Xell, an Ell (also Hybrid, whose tail its row body adds), a Csr (also the
// device Coo) or a Sell matrix, with identity, scalar Jacobi (M^-1 = 1 or
// invd ⊙ ·) or block-Jacobi preconditioning (M^-1 the (nb, bs, bs) block
// inverses, bs from 2 to 32; the variants with kBlockJacobi, below).  This
// header holds the kernel; bicgstab_gen_loop.cu instantiates the identity
// and scalar-Jacobi variants and holds the entry points, bicgstab_bj_loop.cu
// the block-Jacobi variants.
// Each iteration, in the order of the host loop
// (ogl_tpu_torch/solve/bicgstab.py, the reference's ogl_tpu/solve/
// bicgstab.py:52-111; plain twin `bicgstab_gen_loop_plain` in
// ogl_tpu_torch/kernels/fused.py):
//   1. check   the OpenFOAM criterion from the carried ||r||_1 (gated by
//              minIter and frequency); when it says stop the loop leaves
//              before any phase and does not count the pass (the
//              reference's alpha = omega = 0 freeze); it leaves at maxIter +
//              frequency without a check;
//   2. beta    sdiv(rho, rho_old) * sdiv(alpha, omega), sdiv(n, d) = n / d
//              when |d| > small_of(float32)^2, else 0 (the breakdown guard);
//   3. SpMV A  at each source j: p'(j) = r[j] + beta * (p[j] - omega * v[j]),
//              y(j) = M^-1 p'(j); v'[i] = sum_k a_k[i] * y(i + off_k); p' and
//              v' into the other buffers of their pairs, one partial of
//              rhat.v' per block; grid barrier; alpha = sdiv(rho, rhat.v');
//   4. SpMV B  at each source s(j) = r[j] - alpha * v'[j], z(j) = M^-1 s(j);
//              t = A z; s and t written, partials of t.s and t.t; grid
//              barrier; omega = sdiv(t.s, t.t);
//   5. update  y(i), z(i) again from p', s (and invd); x = (x + alpha y) +
//              omega z, r = s - omega t; partials of ||r||_1 and rhat.r (the
//              next check's group); grid barrier; the pairs swap, rho_old =
//              rho.
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// The block-Jacobi variants cannot recompute M^-1 at a neighbour (a row of
// y needs its whole Jacobi block), so they write the preconditioned vectors
// and take two more grid barriers, five per iteration:
//   1. check   as above;
//   2. P       beta as above; p' = r + beta * (p - omega * v) at each row and
//              y = M^-1 p' over whole Jacobi blocks (block_jacobi.cuh, the
//              blocks of a CTA tile, p' staged in shared memory); p' and y
//              written; grid barrier;
//   3. A       v' = A y, the format's SpMV body over a source that reads y;
//              partials of rhat.v'; grid barrier; alpha;
//   4. S       s = r - alpha * v' and z = M^-1 s as in P; s and z written;
//              grid barrier;
//   5. B       t = A z; partials of t.s and t.t; grid barrier; omega;
//   6. update  x = (x + alpha y) + omega z from the written y and z, r = s -
//              omega t; partials as above; grid barrier.
// Each phase gives the bits of the host loop over block_jacobi_plain.
//
// Replaces: the two Dia SpMV launches of an iteration of the reference's
// general BiCGStab (ogl_tpu/kernels/pallas_spmv.py `_kernel`; Gdia:
// ogl_tpu/kernels/gdia.py `_gdia_kernel`; Xell: ogl_tpu/kernels/xell.py
// `_xell_kernel` with `_spill_corr`; Ell, Hybrid, Csr, Coo and Sell: the XLA
// ops of ogl_tpu/kernels/spmv.py `spmv_ell`, `spmv_hybrid`, `spmv_csr`,
// `spmv_coo`, `spmv_sell`) and the elementwise passes,
// reductions and `jax.lax.while_loop` around them.  The SpMV phases are the
// standalone kernels' bodies over source functors: dia_rows.cuh (row
// quads; dia_spmv.cu), gdia_k1.cuh `gdia_quad_sums` (row quads; gdia.cu)
// and xell_band.cuh `band_apply` (bands of 2,048 rows walked by the blocks
// in turn, with the 59,392-byte cp.async ring as dynamic shared memory and
// a block barrier before each band but a block's first; xell.cu) and
// ell_rows.cuh `ell_row` (rows, whole warps per 32-row group; ell_spmv.cu),
// csr_rows.cuh `csr_row` (rows, one lane each; csr_spmv.cu) and sell_rows.cuh
// `sell_slot` (slots, written to their rows, a pad slot nothing;
// sell_spmv.cu); the
// criterion, the block-order sums and the cooperative launch are
// loop.cuh's.  The fused loop (bicgstab_loop.cu) runs another recurrence
// (its K1B folds the direction update differently) and is not reused.
//
// Arithmetic: every elementwise operation of the recurrence is rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn: no fused multiply-add), as the
// host loop's torch ops round, and the SpMV phases accumulate as their row
// bodies do (dia_rows.cuh, gdia_k1.cuh: in the plain versions' order, each
// product and sum rounded on its own), so the phases give the plain twins'
// bits at every row in both formats; only the block sums add in another
// order than torch.sum.  Float32
// BiCGStab on a Poisson system amplifies a one-ulp difference into tens of
// iterations, so the closer the better.
//
// Bound: device-memory bandwidth.  Per iteration and row, Dia: A reads nd
// coefficients, r, p, v and rhat and writes p' and v' ((nd + 6) * 4 bytes);
// B reads nd coefficients, r and v' and writes s and t ((nd + 4) * 4); the
// update reads x, p', s, t and rhat and writes x and r (28): 8 * nd + 68
// bytes, 124 at 7 diagonals; Jacobi reads invd once in each phase (+ 12).
// Block Jacobi: P reads r, p, v and a row of inverses (bs floats) and
// writes p' and y; A the coefficients, y and rhat, writes v'; S reads r, v'
// and the inverses, writes s and z; B the coefficients, z and s, writes t;
// the update reads x, y, z, s, t and rhat and writes x and r: 8 * nd + 8 *
// bs + 92 bytes, 180 at 7 diagonals and bs 4.
// Gdia: np * 5 bytes of values and lanes per SpMV phase instead of nd * 4;
// Xell: K * 7 bytes of slots, and sp_ptr and 12 bytes per spill entry; Ell:
// 8 bytes per entry, and a Hybrid tail's offsets; Csr: 8 bytes per entry and
// the row offsets; Sell: 8 bytes per entry and the row permutation.
// Besides, three grid barriers (five with block Jacobi) and the redundant
// partial sums (each block reads every block's partials).
//
// Design, as cg_loop.cu and bicgstab_loop.cu: the host launches once per
// solve and reads once.  The grid is exactly the co-resident blocks of the
// variant (occupancy x SMs, queried once per plan and variant; fewer when
// the rows run out), each block walking its rows or row quads with a
// grid-stride loop in a fixed order, so grid.sync() is legal and the
// reduction order is fixed for a given grid: every block computes the same
// bits for the sums and scalars and takes the same branch at the check.
// Phase A reads r, p and v at the neighbours and phase B reads r and v', so
// none is written in place: p' and v' go into the other buffer of their
// pair, s and t into buffers of their own, and the sources are recomputed
// at each neighbour rather than read back (other blocks own those rows).  r
// is rewritten only in the update, after the barrier that ends B.  Every
// vector rewritten inside the launch goes through plain loads: only the
// coefficients, lanes, offsets, invd and rhat are __restrict__.  The
// partials buffer holds 5 x blocks floats (rhat.v'; t.s, t.t; ||r||_1,
// rhat.r): a row is read by every block after the barrier that ends its
// phase and rewritten only in the next iteration.  Block Jacobi: the P and S
// phases read r, p, v and v' at their own rows only and write p', y, s and
// z, which the SpMV phases read at the neighbours after the barrier; each
// CTA stages a tile's directions in 512 floats of shared memory.  Gdia: each gather
// recomputes its source from the three or four streams at the gathered row;
// a form that first wrote y (z) to a buffer and gathered it alone, behind one
// more barrier per SpMV phase, ran slower at 1M and 8.4M rows on the H100
// (PERF.md, §6) and was dropped.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_jacobi.cuh"
#include "block_sum.cuh"
#include "csr_rows.cuh"
#include "dia_rows.cuh"
#include "ell_rows.cuh"
#include "gdia_k1.cuh"
#include "loop.cuh"
#include "sell_rows.cuh"
#include "xell_band.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kJacobi = 1;  // variant bits: scalar Jacobi preconditioning,
constexpr int kGdia = 2;    // the Gdia SpMV,
constexpr int kXell = 4;    // the Xell SpMV,
constexpr int kEll = 8;     // the Ell (and Hybrid) SpMV,
constexpr int kCsr = 16;    // the Csr (and device Coo) SpMV,
constexpr int kSell = 32;   // the Sell SpMV (else Dia),
constexpr int kBlockJacobi = 64;  // block-Jacobi preconditioning (not with kJacobi)
constexpr int kPreconditioners = kJacobi | kBlockJacobi;
// Blocks of 512 per SM every variant is compiled for: two, at most 64
// registers, as the fused loop (the row-quad phases keep four rows' sums and
// two source quads in registers; the Ell phases a chunk of slots' columns,
// values and sources: three blocks at 40 registers, with spills, ran level
// within the spread).
constexpr int kBlocksPerSm = 2;
// small_of(float32)^2: the breakdown guard of solve/bicgstab.py _safe_div
constexpr float kTiny = 1e-12f;

__device__ __forceinline__ float sdiv(float num, float den) {
  return fabsf(den) > kTiny ? num / den : 0.0f;
}

__device__ __forceinline__ float4 ld4(const float* a, int64_t u) {
  return reinterpret_cast<const float4*>(a)[u];
}

__device__ __forceinline__ void st4(float* a, int64_t u, const float4& v) {
  reinterpret_cast<float4*>(a)[u] = v;
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// p' = r + beta * (p - omega * v), rounded op by op as the host loop's torch ops
__device__ __forceinline__ float pdir(float r, float p, float v, float beta, float omega) {
  return __fadd_rn(r, __fmul_rn(beta, __fsub_rn(p, __fmul_rn(omega, v))));
}

// s = r - alpha * v'
__device__ __forceinline__ float sdir(float r, float vn, float alpha) {
  return __fsub_rn(r, __fmul_rn(alpha, vn));
}

// M^-1 w: invd[j] * w (Jacobi) or w
template <bool kJ>
__device__ __forceinline__ float prec(const float* __restrict__ invd, int64_t j, float w) {
  return kJ ? __fmul_rn(__ldg(invd + j), w) : w;
}

template <bool kJ>
__device__ __forceinline__ float4 prec4(const float* __restrict__ invd, int64_t u, float4 w) {
  return kJ ? mul4(__ldg(reinterpret_cast<const float4*>(invd) + u), w) : w;
}

// Phase A's source: y(j) = M^-1 p'(j), p' recomputed from r, p and v.  A
// source of the scalar variants also gives the centre M^-1 dir from the
// direction it formed at the row itself, and writes that direction (kWrite).
template <bool kJ>
struct SourceA {
  static constexpr bool kWrite = true;
  const float* r;
  const float* p;
  const float* v;
  const float* invd;
  float beta;
  float omega;
  __device__ __forceinline__ float dir(int64_t j) const {
    return pdir(r[j], p[j], v[j], beta, omega);
  }
  __device__ __forceinline__ float4 dir4(int64_t u) const {
    const float4 rv = ld4(r, u), pv = ld4(p, u), vv = ld4(v, u);
    return make_float4(pdir(rv.x, pv.x, vv.x, beta, omega), pdir(rv.y, pv.y, vv.y, beta, omega),
                       pdir(rv.z, pv.z, vv.z, beta, omega), pdir(rv.w, pv.w, vv.w, beta, omega));
  }
  __device__ __forceinline__ float at(int64_t j) const { return prec<kJ>(invd, j, dir(j)); }
  __device__ __forceinline__ float4 quad(int64_t u) const {
    return prec4<kJ>(invd, u, dir4(u));
  }
  __device__ __forceinline__ float centre(int64_t i, float dc) const {
    return prec<kJ>(invd, i, dc);
  }
  __device__ __forceinline__ float4 centre4(int64_t u, const float4& dc) const {
    return prec4<kJ>(invd, u, dc);
  }
};

// Phase B's source: z(j) = M^-1 s(j), s recomputed from r and v'.
template <bool kJ>
struct SourceB {
  static constexpr bool kWrite = true;
  const float* r;
  const float* vn;
  const float* invd;
  float alpha;
  __device__ __forceinline__ float dir(int64_t j) const { return sdir(r[j], vn[j], alpha); }
  __device__ __forceinline__ float4 dir4(int64_t u) const {
    const float4 rv = ld4(r, u), vv = ld4(vn, u);
    return make_float4(sdir(rv.x, vv.x, alpha), sdir(rv.y, vv.y, alpha),
                       sdir(rv.z, vv.z, alpha), sdir(rv.w, vv.w, alpha));
  }
  __device__ __forceinline__ float at(int64_t j) const { return prec<kJ>(invd, j, dir(j)); }
  __device__ __forceinline__ float4 quad(int64_t u) const {
    return prec4<kJ>(invd, u, dir4(u));
  }
  __device__ __forceinline__ float centre(int64_t i, float dc) const {
    return prec<kJ>(invd, i, dc);
  }
  __device__ __forceinline__ float4 centre4(int64_t u, const float4& dc) const {
    return prec4<kJ>(invd, u, dc);
  }
};

// The block-Jacobi variants' SpMV source: the preconditioned vector w (y in
// phase A, z in B) as the P or S phase wrote it, with the direction d
// written beside it (p', s) for the sums; the SpMV phase writes nothing but
// its product.
struct Stored {
  static constexpr bool kWrite = false;
  const float* w;
  const float* d;
  __device__ __forceinline__ float at(int64_t j) const { return w[j]; }
  __device__ __forceinline__ float4 quad(int64_t u) const { return ld4(w, u); }
  __device__ __forceinline__ float dir(int64_t j) const { return d[j]; }
  __device__ __forceinline__ float4 dir4(int64_t u) const { return ld4(d, u); }
  __device__ __forceinline__ float centre(int64_t i, float) const { return w[i]; }
  __device__ __forceinline__ float4 centre4(int64_t u, const float4&) const {
    return ld4(w, u);
  }
};

// The P and S phases' source: the direction a scalar source forms at a row
// (p' or s), which block_jacobi.cuh preconditions over whole blocks.
template <class Src>
struct DirOf {
  Src src;
  __device__ __forceinline__ float at(int64_t g) const { return src.dir(g); }
};

// The P and S phases' sink: the direction and its preconditioned value.
struct DirSink {
  float* d;
  float* w;
  __device__ __forceinline__ void operator()(int64_t g, float dir, float y) const {
    d[g] = dir;
    w[g] = y;
  }
};

// The matrix of the loop: Dia (coef = data (nd, n), offsets) or Gdia (coef =
// vals, lidx, plane offsets, rows = R).
struct Matrix {
  const float* coef;
  const int8_t* lidx;
  int nd;
  int64_t rows;
};

// The vectors of the loop, all rewritten inside the launch (plain pointers).
struct Vectors {
  float* x;
  float* r;
  float* p;
  float* pn;
  float* v;
  float* vn;
  float* s;
  float* t;
  float* y;  // block Jacobi: M^-1 p' and M^-1 s (else null)
  float* z;
};

struct Scalars {
  const float* rho;
  const float* absr;
  const float* nf;
  float* partials;
  float* record;
};

// An SpMV phase over this thread's rows (Dia, vec = 0), row quads (Dia, vec
// = 1) or row quads of ceil(n / 4) (Gdia; vec = 1: the vectors are 16-byte
// aligned, so a whole quad below n moves as float4): out = A src, with the
// centre dir (p' or s) written to `dirout` where the source forms it
// (Src::kWrite); adds this thread's share of rhat.out (kA) to sums[0], or of
// t.s and t.t to sums[0] and sums[1].
template <bool kGdiaV, bool kA, class Src>
__device__ __forceinline__ void spmv_phase(const float* __restrict__ coef,
                                           const int8_t* __restrict__ lidx, const int* s_off,
                                           int nd, int64_t plane,
                                           const float* __restrict__ rhat, const Src& src,
                                           float* dirout, float* out, int64_t n, int vec,
                                           int64_t first, int64_t step, float (&sums)[2]) {
  if constexpr (!kGdiaV) {
    if (vec) {
      for (int64_t t = first; t < (n >> 2); t += step) {
        const float4 dc = src.dir4(t);
        const float4 q = ogl::dia_quad(coef, s_off, nd, src, src.centre4(t, dc), t, n);
        if constexpr (Src::kWrite) st4(dirout, t, dc);
        st4(out, t, q);
        if (kA) {
          sums[0] += dot4(__ldg(reinterpret_cast<const float4*>(rhat) + t), q);
        } else {
          sums[0] += dot4(q, dc);
          sums[1] += dot4(q, q);
        }
      }
    } else {
      for (int64_t i = first; i < n; i += step) {
        const float dc = src.dir(i);
        const float q = ogl::dia_row(coef, s_off, nd, src, src.centre(i, dc), i, n);
        if constexpr (Src::kWrite) dirout[i] = dc;
        out[i] = q;
        if (kA) {
          sums[0] += __ldg(rhat + i) * q;
        } else {
          sums[0] += q * dc;
          sums[1] += q * q;
        }
      }
    }
  } else {
    const int64_t quads = (n + 3) >> 2;
    for (int64_t t = first; t < quads; t += step) {
      float acc[4];
      ogl::gdia_quad_sums(coef, lidx, s_off, nd, plane, src, t, n, acc);
      const int64_t i0 = t << 2;
      if (vec && i0 + 3 < n) {
        const float4 q = make_float4(acc[0], acc[1], acc[2], acc[3]);
        const float4 dc = src.dir4(t);
        if constexpr (Src::kWrite) st4(dirout, t, dc);
        st4(out, t, q);
        if (kA) {
          sums[0] += dot4(__ldg(reinterpret_cast<const float4*>(rhat) + t), q);
        } else {
          sums[0] += dot4(q, dc);
          sums[1] += dot4(q, q);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t i = i0 + e;
          if (i >= n) break;
          const float dc = src.dir(i);
          if constexpr (Src::kWrite) dirout[i] = dc;
          out[i] = acc[e];
          if (kA) {
            sums[0] += __ldg(rhat + i) * acc[e];
          } else {
            sums[0] += acc[e] * dc;
            sums[1] += acc[e] * acc[e];
          }
        }
      }
    }
  }
}

// An SpMV phase over the Xell bands of this block (the band body of
// xell_band.cuh; every thread of the block calls it): out = A src, with the
// centre dir (p' or s) written to `dirout` (Src::kWrite) for the band's
// rows below n (as float4 when vec: every vector 16-byte aligned, and the quad below n); adds
// this thread's share of rhat.out (kA) to sums[0], or of t.s and t.t to
// sums[0] and sums[1].
template <bool kA, class Src>
__device__ __forceinline__ void xell_phase(const ogl::XellOperands& xm, unsigned char* ring,
                                           const float* __restrict__ rhat, const Src& src,
                                           float* dirout, float* out, int64_t n, int vec,
                                           float (&sums)[2]) {
  const int64_t bands = (n + ogl::kBandRows - 1) / ogl::kBandRows;
  for (int64_t band = blockIdx.x; band < bands; band += gridDim.x) {
    if (band != blockIdx.x) __syncthreads();  // the last band's ring stages are free
    float acc[4];
    ogl::band_apply(xm, src, n, ring, band, acc);
    const int64_t i0 = ogl::band_row0(band);
    if (vec && i0 + 3 < n) {
      const int64_t u = i0 >> 2;
      const float4 q = make_float4(acc[0], acc[1], acc[2], acc[3]);
      const float4 dc = src.dir4(u);
      if constexpr (Src::kWrite) st4(dirout, u, dc);
      st4(out, u, q);
      if (kA) {
        sums[0] += dot4(__ldg(reinterpret_cast<const float4*>(rhat) + u), q);
      } else {
        sums[0] += dot4(q, dc);
        sums[1] += dot4(q, q);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t i = i0 + e;
        if (i >= n) break;
        const float dc = src.dir(i);
        if constexpr (Src::kWrite) dirout[i] = dc;
        out[i] = acc[e];
        if (kA) {
          sums[0] += __ldg(rhat + i) * acc[e];
        } else {
          sums[0] += acc[e] * dc;
          sums[1] += acc[e] * acc[e];
        }
      }
    }
  }
}

// Row i of a gather phase: out[i] = q, the centre dir (p' or s) written to
// `dirout` (Src::kWrite); adds this row's share of rhat.out (kA) to sums[0], or of t.s and
// t.t to sums[0] and sums[1].
template <bool kA, class Src>
__device__ __forceinline__ void gather_row_done(const float* __restrict__ rhat, const Src& src,
                                                float* dirout, float* out, int64_t i, float q,
                                                float (&sums)[2]) {
  const float dc = src.dir(i);
  if constexpr (Src::kWrite) dirout[i] = dc;
  out[i] = q;
  if (kA) {
    sums[0] += __ldg(rhat + i) * q;
  } else {
    sums[0] += q * dc;
    sums[1] += q * q;
  }
}

// An SpMV phase over this thread's rows of an Ell matrix (the row body of
// ell_rows.cuh; rows first, first + step, ..., whole warps) or of a Csr
// matrix (csr_rows.cuh `csr_row`): out = A src, as gather_row_done.
template <bool kA, bool kCsrV, class Src>
__device__ __forceinline__ void row_phase(const ogl::EllOperands& em,
                                          const ogl::CsrOperands& cm,
                                          const float* __restrict__ rhat, const Src& src,
                                          float* dirout, float* out, int64_t n, int64_t first,
                                          int64_t step, float (&sums)[2]) {
  for (int64_t i = first; i < n; i += step) {
    float q;
    if constexpr (kCsrV) {
      q = ogl::csr_row(cm.row_ptr, cm.cols, cm.vals, src, i);
    } else {
      q = ogl::ell_row(em, src, i, n);
    }
    gather_row_done<kA>(rhat, src, dirout, out, i, q, sums);
  }
}

// An SpMV phase over this thread's slots of a Sell matrix (sell_rows.cuh;
// slots first, first + step, ...), each sum finished at its slot's row as
// gather_row_done; a pad slot writes and adds nothing.
template <bool kA, class Src>
__device__ __forceinline__ void sell_phase(const ogl::SellOperands& sm,
                                           const ogl::SellBuckets& sb,
                                           const float* __restrict__ rhat, const Src& src,
                                           float* dirout, float* out, int64_t n, int64_t first,
                                           int64_t step, float (&sums)[2]) {
  for (int64_t g = first; g < sm.slots; g += step) {
    const float q = ogl::sell_slot(sm, sb, src, g);
    const int i = __ldg(sm.slot_rows + g);
    if (i < n) gather_row_done<kA>(rhat, src, dirout, out, i, q, sums);
  }
}

// The update over this thread's rows (quads when vec, the rows past the last
// whole quad one by one): x = (x + alpha y) + omega z, r = s - omega t with
// y = M^-1 p', z = M^-1 s formed here (identity, scalar Jacobi) or read as
// the P and S phases wrote them (kBJ: yb, zb); adds ||r||_1 and rhat.r to
// sums.
template <bool kJ, bool kBJ>
__device__ __forceinline__ void update_phase(const float* __restrict__ invd,
                                             const float* __restrict__ rhat, float alpha,
                                             float omega, float* x, float* r, const float* pn,
                                             const float* s, const float* t, const float* yb,
                                             const float* zb, int64_t n, int vec,
                                             int64_t first, int64_t step, float (&sums)[2]) {
  if (vec) {
    for (int64_t u = first; u < (n >> 2); u += step) {
      const float4 sv = ld4(s, u);
      const float4 y = kBJ ? ld4(yb, u) : prec4<kJ>(invd, u, ld4(pn, u));
      const float4 z = kBJ ? ld4(zb, u) : prec4<kJ>(invd, u, sv);
      const float4 xv = ld4(x, u), tv = ld4(t, u);
      const float4 xn = make_float4(
          __fadd_rn(__fadd_rn(xv.x, __fmul_rn(alpha, y.x)), __fmul_rn(omega, z.x)),
          __fadd_rn(__fadd_rn(xv.y, __fmul_rn(alpha, y.y)), __fmul_rn(omega, z.y)),
          __fadd_rn(__fadd_rn(xv.z, __fmul_rn(alpha, y.z)), __fmul_rn(omega, z.z)),
          __fadd_rn(__fadd_rn(xv.w, __fmul_rn(alpha, y.w)), __fmul_rn(omega, z.w)));
      const float4 rn = make_float4(sdir(sv.x, tv.x, omega), sdir(sv.y, tv.y, omega),
                                    sdir(sv.z, tv.z, omega), sdir(sv.w, tv.w, omega));
      st4(x, u, xn);
      st4(r, u, rn);
      sums[0] += fabsf(rn.x) + fabsf(rn.y) + fabsf(rn.z) + fabsf(rn.w);
      sums[1] += dot4(__ldg(reinterpret_cast<const float4*>(rhat) + u), rn);
    }
  }
  for (int64_t i = (vec ? n & ~int64_t{3} : 0) + first; i < n; i += step) {
    const float sv = s[i];
    const float y = kBJ ? yb[i] : prec<kJ>(invd, i, pn[i]);
    const float z = kBJ ? zb[i] : prec<kJ>(invd, i, sv);
    x[i] = __fadd_rn(__fadd_rn(x[i], __fmul_rn(alpha, y)), __fmul_rn(omega, z));
    const float rn = sdir(sv, t[i], omega);
    r[i] = rn;
    sums[0] += fabsf(rn);
    sums[1] += __ldg(rhat + i) * rn;
  }
}

// The gather matrices of the loop: the one of the variant's format is read.
struct Gather {
  ogl::EllOperands ell;
  ogl::CsrOperands csr;
  ogl::SellOperands sell;
};

// The ints of shared memory a block stages: the Gdia plane offsets, the Sell
// bucket table, the Dia offsets, or none.
__host__ __device__ constexpr int shared_ints(int variant) {
  return (variant & kGdia) ? ogl::kGdiaMaxPlanes
         : (variant & kSell) ? static_cast<int>(sizeof(ogl::SellBuckets) / sizeof(int))
         : (variant & (kXell | kEll | kCsr)) ? 1
                                             : ogl::kMaxDiags;
}

// The SpMV phase of variant V's format over this thread's (or block's) share:
// out = A src, the direction written to `dirout` where the source forms it,
// this thread's share of rhat.out (kA) or of t.s and t.t added to sums.
template <int V, bool kA, class Src>
__device__ __forceinline__ void spmv_of(const Matrix& m, const ogl::XellOperands& xm,
                                        const Gather& gm, const ogl::SellBuckets& sb,
                                        const int* s_off, unsigned char* ring,
                                        const float* __restrict__ rhat, const Src& src,
                                        float* dirout, float* out, int64_t n, int vec,
                                        int64_t first, int64_t step, float (&sums)[2]) {
  if constexpr ((V & kXell) != 0) {
    xell_phase<kA>(xm, ring, rhat, src, dirout, out, n, vec, sums);
  } else if constexpr ((V & (kEll | kCsr)) != 0) {
    row_phase<kA, (V & kCsr) != 0>(gm.ell, gm.csr, rhat, src, dirout, out, n, first, step,
                                   sums);
  } else if constexpr ((V & kSell) != 0) {
    sell_phase<kA>(gm.sell, sb, rhat, src, dirout, out, n, first, step, sums);
  } else {
    spmv_phase<(V & kGdia) != 0, kA>(m.coef, m.lidx, s_off, m.nd, m.rows * ogl::kGdiaLanes, rhat,
                                     src, dirout, out, n, vec, first, step, sums);
  }
}

// m: the Dia or Gdia matrix (nd = 0 for the others); xm: the Xell matrix
// (Xell variants only; the others launch without the ring); gm: the Ell,
// Csr or Sell matrix (their variants only).  invd: the Jacobi inverse
// diagonal, or with kBlockJacobi the transposed block inverses inv_t (nb,
// bs, bs).
template <int V>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
    bicgstab_gen_loop_kernel(Matrix m, ogl::XellOperands xm, Gather gm,
                             const int* __restrict__ offsets, const float* __restrict__ invd,
                             int bs, const float* __restrict__ rhat, Vectors v, Scalars sc,
                             int64_t n, int vec, ogl::Criterion c) {
  constexpr bool jacobi = (V & kJacobi) != 0;
  constexpr bool bj = (V & kBlockJacobi) != 0;
  extern __shared__ __align__(16) unsigned char ring[];
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) int s_off[shared_ints(V)];
  __shared__ float s_stage[bj ? kMaxThreads : 1];  // block Jacobi: the directions of a tile
  ogl::SellBuckets& s_buckets = *reinterpret_cast<ogl::SellBuckets*>(s_off);
  if constexpr ((V & kSell) != 0) {
    ogl::stage_sell(gm.sell, s_buckets);
  } else {
    for (int k = threadIdx.x; k < m.nd; k += blockDim.x) s_off[k] = offsets[k];
  }
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  ogl::bj::Tiling tl{};
  if constexpr (bj) tl = ogl::bj::tiling(n, bs);
  float* rv_parts = sc.partials;               // (blocks,): rhat.v'
  float* ts_parts = sc.partials + blocks;      // (2, blocks): t.s, t.t
  float* rr_parts = sc.partials + 3 * blocks;  // (2, blocks): ||r||_1, rhat.r
  float* p = v.p;
  float* pn = v.pn;
  float* vv = v.v;
  float* vn = v.vn;
  const float nf = *sc.nf;
  float rho = *sc.rho, absr = *sc.absr;
  float rho_old = 1.0f, alpha = 1.0f, omega = 1.0f;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  while (it < hard_cap) {
    // 1. the criterion (stopping.check_from_norm), the same in every block
    if (ogl::stop_at(c, it, absr, nf, rn, init_rn)) break;
    // 2-3. beta, then SpMV A: v' = A M^-1 p', p' = r + beta (p - omega v)
    const float beta = sdiv(rho, rho_old) * sdiv(alpha, omega);
    float sums[2] = {0.0f, 0.0f};
    if constexpr (bj) {
      // P: p' and y = M^-1 p' over whole Jacobi blocks, then A over y
      const SourceA<false> dir{v.r, p, vv, nullptr, beta, omega};
      ogl::bj::apply_tiles(invd, tl, DirOf<SourceA<false>>{dir}, DirSink{pn, v.y}, n, s_stage,
                           blockIdx.x, blocks);
      grid.sync();
      spmv_of<V, true>(m, xm, gm, s_buckets, s_off, ring, rhat, Stored{v.y, v.y}, pn, vn, n,
                       vec, first, step, sums);
    } else {
      spmv_of<V, true>(m, xm, gm, s_buckets, s_off, ring, rhat,
                       SourceA<jacobi>{v.r, p, vv, invd, beta, omega}, pn, vn, n, vec, first,
                       step, sums);
    }
    ogl::block_sum_to(sums[0], rv_parts);
    grid.sync();
    // 4. alpha, then SpMV B: t = A M^-1 s, s = r - alpha v'
    float rv[1];
    ogl::block_totals<1>(rv_parts, blocks, rv);
    alpha = sdiv(rho, rv[0]);
    sums[0] = sums[1] = 0.0f;
    if constexpr (bj) {
      // S: s and z = M^-1 s over whole Jacobi blocks, then B over z
      const SourceB<false> dir{v.r, vn, nullptr, alpha};
      ogl::bj::apply_tiles(invd, tl, DirOf<SourceB<false>>{dir}, DirSink{v.s, v.z}, n, s_stage,
                           blockIdx.x, blocks);
      grid.sync();
      spmv_of<V, false>(m, xm, gm, s_buckets, s_off, ring, rhat, Stored{v.z, v.s}, v.s, v.t, n,
                        vec, first, step, sums);
    } else {
      spmv_of<V, false>(m, xm, gm, s_buckets, s_off, ring, rhat,
                        SourceB<jacobi>{v.r, vn, invd, alpha}, v.s, v.t, n, vec, first, step,
                        sums);
    }
    ogl::block_sums_to<2>(sums, ts_parts);
    grid.sync();
    // 5. omega, then the update: x = (x + alpha y) + omega z, r = s - omega t
    float ts[2];
    ogl::block_totals<2>(ts_parts, blocks, ts);
    omega = sdiv(ts[0], ts[1]);
    sums[0] = sums[1] = 0.0f;
    update_phase<jacobi, bj>(invd, rhat, alpha, omega, v.x, v.r, pn, v.s, v.t, v.y, v.z, n, vec,
                             first, step, sums);
    ogl::block_sums_to<2>(sums, rr_parts);
    grid.sync();
    // the next check's group: ||r||_1 and rho = rhat.r; p' and v' become p and v
    ogl::block_totals<2>(rr_parts, blocks, sums);
    absr = sums[0];
    rho_old = rho;
    rho = sums[1];
    float* tmp = p;
    p = pn;
    pn = tmp;
    tmp = vv;
    vv = vn;
    vn = tmp;
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ogl::write_record(sc.record, it, rn, init_rn, c);
}

}  // namespace

namespace ogl {
// The block-Jacobi variants' kernels (bicgstab_bj_loop.cu, a source of its
// own so that the two halves of the variants compile in parallel), or
// nullptr for a variant without kBlockJacobi.
const void* bicgstab_bj_loop_kernel(int variant);
}  // namespace ogl

