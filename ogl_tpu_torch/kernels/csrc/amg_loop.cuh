// The AMG-preconditioned solves as ONE persistent cooperative kernel for
// Hopper, with the V-cycle on the device, over hierarchies whose levels are
// Dia, Gdia or Ell operators: two outer loops, each built for float32 and for
// bfloat16 smoother coefficients (variant bits kBf16, kIr) and for the outer
// operator's format (kOuterGdia, kOuterEll, kOuterCsr; none: Dia).  The
// outer format is a template parameter; a level's format is a runtime switch
// inside each phase (the level table's `fmt`), except on the Dia outer,
// which takes hierarchies of Dia levels only (a structured grid coarsens to
// Dia) and whose variants hold no Gdia or Ell code.  Sources, one nvcc each,
// two variants a source: amg_loop.cu (the Dia outer's variants and the entry
// points) and amg_loop_{gdia,ell,csr}_{cg,ir}.cu (Ell also serves Hybrid, Csr
// the device Coo).
//
//   amg_cg_loop (GKOCG + Multigrid), the order of
//   ogl_tpu_torch/solve/cg_fused.py with a rich preconditioner:
//     set-up   the check at iteration 0; z = M r0 (the V-cycle), rho = r.z
//     repeat   beta; K1 p' = z + beta p, q = A p', the partials of p'.q;
//              K2n alpha = rho / delta, x += alpha p', r -= alpha q, the
//              partials of |r|; the check (a converged pass leaves before
//              its V-cycle: the host loop's next check reads the same
//              ||r||_1, and its cycle changes neither x nor r); z = M r,
//              rho = r.z
//   amg_ir_loop (GKOMultigrid), the order of ogl_tpu_torch/solve/ir.py:
//     repeat   the check; z = M r, with x += z in the V-cycle's last sweep;
//              r' = r - A z on the float32 fine operator, the partials of
//              |r'|
// K1 and the IR residual take the outer operator's row body: Dia
// (cg_k1.cuh, amg_smooth.cuh), Gdia (gdia_k1.cuh), Ell and Hybrid
// (ell_rows.cuh), Csr and Coo (csr_rows.cuh `csr_row`) -- the bodies of the
// CG loop's variants <0>, <2>, <8> and <16> (cg_loop.cu).
//
// The V-cycle (ogl_tpu_torch/precond/amg.py `cycle_op`, cycle v, from a
// zero guess, s = smooth_iters >= 1 sweeps of damping relax), over a level
// table built once per hierarchy (kernels/amg_loop.py `LevelTable`):
//   down, each smoothing level l (b_0 = r):
//     the pre-smooth: x1 = relax * invd * b needs no A x (amg.py:426-428),
//       so it is folded into the second sweep, which recomputes x1 at its
//       neighbours; sweeps 2 .. s ping-pong between the level's two x
//       buffers;
//     the residual b - A x restricted to b_{l+1}, per COARSE row: a Dia
//       level, or one whose natural runs do not fit the walks below, takes a
//       group of eight lanes per coarse row, which recomputes the residuals
//       of its fine rows (a 2x2x2 grid block, odd axes cut short as
//       grid_restrict's zero padding; or a natural run of `width` rows, the
//       last one partial) and writes their sum, taken by shuffles; an Ell
//       level with natural runs of a width dividing 32 sums each run over
//       the lanes of its warp group, a Gdia level with runs of a multiple of
//       4 rows over the quads of its warp (with s = 1 the residual also
//       stores x1 at its rows for the way up);
//   the coarsest level: e = inv . b, one warp per row of the dense inverse
//     (<= 4,096 rows), which adds e at once to the x of its fine rows on the
//     level above: the prolongation x + P e folded into the producer, so the
//     level above starts its sweeps from a buffer;
//   up, each smoothing level from the coarsest: s sweeps; the last one of a
//     level l >= 1 adds its values to its fine rows on level l - 1 (the next
//     prolongation: a Dia level a group of eight lanes per coarse row, one
//     lane per fine row; a Gdia or Ell level a warp of 32 coarse rows whose
//     lanes then update the run of fine rows they own, one each, by
//     shuffles) and stores nothing of its own; the last one of level 0
//     writes z, and the partials of rho = r.z (CG) or x += z (IR).
// Barriers per iteration: 2 s (levels - 1) + 1 for the cycle, plus 2 (CG:
// K1, K2n; IR: the cycle's last sweep, the residual) -- 15 for CG at s = 2
// with four levels, whatever the levels' formats.
//
// The level phases by format.  Dia: row quads (amg_smooth.cuh), rows where
// the table's `vec` is off.  Ell: whole 32-row warp groups, each warp
// stopping at its group's longest row; where the table's `stage` gives a
// chunk size (n a multiple of 4, 8 in bfloat16), the staged body of
// amg_stage.cuh brings each group's columns and values into the warp's
// double-buffered stage by bulk copies and issues all of a chunk's gathers
// at once, else the register body of ell_rows.cuh.  Gdia: row quads,
// gdia_k1.cuh's body, its gathers through L1/L2.  The dynamic shared memory
// of a launch is the largest Ell stage (kernels/amg_loop.py
// `LevelTable.smem`); the Ell and Gdia bodies round every product and sum as
// their standalone kernels and twins do.
//
// Replaces: the host-launched route of the AMG solves: per iteration the
// K1 (ogl_tpu/kernels/fused.py `_k1_kernel`, `_k1_gdia_kernel`; the XLA SpMV
// on Ell and Csr), K2n (`_k2n_kernel`), sweep (`_sweep_kernel`) and residual
// (`_resid_kernel`) launches -- on Gdia and Ell levels the standalone level
// smoothers (amg_gdia_smooth.cu over ogl_tpu/kernels/gdia.py `_gdia_kernel`,
// amg_ell_smooth.cu over the reference's XLA `spmv_ell`) --, the transfers
// and the coarse product as torch ops, and the host loop around them -- the
// reference runs the same as one device program, the `jax.lax.while_loop` of
// ogl_tpu/solve/cg_fused.py:94-123 and ogl_tpu/solve/cg.py:93 with the cycle
// inside its body (ogl_tpu/precond/amg.py:471-545), and ogl_tpu/solve/
// ir.py:50-64.  Plain twins: `amg_cg_loop_plain` and `amg_ir_loop_plain` in
// ogl_tpu_torch/kernels/amg_loop.py.  The criterion, the block-order sums and
// the cooperative launch are loop.cuh's.
//
// Bound: device-memory bandwidth.  Per smoothing-level row and cycle at s =
// 2: each sweep reads the level's entries (coefficients, and Gdia lanes or
// Ell columns), b and invd and x in and writes x out, the folded first one no
// x in, the restricting residual no x out, the prolongation a
// read-modify-write of x (chip_smoke.py `amg_loop_bytes`); the dense inverse
// once (16.8 MB at 2,048 rows); K1 + K2n the outer operator's entries and 6
// vectors per fine row, the IR residual the entries and 3 vectors, x += z 8
// bytes.  Besides, the barriers: at a few microseconds each they rival the
// bytes at 1M rows.
//
// Design.  The grid is the co-resident blocks of the variant at the launch's
// shared memory (occupancy x SMs), each thread walking rows, row quads, warp
// groups, tiles or coarse rows of every phase with a grid-stride loop in a
// fixed order, so grid.sync() is legal and every block sums the partials in
// block order and takes the same branch at the check.  The level table
// (pointers, sizes, formats, transfer kinds and grid dims) and every level's
// offsets are staged once per block in shared memory, and the bulk copies'
// mbarriers (two per warp) are set up once per launch.  Every vector the
// launch rewrites (x, r, z, p, p', q and each level's x and b buffers) goes
// through plain loads; only the coefficients, invd, the dense inverse and the
// offsets take the read-only path.
// Neighbour-reading passes are never in place: x ping-pongs between two
// buffers per level, and z is apart from r.  The partials of a phase are
// read after the barrier that ends it and rewritten only after the next one;
// delta, ||r||_1 and rho have a buffer each.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "amg_smooth.cuh"
#include "amg_stage.cuh"
#include "block_sum.cuh"
#include "cg_k1.cuh"
#include "cg_k2n.cuh"
#include "csr_rows.cuh"
#include "ell_rows.cuh"
#include "gdia_k1.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace ogl {
namespace amg {

constexpr int kMaxThreads = 512;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxLevels = 12;  // kernels/amg_loop.py MAX_LEVELS
constexpr int kFields = 24;     // int64 words per level in the table (amg_loop.py FIELDS)
constexpr int kBf16 = 1;        // variant bits: bfloat16 smoother coefficients,
constexpr int kIr = 2;          // the Richardson loop (else CG),
constexpr int kOuterGdia = 4;   // the outer operator's format: Gdia,
constexpr int kOuterEll = 8;    // Ell (and Hybrid),
constexpr int kOuterCsr = 16;   // Csr (and the device Coo); none of them: Dia
constexpr int kOuterBits = kOuterGdia | kOuterEll | kOuterCsr;
constexpr int kGrid = 0, kNatural = 1, kCoarse = 2;  // a level's transfer kind
constexpr int kDia = 0, kGdiaLevel = 1, kEllLevel = 2;  // a level's format
// the most dynamic shared memory a launch may ask for: two blocks of
// kMaxThreads per SM (kernels/amg_loop.py sizes the Ell stages far below it)
constexpr int kStageBudget = 98304;

// One level as the table gives it (field order of amg_loop.py LevelTable).
struct Level {
  const void* coef;    // smoothing levels: Dia (nd, n), Gdia (nd, rows, 128), Ell (nd, n)
  const float* invd;   // 1 / diag
  float* xa;           // the two x buffers of a smoothing level
  float* xb;
  float* b;            // this level's right-hand side (unused on level 0: r)
  const float* inv;    // the coarsest level's (n, n) dense inverse
  const int8_t* lidx;  // Gdia: the source lanes
  const int* cols;     // Ell: the slot-major columns
  const int* ws;       // Ell: the warp slots
  int64_t n;
  int64_t rows;        // Gdia: block rows R
  int nd;              // Dia diagonals, Gdia planes, Ell slots K
  int fmt;             // kDia, kGdiaLevel, kEllLevel
  int stage;           // Ell: slots per staged chunk; 0: not staged
  int vec;             // Dia row quads: n % 4 == 0 and every stream aligned
  int kind;            // the transfer to the next level (kCoarse: none)
  int width;           // natural aggregate size
  int64_t nz, ny, nx, nzc, nyc, nxc;  // grid dims of this level and the next
};

// The outer operator: Dia data (nd, n) and offsets; Gdia vals (nd, rows,
// 128), lanes and plane offsets; Ell vals and cols (K, n), warp_slots (and a
// Hybrid's tail); Csr vals, cols and row_ptr.
struct Outer {
  const float* coef;
  const void* aux;       // Gdia lidx, Ell cols, Csr cols
  const int* offsets;    // Dia offsets, Gdia plane offsets, Ell warp_slots, Csr row_ptr
  int nd;
  int64_t rows;
  const int* tail_ptr;   // Hybrid tail (null: none)
  const int* tail_cols;
  const float* tail_vals;
};

struct Vectors {
  float* x;
  float* r;
  float* z;
  float* p;   // CG only (null for IR)
  float* pn;
  float* q;
};

struct Scalars {
  const float* absr;
  const float* nf;
  float* partials;  // 3 * blocks: delta, ||r||_1, rho
  float* record;
};

// What the staged Ell phases keep across the launch: the dynamic shared
// memory, the mbarriers (two per warp) and the chunks the warp has consumed.
struct Staging {
  unsigned char* smem;
  uint64_t* bars;
  uint32_t ell_t;
};

namespace {

// The fine rows of one coarse row, j = 0, 1, ... < max_children(f): the
// j-th fine row of coarse row k of the transfer of level f, into *i; false
// when there is none (a grid block cut short by an odd axis, the partial
// last natural aggregate).  Grid blocks: j's bits are (dz, dy, dx).  The
// divisions are 32-bit: qualifying levels have fewer than 2^31 rows.
__device__ __forceinline__ int max_children(const Level& f) {
  return f.kind == kNatural ? f.width : 8;
}

__device__ __forceinline__ bool child_of(const Level& f, int64_t k, int j, int64_t* i) {
  if (f.kind == kNatural) {
    *i = k * f.width + j;
    return *i < f.n;
  }
  const uint32_t k32 = static_cast<uint32_t>(k);
  const uint32_t nxc = static_cast<uint32_t>(f.nxc), nyc = static_cast<uint32_t>(f.nyc);
  const uint32_t rest = k32 / nxc;
  const uint32_t cx = k32 - rest * nxc, cy = rest % nyc, cz = rest / nyc;
  const int bz = f.nz > 1 ? 2 : 1, by = f.ny > 1 ? 2 : 1, bx = f.nx > 1 ? 2 : 1;
  const int dx = j & 1, dy = (j >> 1) & 1, dz = j >> 2;
  if (dx >= bx || dy >= by || dz >= bz) return false;
  const int64_t ix = bx * cx + dx, iy = by * cy + dy, iz = bz * cz + dz;
  if (ix >= f.nx || iy >= f.ny || iz >= f.nz) return false;
  *i = (iz * f.ny + iy) * f.nx + ix;
  return true;
}

// The Dia transfers run kGroup lanes per coarse row (aligned groups of one
// warp): each lane takes the fine rows j = g, g + kGroup, ... of the row,
// so a coarse row's fine rows are read or updated in parallel, not one
// after the other.  The grid-stride step is a multiple of the warp, so a
// warp's lanes stay together through the loop and its shuffles.
constexpr int kGroup = 8;

// The sum of v over aligned runs of `len` lanes (a power of two up to 32),
// in every lane of the run.
__device__ __forceinline__ float run_sum(float v, int len) {
  for (int s = len / 2; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The x buffer that holds level l's pre-smoothed x: s = 1 stores x1 in xa;
// s >= 2 runs s - 1 stored sweeps, the first into xa.
__device__ __forceinline__ float* down_cur(const Level& lv, int s) {
  return (s == 1 || ((s - 1) & 1)) ? lv.xa : lv.xb;
}

__device__ __forceinline__ float* other(const Level& lv, const float* cur) {
  return cur == lv.xa ? lv.xb : lv.xa;
}

template <typename T>
__device__ __forceinline__ EllOperandsOf<T> ell_of(const Level& L) {
  return EllOperandsOf<T>{L.cols, static_cast<const T*>(L.coef), L.ws, nullptr, nullptr, nullptr};
}

// (A x)[i] of level L at row i < n, by its format's unstaged row body.
template <bool kMixed, typename T, class Src>
__device__ __forceinline__ float level_ax(const Level& L, const int* off, const Src& src,
                                          int64_t i) {
  const T* coef = static_cast<const T*>(L.coef);
  if constexpr (kMixed) {
    if (L.fmt == kEllLevel) return ell_row(ell_of<T>(L), src, i, L.n);
    if (L.fmt == kGdiaLevel)
      return gdia_row_sum(coef, L.lidx, off, L.nd, L.rows * kGdiaLanes, src, i, L.n);
  }
  return ax_row(coef, off, L.nd, src, i, L.n);
}

// The residual b - ax of a row: rounded on its own on Gdia and Ell levels,
// as their standalone kernels round it.
template <bool kMixed>
__device__ __forceinline__ float level_resid(const Level& L, float b, float ax) {
  if constexpr (kMixed) {
    if (L.fmt != kDia) return __fsub_rn(b, ax);
  }
  return b - ax;
}

// Every row of Ell level L by warp groups, each warp its groups in the
// grid-stride order: f(i, ax) from every lane (i at or past n: padding).
template <typename T, class Src, class F>
__device__ __forceinline__ void ell_walk(const Level& L, Staging& sg, const Src& src,
                                         int64_t first, int64_t step, F&& f) {
  const EllOperandsOf<T> m = ell_of<T>(L);
  if (L.stage > 0) {
    stage::EllStage<T> st = stage::ell_stage_of<T>(sg.smem, sg.bars, L.stage, sg.ell_t);
    stage::ell_groups_staged(m, st, src, L.n, first >> 5, step >> 5, f);
    sg.ell_t = st.t;
    return;
  }
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (int64_t base = first - lane; base < L.n; base += step) {
    const int64_t i = base + lane;
    f(i, i < L.n ? ell_row(m, src, i, L.n) : 0.0f);
  }
}

// Every row quad of Gdia level L by warps: f(t, acc) from every thread (t
// at or past ceil(n / 4): padding).
template <typename T, class Src, class F>
__device__ __forceinline__ void gdia_walk(const Level& L, const int* off, const Src& src,
                                          int64_t first, int64_t step, F&& f) {
  const T* coef = static_cast<const T*>(L.coef);
  const int64_t plane = L.rows * kGdiaLanes;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t quads = (L.n + 3) >> 2;
  for (int64_t base = first - lane; base < quads; base += step) {
    const int64_t t = base + lane;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (t < quads) gdia_quad_sums(coef, L.lidx, off, L.nd, plane, src, t, L.n, acc);
    f(t, acc);
  }
}

// One sweep of level lv from src into out.
template <bool kMixed, typename T, class Src>
__device__ void sweep_store(const Level& L, const int* off, Staging& sg, const Src& src,
                            const float* b, float* out, float relax, int64_t first,
                            int64_t step) {
  if constexpr (kMixed) {
  if (L.fmt == kEllLevel) {
    ell_walk<T>(L, sg, src, first, step, [&](int64_t i, float ax) {
      if (i < L.n) out[i] = smooth_value<true>(src.at(i), b[i], __ldg(L.invd + i), relax, ax);
    });
    return;
  }
  if (L.fmt == kGdiaLevel) {
    gdia_walk<T>(L, off, src, first, step, [&](int64_t t, const float (&acc)[4]) {
      for (int e = 0; e < 4; ++e) {
        const int64_t i = (t << 2) + e;
        if (i < L.n)
          out[i] = smooth_value<true>(src.at(i), b[i], __ldg(L.invd + i), relax, acc[e]);
      }
    });
    return;
  }
  }
  const T* coef = static_cast<const T*>(L.coef);
  if (L.vec) {
    for (int64_t t = first; t < (L.n >> 2); t += step) {
      float v[4];
      sweep_quad(coef, off, L.nd, src, b, L.invd, relax, t, L.n, v);
      reinterpret_cast<float4*>(out)[t] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int64_t i = first; i < L.n; i += step)
      out[i] = sweep_row(coef, off, L.nd, src, b, L.invd, relax, i, L.n);
  }
}

// The last sweep of level L >= 1: its values added to the x of their fine
// rows on level f (buffer fx): the prolongation x + P e of level f.  Dia:
// each lane of a group computes its coarse row's sweep (the same addresses,
// one load for the group) and updates one fine row of it.  Gdia and Ell: a
// warp computes 32 coarse rows, then its lanes take the fine rows of those
// rows one after the other, each value from its row's lane by a shuffle.
template <bool kMixed, typename T>
__device__ void sweep_children(const Level& L, const int* off, Staging& sg, const float* src_x,
                               const float* b, const Level& f, float* fx, float relax,
                               int64_t first, int64_t step) {
  const BufSrc<false> src{src_x};
  const int maxc = max_children(f);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (!kMixed || L.fmt == kDia) {
    const T* coef = static_cast<const T*>(L.coef);
    for (int64_t w = first; w < L.n * kGroup; w += step) {
      const int64_t k = w / kGroup;
      const float v = sweep_row(coef, off, L.nd, src, b, L.invd, relax, k, L.n);
      int64_t i;
      for (int j = static_cast<int>(w % kGroup); j < maxc; j += kGroup)
        if (child_of(f, k, j, &i)) fx[i] = fx[i] + v;
    }
    return;
  }
  if constexpr (kMixed) {
  // the warp's coarse rows base .. base + 31 hold their values in v
  auto give = [&](int64_t base, float v) {
    for (int idx = lane; idx < 32 * maxc; idx += 32) {
      const int kk = idx / maxc;
      const float vk = __shfl_sync(0xffffffffu, v, kk);
      const int64_t k = base + kk;
      int64_t i;
      if (k < L.n && child_of(f, k, idx - kk * maxc, &i)) fx[i] = fx[i] + vk;
    }
  };
  if (L.fmt == kEllLevel) {
    ell_walk<T>(L, sg, src, first, step, [&](int64_t i, float ax) {
      const float v =
          i < L.n ? smooth_value<true>(src.at(i), b[i], __ldg(L.invd + i), relax, ax) : 0.0f;
      give(i - lane, v);
    });
    return;
  }
  const T* coef = static_cast<const T*>(L.coef);
  for (int64_t base = first - lane; base < L.n; base += step) {
    const int64_t i = base + lane;
    float v = 0.0f;
    if (i < L.n)
      v = smooth_value<true>(src.at(i), b[i], __ldg(L.invd + i), relax,
                             gdia_row_sum(coef, L.lidx, off, L.nd, L.rows * kGdiaLanes, src, i,
                                          L.n));
    give(base, v);
  }
  }
}

// The last sweep of level 0 (b = r) into z; CG: returns this thread's share
// of r.z; IR: x += z.
template <bool kMixed, typename T, bool kCg>
__device__ float sweep_final(const Level& L, const int* off, Staging& sg, const float* src_x,
                             const float* r, float* z, float* x, float relax, int64_t first,
                             int64_t step) {
  const BufSrc<false> src{src_x};
  float rz = 0.0f;
  auto put = [&](int64_t i, float v) {
    z[i] = v;
    if constexpr (kCg)
      rz += r[i] * v;
    else
      x[i] = x[i] + v;
  };
  if constexpr (kMixed) {
  if (L.fmt == kEllLevel) {
    ell_walk<T>(L, sg, src, first, step, [&](int64_t i, float ax) {
      if (i < L.n) put(i, smooth_value<true>(src.at(i), r[i], __ldg(L.invd + i), relax, ax));
    });
    return rz;
  }
  if (L.fmt == kGdiaLevel) {
    gdia_walk<T>(L, off, src, first, step, [&](int64_t t, const float (&acc)[4]) {
      for (int e = 0; e < 4; ++e) {
        const int64_t i = (t << 2) + e;
        if (i < L.n) put(i, smooth_value<true>(src.at(i), r[i], __ldg(L.invd + i), relax, acc[e]));
      }
    });
    return rz;
  }
  }
  const T* coef = static_cast<const T*>(L.coef);
  if (L.vec) {
    for (int64_t t = first; t < (L.n >> 2); t += step) {
      float v[4];
      sweep_quad(coef, off, L.nd, src, r, L.invd, relax, t, L.n, v);
      reinterpret_cast<float4*>(z)[t] = make_float4(v[0], v[1], v[2], v[3]);
      if constexpr (kCg) {
        const float4 rv = reinterpret_cast<const float4*>(r)[t];
        rz += rv.x * v[0] + rv.y * v[1] + rv.z * v[2] + rv.w * v[3];
      } else {
        float4 xv = reinterpret_cast<float4*>(x)[t];
        xv.x = xv.x + v[0];
        xv.y = xv.y + v[1];
        xv.z = xv.z + v[2];
        xv.w = xv.w + v[3];
        reinterpret_cast<float4*>(x)[t] = xv;
      }
    }
  } else {
    for (int64_t i = first; i < L.n; i += step)
      put(i, sweep_row(coef, off, L.nd, src, r, L.invd, relax, i, L.n));
  }
  return rz;
}

// b_next[k] = the sum of b - A x over the fine rows of coarse row k, for k
// in [0, nc); with kStore, x (the zero-guess x1) is stored at those rows.
// An Ell level of natural runs dividing 32 rows, or a Gdia level of runs of
// 4 to 128 rows whose quads divide 32, sums each run over its lanes as the
// warp walks its rows; every other level takes a group of kGroup lanes per
// coarse row, each lane the residuals of its fine rows, summed over the
// group by shuffles.
template <bool kMixed, typename T, class Src, bool kStore>
__device__ void resid_restrict(const Level& L, const int* off, Staging& sg, const Src& src,
                               const float* b, float* b_next, int64_t nc, float* xs,
                               int64_t first, int64_t step) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int width = L.width;
  if constexpr (kMixed) {
  if (L.kind == kNatural && L.fmt == kEllLevel && width <= 32 && 32 % width == 0) {
    ell_walk<T>(L, sg, src, first, step, [&](int64_t i, float ax) {
      float res = 0.0f;
      if (i < L.n) {
        res = __fsub_rn(b[i], ax);
        if constexpr (kStore) xs[i] = src.at(i);
      }
      res = run_sum(res, width);
      if (i < L.n && lane % width == 0) b_next[i / width] = res;
    });
    return;
  }
  const int per = width / 4;  // quads per run
  if (L.kind == kNatural && L.fmt == kGdiaLevel && width % 4 == 0 && width <= 128 &&
      32 % per == 0) {
    gdia_walk<T>(L, off, src, first, step, [&](int64_t t, const float (&acc)[4]) {
      float res = 0.0f;
      for (int e = 0; e < 4; ++e) {
        const int64_t i = (t << 2) + e;
        if (i < L.n) {
          res += __fsub_rn(b[i], acc[e]);
          if constexpr (kStore) xs[i] = src.at(i);
        }
      }
      res = run_sum(res, per);
      if ((t << 2) < L.n && lane % per == 0) b_next[(t << 2) / width] = res;
    });
    return;
  }
  }
  const int maxc = max_children(L);
  // warp-uniform trips: every lane shuffles, lanes past the end add 0
  for (int64_t base = first - lane; base < nc * kGroup; base += step) {
    const int64_t w = base + lane;
    float acc = 0.0f;
    if (w < nc * kGroup) {
      const int64_t k = w / kGroup;
      int64_t i;
      for (int j = static_cast<int>(w % kGroup); j < maxc; j += kGroup) {
        if (!child_of(L, k, j, &i)) continue;
        acc += level_resid<kMixed>(L, b[i], level_ax<kMixed, T>(L, off, src, i));
        if constexpr (kStore) xs[i] = src.at(i);
      }
    }
    acc = run_sum(acc, kGroup);
    if (w < nc * kGroup && w % kGroup == 0) b_next[w / kGroup] = acc;
  }
}

// The coarsest level c: e = inv . b_c, one warp per row (float4 loads when
// the level allows them), e added at once to the x of its fine rows on
// level f (buffer fx), one lane per fine row.
__device__ void coarse_solve(const Level& c, const Level& f, float* fx, int64_t first,
                             int64_t step) {
  const int lane = threadIdx.x % 32;
  const int64_t nc = c.n;
  const int maxc = max_children(f);
  for (int64_t row = first / 32; row < nc; row += step / 32) {
    const float* __restrict__ inv_row = c.inv + row * nc;
    float acc = 0.0f;
    if (c.vec) {
      const float4* inv4 = reinterpret_cast<const float4*>(inv_row);
      const float4* b4 = reinterpret_cast<const float4*>(c.b);
      for (int64_t j = lane; j < (nc >> 2); j += 32) {
        const float4 a = __ldg(inv4 + j), v = b4[j];
        acc += a.x * v.x + a.y * v.y + a.z * v.z + a.w * v.w;
      }
    } else {
      for (int64_t j = lane; j < nc; j += 32) acc += __ldg(inv_row + j) * c.b[j];
    }
    acc = __shfl_sync(0xffffffffu, warp_sum(acc), 0);
    int64_t i;
    for (int j = lane; j < maxc; j += 32)
      if (child_of(f, row, j, &i)) fx[i] = fx[i] + acc;
  }
}

// One V-cycle on b_0 = r into z (and, IR, x += z).  Every phase but the last
// ends at a grid barrier; the last (level 0's final sweep) returns this
// thread's share of r.z (CG) for the caller's reduction and barrier.  In the
// mixed variants the cycle is one out-of-line copy (vcycle_mixed; the CG loop
// runs it in two places), which keeps their code and build time down; the
// Dia outer's variants inline it, as the phases are inlined in both.
template <bool kMixed, typename T, bool kCg>
__device__ __forceinline__ float vcycle_body(const Level* lv, const int (*off)[kMaxDiags],
                                             Staging& sg, int nlev, int s, float relax,
                                             const float* r, float* z, float* x,
                                             cg::grid_group& grid, int64_t first, int64_t step) {
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& L = lv[l];
    const float* b = l == 0 ? r : L.b;
    const ZeroGuessSrc zg{L.invd, b, relax};
    const Level& next = lv[l + 1];
    if (s == 1) {
      resid_restrict<kMixed, T, ZeroGuessSrc, true>(L, off[l], sg, zg, b, next.b, next.n, L.xa,
                                            first, step);
    } else {
      sweep_store<kMixed, T>(L, off[l], sg, zg, b, L.xa, relax, first, step);
      grid.sync();
      float* cur = L.xa;
      for (int k = 2; k < s; ++k) {
        float* out = other(L, cur);
        sweep_store<kMixed, T>(L, off[l], sg, BufSrc<false>{cur}, b, out, relax, first, step);
        grid.sync();
        cur = out;
      }
      resid_restrict<kMixed, T, BufSrc<false>, false>(L, off[l], sg, BufSrc<false>{cur}, b,
                                              next.b, next.n, nullptr, first, step);
    }
    grid.sync();
  }
  coarse_solve(lv[nlev - 1], lv[nlev - 2], down_cur(lv[nlev - 2], s), first, step);
  grid.sync();
  float rz = 0.0f;
  for (int l = nlev - 2; l >= 0; --l) {
    const Level& L = lv[l];
    const float* b = l == 0 ? r : L.b;
    float* cur = down_cur(L, s);
    for (int k = 0; k < s - 1; ++k) {
      float* out = other(L, cur);
      sweep_store<kMixed, T>(L, off[l], sg, BufSrc<false>{cur}, b, out, relax, first, step);
      grid.sync();
      cur = out;
    }
    if (l > 0) {
      sweep_children<kMixed, T>(L, off[l], sg, cur, b, lv[l - 1], down_cur(lv[l - 1], s), relax,
                        first, step);
      grid.sync();
    } else {
      rz = sweep_final<kMixed, T, kCg>(L, off[0], sg, cur, r, z, x, relax, first, step);
    }
  }
  return rz;
}

// The mixed variants' cycle, out of line: one copy of its phases.
template <typename T, bool kCg>
__device__ __noinline__ float vcycle_mixed(const Level* lv, const int (*off)[kMaxDiags],
                                           Staging& sg, int nlev, int s, float relax,
                                           const float* r, float* z, float* x,
                                           cg::grid_group& grid, int64_t first, int64_t step) {
  return vcycle_body<true, T, kCg>(lv, off, sg, nlev, s, relax, r, z, x, grid, first, step);
}

template <bool kMixed, typename T, bool kCg>
__device__ __forceinline__ float vcycle(const Level* lv, const int (*off)[kMaxDiags],
                                        Staging& sg, int nlev, int s, float relax, const float* r,
                                        float* z, float* x, cg::grid_group& grid, int64_t first,
                                        int64_t step) {
  if constexpr (kMixed) {
    return vcycle_mixed<T, kCg>(lv, off, sg, nlev, s, relax, r, z, x, grid, first, step);
  } else {
    return vcycle_body<false, T, kCg>(lv, off, sg, nlev, s, relax, r, z, x, grid, first, step);
  }
}

// K1 on the outer operator: p' = z + beta p, q = A p', this thread's share
// of p'.q.
template <int O>
__device__ __forceinline__ float k1_phase(const Outer& o, const int* s_foff, const float* z,
                                          const float* p, float beta, float* pn, float* q,
                                          int64_t n, int vec, int64_t first, int64_t step) {
  if constexpr (O == kOuterGdia) {
    return gdia_span<true>(o.coef, static_cast<const int8_t*>(o.aux), s_foff, o.nd,
                           o.rows * kGdiaLanes, z, p, beta, pn, q, n, vec, first, step);
  } else {
    float dot = 0.0f;
    const K1Source<false> src{z, p, beta};
    for (int64_t i = first; i < n; i += step) {
      float pc, qi;
      if constexpr (O == kOuterEll) {
        const EllOperands m{static_cast<const int*>(o.aux), o.coef, o.offsets, o.tail_ptr,
                            o.tail_cols, o.tail_vals};
        qi = ell_row(m, src, i, n);
        pc = src.at(i);
      } else if constexpr (O == kOuterCsr) {
        qi = csr_row(o.offsets, static_cast<const int*>(o.aux), o.coef, src, i);
        pc = src.at(i);
      } else {
        qi = k1_row(o.coef, s_foff, o.nd, z, p, beta, i, n, &pc);
      }
      pn[i] = pc;
      q[i] = qi;
      dot += pc * qi;
    }
    return dot;
  }
}

// The IR residual r' = r - A z in place on the outer operator (r is read at
// its own row only); returns this thread's share of |r'|.
template <int O>
__device__ __forceinline__ float ir_resid_phase(const Outer& o, const int* s_foff,
                                                const float* z, float* r, int64_t n, int vec,
                                                int64_t first, int64_t step) {
  const BufSrc<false> zsrc{z};
  float ab = 0.0f;
  if constexpr (O == kOuterGdia) {
    const int64_t quads = (n + 3) >> 2;
    for (int64_t t = first; t < quads; t += step) {
      float acc[4];
      gdia_quad_sums(o.coef, static_cast<const int8_t*>(o.aux), s_foff, o.nd,
                     o.rows * kGdiaLanes, zsrc, t, n, acc);
      for (int e = 0; e < 4; ++e) {
        const int64_t i = (t << 2) + e;
        if (i < n) {
          const float v = r[i] - acc[e];
          r[i] = v;
          ab += fabsf(v);
        }
      }
    }
  } else if constexpr (O == kOuterEll || O == kOuterCsr) {
    for (int64_t i = first; i < n; i += step) {
      float ax;
      if constexpr (O == kOuterEll) {
        const EllOperands m{static_cast<const int*>(o.aux), o.coef, o.offsets, o.tail_ptr,
                            o.tail_cols, o.tail_vals};
        ax = ell_row(m, zsrc, i, n);
      } else {
        ax = csr_row(o.offsets, static_cast<const int*>(o.aux), o.coef, zsrc, i);
      }
      const float v = r[i] - ax;
      r[i] = v;
      ab += fabsf(v);
    }
  } else if (vec) {
    for (int64_t t = first; t < (n >> 2); t += step) {
      float v[4];
      resid_quad(o.coef, s_foff, o.nd, zsrc, r, t, n, v);
      reinterpret_cast<float4*>(r)[t] = make_float4(v[0], v[1], v[2], v[3]);
      ab += fabsf(v[0]) + fabsf(v[1]) + fabsf(v[2]) + fabsf(v[3]);
    }
  } else {
    for (int64_t i = first; i < n; i += step) {
      const float v = r[i] - ax_row(o.coef, s_foff, o.nd, zsrc, i, n);
      r[i] = v;
      ab += fabsf(v);
    }
  }
  return ab;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
    amg_loop_kernel(const int64_t* __restrict__ table, int nlev, Outer o, Vectors v, Scalars s,
                    int64_t n, int vec, float relax, int sweeps, Criterion c) {
  using T = typename std::conditional<(V & kBf16) != 0, __nv_bfloat16, float>::type;
  constexpr bool kCg = (V & kIr) == 0;
  constexpr int O = V & kOuterBits;
  // the Dia outer's hierarchies are all Dia: no Gdia or Ell code, the cycle
  // inlined, as the Dia-only loop was before the other formats joined; the
  // mixed variants keep the cycle out of line, one copy
  constexpr bool kMixed = O != 0;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char s_dyn[];
  __shared__ Level s_lv[kMaxLevels];
  __shared__ int s_off[kMaxLevels][kMaxDiags];
  __shared__ int s_foff[O == kOuterGdia ? kGdiaMaxPlanes : kMaxDiags];
  __shared__ __align__(8) uint64_t s_bars[2 * kWarps];
  if (threadIdx.x < nlev) {
    const int64_t* t = table + (int64_t)threadIdx.x * kFields;
    Level& L = s_lv[threadIdx.x];
    L.coef = reinterpret_cast<const void*>(t[0]);
    L.nd = static_cast<int>(t[2]);
    L.n = t[3];
    L.invd = reinterpret_cast<const float*>(t[4]);
    L.xa = reinterpret_cast<float*>(t[5]);
    L.xb = reinterpret_cast<float*>(t[6]);
    L.b = reinterpret_cast<float*>(t[7]);
    L.inv = reinterpret_cast<const float*>(t[8]);
    L.kind = static_cast<int>(t[9]);
    L.width = static_cast<int>(t[10]);
    L.nz = t[11];
    L.ny = t[12];
    L.nx = t[13];
    L.nzc = t[14];
    L.nyc = t[15];
    L.nxc = t[16];
    // level 0's quads also read r, z (and x): the launch's own vec says
    // whether they allow them
    L.vec = static_cast<int>(t[17]) && (threadIdx.x != 0 || vec);
    L.fmt = static_cast<int>(t[18]);
    L.lidx = reinterpret_cast<const int8_t*>(t[19]);
    L.cols = reinterpret_cast<const int*>(t[19]);
    L.ws = reinterpret_cast<const int*>(t[20]);
    L.rows = t[21];
    L.stage = static_cast<int>(t[22]);
  }
  if constexpr (O == 0 || O == kOuterGdia)
    for (int k = threadIdx.x; k < o.nd; k += blockDim.x) s_foff[k] = o.offsets[k];
  for (int l = 0; l < nlev; ++l) {
    const int64_t* t = table + (int64_t)l * kFields;
    const int fmt = static_cast<int>(t[18]);
    const int lnd = static_cast<int>(t[2]);
    if (fmt != kEllLevel && t[1] != 0) {
      const int* lo = reinterpret_cast<const int*>(t[1]);
      for (int k = threadIdx.x; k < lnd; k += blockDim.x) s_off[l][k] = lo[k];
    }
  }
  if (kMixed && threadIdx.x % 32 == 0) {
    tma::bar_init(s_bars + 2 * (threadIdx.x / 32), 1);
    tma::bar_init(s_bars + 2 * (threadIdx.x / 32) + 1, 1);
    tma::fence_init();
  }
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Staging sg{s_dyn, s_bars, 0u};
  float* delta_parts = s.partials;
  float* absr_parts = s.partials + blocks;
  float* rho_parts = s.partials + 2 * blocks;
  const float nf = *s.nf;
  float absr = *s.absr;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  if (!stop_at(c, 0, absr, nf, rn, init_rn)) {
    if constexpr (kCg) {
      // the set-up's z = M r0 and rho = r0.z
      float part = vcycle<kMixed, T, true>(s_lv, s_off, sg, nlev, sweeps, relax, v.r, v.z,
                                           nullptr, grid, first, step);
      block_sum_to(part, rho_parts);
      grid.sync();
      float tot[1];
      block_totals<1>(rho_parts, blocks, tot);
      float rho = tot[0], rho_old = 1.0f;
      float* p = v.p;
      float* pn = v.pn;
      for (;;) {
        // K1: p' = z + beta p, q = A p', the partials of p'.q
        const float beta = it == 0 ? 0.0f : rho / rho_old;
        const float dot = k1_phase<O>(o, s_foff, v.z, p, beta, pn, v.q, n, vec, first, step);
        block_sum_to(dot, delta_parts);
        grid.sync();
        // K2n: alpha, x and r in place, the partials of |r|
        block_totals<1>(delta_parts, blocks, tot);
        const float alpha = rho / tot[0];
        rho_old = rho;
        float ab = 0.0f;
        k2n_span(alpha, v.x, v.r, pn, v.q, n, vec, first, step, ab);
        block_sum_to(ab, absr_parts);
        grid.sync();
        block_totals<1>(absr_parts, blocks, tot);
        absr = tot[0];
        float* t = p;
        p = pn;
        pn = t;
        ++it;
        if (it >= hard_cap || stop_at(c, it, absr, nf, rn, init_rn)) break;
        // z = M r, rho = r.z
        part = vcycle<kMixed, T, true>(s_lv, s_off, sg, nlev, sweeps, relax, v.r, v.z, nullptr,
                                       grid, first, step);
        block_sum_to(part, rho_parts);
        grid.sync();
        block_totals<1>(rho_parts, blocks, tot);
        rho = tot[0];
      }
    } else {
      for (;;) {
        // z = M r and x += z
        vcycle<kMixed, T, false>(s_lv, s_off, sg, nlev, sweeps, relax, v.r, v.z, v.x, grid, first,
                                 step);
        grid.sync();
        // r' = r - A z in place, |r'|
        const float ab = ir_resid_phase<O>(o, s_foff, v.z, v.r, n, vec, first, step);
        block_sum_to(ab, absr_parts);
        grid.sync();
        float tot[1];
        block_totals<1>(absr_parts, blocks, tot);
        absr = tot[0];
        ++it;
        if (it >= hard_cap || stop_at(c, it, absr, nf, rn, init_rn)) break;
      }
    }
  }
  __syncthreads();  // every wait on the barriers is over
  if (kMixed && threadIdx.x % 32 == 0) {
    tma::bar_inval(s_bars + 2 * (threadIdx.x / 32));
    tma::bar_inval(s_bars + 2 * (threadIdx.x / 32) + 1);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) write_record(s.record, it, rn, init_rn, c);
}

// The two variants (float32, bfloat16 coefficients) of the other bits B.
template <int B>
const void* pick(int variant) {
  return (variant & kBf16) != 0 ? reinterpret_cast<const void*>(amg_loop_kernel<B | kBf16>)
                                : reinterpret_cast<const void*>(amg_loop_kernel<B>);
}

}  // namespace

// The kernels, two variants a source, so that nvcc builds them in parallel:
// the Dia outer's in amg_loop.cu beside the entry points, which choose by
// the variant's bits; each mixed outer format and loop in amg_loop_<outer>_<
// cg|ir>.cu.
const void* loop_kernel_dia_cg(int variant);
const void* loop_kernel_dia_ir(int variant);
const void* loop_kernel_gdia_cg(int variant);
const void* loop_kernel_gdia_ir(int variant);
const void* loop_kernel_ell_cg(int variant);
const void* loop_kernel_ell_ir(int variant);
const void* loop_kernel_csr_cg(int variant);
const void* loop_kernel_csr_ir(int variant);

}  // namespace amg
}  // namespace ogl

// Defines ogl::amg::NAME, the float32 and bfloat16 variants of bits B.
#define OGL_AMG_LOOP_KERNELS(NAME, B)                                          \
  namespace ogl {                                                              \
  namespace amg {                                                              \
  const void* NAME(int variant) { return pick<B>(variant); }                   \
  }                                                                            \
  }
