// The AMG-preconditioned solves as ONE persistent cooperative kernel for
// Hopper, with the V-cycle on the device: two outer variants, each built for
// float32 and for bfloat16 smoother coefficients (variant bits kBf16, kIr).
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
//              r' = r - A z on the float32 fine operator (the residual body
//              with b = r), the partials of |r'|
//
// The V-cycle (ogl_tpu_torch/precond/amg.py `cycle_op`, cycle v, from a
// zero guess, s = smooth_iters >= 1 sweeps of damping relax), over a level
// table built once per hierarchy (kernels/amg_loop.py `LevelTable`):
//   down, each smoothing level l (b_0 = r):
//     the pre-smooth: x1 = relax * invd * b needs no A x (amg.py:426-428),
//       so it is folded into the second sweep, which recomputes x1 at its
//       neighbours; sweeps 2 .. s ping-pong between the level's two x
//       buffers;
//     the residual b - A x restricted to b_{l+1}: a group of eight lanes per
//       COARSE row recomputes the residuals of its fine rows (a 2x2x2 grid
//       block, odd axes cut short as grid_restrict's zero padding; or a
//       natural run of `width` rows, the last one partial) and writes their
//       sum, taken by shuffles (with s = 1 it also stores x1 at those rows
//       for the way up);
//   the coarsest level: e = inv . b, one warp per row of the dense inverse
//     (<= 4,096 rows), which adds e at once to the x of its fine rows on the
//     level above: the prolongation x + P e folded into the producer, so the
//     level above starts its sweeps from a buffer;
//   up, each smoothing level from the coarsest: s sweeps; the last one of a
//     level l >= 1 adds its values to its fine rows on level l - 1 (the next
//     prolongation; a group of eight lanes per coarse row, one lane per fine
//     row, so the read-modify-writes of x go in parallel) and stores nothing
//     of its own; the last one of level 0 writes z, and the partials of
//     rho = r.z (CG) or x += z (IR).
// Barriers per iteration: 2 s (levels - 1) + 1 for the cycle, plus 2 (CG:
// K1, K2n; IR: the cycle's last sweep, the residual) -- 15 for CG at s = 2
// with four levels.
//
// Replaces: the host-launched route of the AMG solves: per iteration the
// K1 (ogl_tpu/kernels/fused.py `_k1_kernel`), K2n (`_k2n_kernel`), sweep
// (`_sweep_kernel`) and residual (`_resid_kernel`) launches, the transfers
// and the coarse product as torch ops, and the host loop around them -- the
// reference runs the same as one device program, the `jax.lax.while_loop` of
// ogl_tpu/solve/cg_fused.py:94-123 with the cycle inside its body
// (`precond_framed`, :109-113), and ogl_tpu/solve/ir.py:50-64.  Plain twins:
// `amg_cg_loop_plain` and `amg_ir_loop_plain` in
// ogl_tpu_torch/kernels/amg_loop.py.  The phases are the standalone
// kernels' bodies: cg_k1.cuh, cg_k2n.cuh, amg_smooth.cuh; the criterion,
// the block-order sums and the cooperative launch are loop.cuh's.
//
// Bound: device-memory bandwidth.  Per smoothing-level row and cycle 116
// bytes at s = 2 with bfloat16 coefficients at 7 diagonals (each sweep the
// coefficients, b, invd, x in and out, the folded first one no x in; the
// restricting residual without an x out; the prolongation a
// read-modify-write of x; chip_smoke.py `amg_loop_bytes`); the dense
// inverse once (16.8 MB at 2,048 rows); K1 + K2n 68 bytes per fine row, the
// IR residual 40 and x += z 8.  Besides, the barriers: at a few
// microseconds each they rival the bytes at 1M rows.
//
// Design.  The grid is the co-resident blocks of the variant (occupancy x SMs,
// queried once per variant), each thread walking rows, row quads or coarse rows
// of every phase with a grid-stride loop in a fixed order, so grid.sync() is
// legal and every block sums the partials in block order and takes the same
// branch at the check.  The level table (pointers, sizes, transfer kinds and
// grid dims) and every level's offsets are staged once per block in shared
// memory.  K2n, the IR residual and each level's sweeps walk row quads where the
// launch and the table allow them, else rows; K1 walks rows.  Every vector the
// launch rewrites (x, r, z, p, p', q and each level's x and b buffers) goes
// through plain loads; only the coefficients, invd, the dense inverse and the
// offsets take the read-only path.  Neighbour-reading passes are never in place:
// x ping-pongs between two buffers per level, and z is apart from r.  The
// partials of a phase are read after the barrier that ends it and rewritten
// only after the next one; delta, ||r||_1 and rho have a buffer each.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "amg_smooth.cuh"
#include "block_sum.cuh"
#include "cg_k1.cuh"
#include "cg_k2n.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxLevels = 12;  // kernels/amg_loop.py MAX_LEVELS
constexpr int kFields = 20;     // int64 words per level in the table (amg_loop.py FIELDS)
constexpr int kBf16 = 1;        // variant bits: bfloat16 smoother coefficients,
constexpr int kIr = 2;          // the Richardson loop (else CG)
constexpr int kGrid = 0, kNatural = 1, kCoarse = 2;  // a level's transfer kind

// One level as the table gives it (field order of amg_loop.py LevelTable).
struct Level {
  const void* coef;   // smoothing levels: the (nd, n) smoother coefficients
  const float* invd;  // 1 / diag
  float* xa;          // the two x buffers of a smoothing level
  float* xb;
  float* b;           // this level's right-hand side (unused on level 0: r)
  const float* inv;   // the coarsest level's (n, n) dense inverse
  int64_t n;
  int nd;
  int vec;            // row quads: n % 4 == 0 and every stream aligned
  int kind;           // the transfer to the next level (kCoarse: none)
  int width;          // natural aggregate size
  int64_t nz, ny, nx, nzc, nyc, nxc;  // grid dims of this level and the next
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

// The transfers run kGroup lanes per coarse row (aligned groups of one
// warp): each lane takes the fine rows j = g, g + kGroup, ... of the row,
// so a coarse row's fine rows are read or updated in parallel, not one
// after the other.  The grid-stride step is a multiple of the warp, so a
// warp's lanes stay together through the loop and its shuffles.
constexpr int kGroup = 8;

// The sum of v over this lane's group of kGroup, in every lane of it.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int s = kGroup / 2; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
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

// One sweep of level lv from src into out.
template <typename T, class Src>
__device__ void sweep_store(const Level& lv, const int* off, const Src& src, const float* b,
                            float* out, float relax, int64_t first, int64_t step) {
  const T* coef = static_cast<const T*>(lv.coef);
  if (lv.vec) {
    for (int64_t t = first; t < (lv.n >> 2); t += step) {
      float v[4];
      ogl::sweep_quad(coef, off, lv.nd, src, b, lv.invd, relax, t, lv.n, v);
      reinterpret_cast<float4*>(out)[t] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int64_t i = first; i < lv.n; i += step)
      out[i] = ogl::sweep_row(coef, off, lv.nd, src, b, lv.invd, relax, i, lv.n);
  }
}

// The last sweep of level lv >= 1: its values added to the x of their fine
// rows on level f (buffer fx): the prolongation x + P e of level f.  Each
// lane of a group computes its coarse row's sweep (the same addresses, one
// load for the group) and updates one fine row of it.
template <typename T>
__device__ void sweep_children(const Level& lv, const int* off, const float* src_x,
                               const float* b, const Level& f, float* fx, float relax,
                               int64_t first, int64_t step) {
  const T* coef = static_cast<const T*>(lv.coef);
  const ogl::BufSrc<false> src{src_x};
  const int maxc = max_children(f);
  for (int64_t w = first; w < lv.n * kGroup; w += step) {
    const int64_t k = w / kGroup;
    const float v = ogl::sweep_row(coef, off, lv.nd, src, b, lv.invd, relax, k, lv.n);
    int64_t i;
    for (int j = static_cast<int>(w % kGroup); j < maxc; j += kGroup)
      if (child_of(f, k, j, &i)) fx[i] = fx[i] + v;
  }
}

// The last sweep of level 0 (b = r) into z; CG: returns this thread's share
// of r.z; IR: x += z.
template <typename T, bool kCg>
__device__ float sweep_final(const Level& lv, const int* off, const float* src_x, const float* r,
                             float* z, float* x, float relax, int64_t first, int64_t step) {
  const T* coef = static_cast<const T*>(lv.coef);
  const ogl::BufSrc<false> src{src_x};
  float rz = 0.0f;
  if (lv.vec) {
    for (int64_t t = first; t < (lv.n >> 2); t += step) {
      float v[4];
      ogl::sweep_quad(coef, off, lv.nd, src, r, lv.invd, relax, t, lv.n, v);
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
    for (int64_t i = first; i < lv.n; i += step) {
      const float v = ogl::sweep_row(coef, off, lv.nd, src, r, lv.invd, relax, i, lv.n);
      z[i] = v;
      if constexpr (kCg)
        rz += r[i] * v;
      else
        x[i] = x[i] + v;
    }
  }
  return rz;
}

// b_next[k] = the sum of b - A x over the fine rows of coarse row k, for k
// in [0, nc), a group of lanes per coarse row, each lane the residuals of
// its fine rows, summed over the group by shuffles; with kStore, x (the
// zero-guess x1) is stored at those rows.
template <typename T, class Src, bool kStore>
__device__ void resid_restrict(const Level& lv, const int* off, const Src& src, const float* b,
                               float* b_next, int64_t nc, float* xs, int64_t first,
                               int64_t step) {
  const T* coef = static_cast<const T*>(lv.coef);
  const int maxc = max_children(lv);
  const int lane = threadIdx.x % 32;
  // warp-uniform trips: every lane shuffles, lanes past the end add 0
  for (int64_t base = first - lane; base < nc * kGroup; base += step) {
    const int64_t w = base + lane;
    float acc = 0.0f;
    if (w < nc * kGroup) {
      const int64_t k = w / kGroup;
      int64_t i;
      for (int j = static_cast<int>(w % kGroup); j < maxc; j += kGroup) {
        if (!child_of(lv, k, j, &i)) continue;
        acc += b[i] - ogl::ax_row(coef, off, lv.nd, src, i, lv.n);
        if constexpr (kStore) xs[i] = src.at(i);
      }
    }
    acc = group_sum(acc);
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
    acc = __shfl_sync(0xffffffffu, ogl::warp_sum(acc), 0);
    int64_t i;
    for (int j = lane; j < maxc; j += 32)
      if (child_of(f, row, j, &i)) fx[i] = fx[i] + acc;
  }
}

// One V-cycle on b_0 = r into z (and, IR, x += z).  Every phase but the last
// ends at a grid barrier; the last (level 0's final sweep) returns this
// thread's share of r.z (CG) for the caller's reduction and barrier.
template <typename T, bool kCg>
__device__ float vcycle(const Level* lv, const int (*off)[ogl::kMaxDiags], int nlev, int s,
                        float relax, const float* r, float* z, float* x, cg::grid_group& grid,
                        int64_t first, int64_t step) {
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& L = lv[l];
    const float* b = l == 0 ? r : L.b;
    const ogl::ZeroGuessSrc zg{L.invd, b, relax};
    const Level& next = lv[l + 1];
    if (s == 1) {
      resid_restrict<T, ogl::ZeroGuessSrc, true>(L, off[l], zg, b, next.b, next.n, L.xa, first,
                                                 step);
    } else {
      sweep_store<T>(L, off[l], zg, b, L.xa, relax, first, step);
      grid.sync();
      float* cur = L.xa;
      for (int k = 2; k < s; ++k) {
        float* out = other(L, cur);
        sweep_store<T>(L, off[l], ogl::BufSrc<false>{cur}, b, out, relax, first, step);
        grid.sync();
        cur = out;
      }
      resid_restrict<T, ogl::BufSrc<false>, false>(L, off[l], ogl::BufSrc<false>{cur}, b, next.b,
                                                   next.n, nullptr, first, step);
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
      sweep_store<T>(L, off[l], ogl::BufSrc<false>{cur}, b, out, relax, first, step);
      grid.sync();
      cur = out;
    }
    if (l > 0) {
      sweep_children<T>(L, off[l], cur, b, lv[l - 1], down_cur(lv[l - 1], s), relax, first,
                        step);
      grid.sync();
    } else {
      rz = sweep_final<T, kCg>(L, off[0], cur, r, z, x, relax, first, step);
    }
  }
  return rz;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
    amg_loop_kernel(const int64_t* __restrict__ table, int nlev, const float* __restrict__ data,
                    const int* __restrict__ offsets, int nd, Vectors v, Scalars s, int64_t n,
                    int vec, float relax, int sweeps, ogl::Criterion c) {
  using T = typename std::conditional<(V & kBf16) != 0, __nv_bfloat16, float>::type;
  constexpr bool kCg = (V & kIr) == 0;
  cg::grid_group grid = cg::this_grid();
  __shared__ Level s_lv[kMaxLevels];
  __shared__ int s_off[kMaxLevels][ogl::kMaxDiags];
  __shared__ int s_foff[ogl::kMaxDiags];
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
  }
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_foff[k] = offsets[k];
  for (int l = 0; l < nlev; ++l) {
    const int* lo = reinterpret_cast<const int*>(table[(int64_t)l * kFields + 1]);
    const int lnd = static_cast<int>(table[(int64_t)l * kFields + 2]);
    for (int k = threadIdx.x; k < lnd; k += blockDim.x) s_off[l][k] = lo[k];
  }
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float* delta_parts = s.partials;
  float* absr_parts = s.partials + blocks;
  float* rho_parts = s.partials + 2 * blocks;
  const float nf = *s.nf;
  float absr = *s.absr;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  if (!ogl::stop_at(c, 0, absr, nf, rn, init_rn)) {
    if constexpr (kCg) {
      // the set-up's z = M r0 and rho = r0.z
      float part = vcycle<T, true>(s_lv, s_off, nlev, sweeps, relax, v.r, v.z, nullptr, grid,
                                   first, step);
      ogl::block_sum_to(part, rho_parts);
      grid.sync();
      float tot[1];
      ogl::block_totals<1>(rho_parts, blocks, tot);
      float rho = tot[0], rho_old = 1.0f;
      float* p = v.p;
      float* pn = v.pn;
      for (;;) {
        // K1: p' = z + beta p, q = A p', the partials of p'.q
        const float beta = it == 0 ? 0.0f : rho / rho_old;
        float dot = 0.0f;
        for (int64_t i = first; i < n; i += step) {
          float pc;
          const float qi = ogl::k1_row(data, s_foff, nd, v.z, p, beta, i, n, &pc);
          pn[i] = pc;
          v.q[i] = qi;
          dot += pc * qi;
        }
        ogl::block_sum_to(dot, delta_parts);
        grid.sync();
        // K2n: alpha, x and r in place, the partials of |r|
        ogl::block_totals<1>(delta_parts, blocks, tot);
        const float alpha = rho / tot[0];
        rho_old = rho;
        float ab = 0.0f;
        ogl::k2n_span(alpha, v.x, v.r, pn, v.q, n, vec, first, step, ab);
        ogl::block_sum_to(ab, absr_parts);
        grid.sync();
        ogl::block_totals<1>(absr_parts, blocks, tot);
        absr = tot[0];
        float* t = p;
        p = pn;
        pn = t;
        ++it;
        if (it >= hard_cap || ogl::stop_at(c, it, absr, nf, rn, init_rn)) break;
        // z = M r, rho = r.z
        part = vcycle<T, true>(s_lv, s_off, nlev, sweeps, relax, v.r, v.z, nullptr, grid, first,
                               step);
        ogl::block_sum_to(part, rho_parts);
        grid.sync();
        ogl::block_totals<1>(rho_parts, blocks, tot);
        rho = tot[0];
      }
    } else {
      const ogl::BufSrc<false> zsrc{v.z};
      for (;;) {
        // z = M r and x += z
        vcycle<T, false>(s_lv, s_off, nlev, sweeps, relax, v.r, v.z, v.x, grid, first, step);
        grid.sync();
        // r' = r - A z in place (r is read at its own row only), |r'|
        float ab = 0.0f;
        if (vec) {
          for (int64_t t = first; t < (n >> 2); t += step) {
            float o[4];
            ogl::resid_quad(data, s_foff, nd, zsrc, v.r, t, n, o);
            reinterpret_cast<float4*>(v.r)[t] = make_float4(o[0], o[1], o[2], o[3]);
            ab += fabsf(o[0]) + fabsf(o[1]) + fabsf(o[2]) + fabsf(o[3]);
          }
        } else {
          for (int64_t i = first; i < n; i += step) {
            const float o = v.r[i] - ogl::ax_row(data, s_foff, nd, zsrc, i, n);
            v.r[i] = o;
            ab += fabsf(o);
          }
        }
        ogl::block_sum_to(ab, absr_parts);
        grid.sync();
        float tot[1];
        ogl::block_totals<1>(absr_parts, blocks, tot);
        absr = tot[0];
        ++it;
        if (it >= hard_cap || ogl::stop_at(c, it, absr, nf, rn, init_rn)) break;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ogl::write_record(s.record, it, rn, init_rn, c);
}

const void* loop_kernel(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(amg_loop_kernel<0>);
    case 1: return reinterpret_cast<const void*>(amg_loop_kernel<1>);
    case 2: return reinterpret_cast<const void*>(amg_loop_kernel<2>);
    case 3: return reinterpret_cast<const void*>(amg_loop_kernel<3>);
    default: return nullptr;
  }
}

}  // namespace

// The grid of a loop launch of `variant` (bit 0: bfloat16 smoother
// coefficients, bit 1: the Richardson loop, else CG) with `threads` per
// block on the current device: the blocks that fit on it at once (occupancy
// x SMs).  Fails with cudaErrorNotSupported on a device without cooperative
// launch.
extern "C" int ogl_amg_loop_grid(int variant, int threads, int64_t* blocks) {
  const void* kernel = loop_kernel(variant);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(kernel, threads, blocks);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole solve of `variant` from the set-up's x and r = b - A x (updated in
// place), ||r||_1 (absr) and the norm factor nf (0-d device scalars).
// table: `levels` rows of 20 int64 words (kernels/amg_loop.py LevelTable),
// on the device; data, offsets, nd: the float32 fine operator (Dia); z: a
// scratch vector apart from r; p (all zeros), pn and q: CG scratch vectors
// (null for IR); partials: 3 * blocks floats; record: 4 words.  vec != 0
// takes the float4 branches of K2n and of the IR residual, and lets level 0
// take its row quads where the table allows them (n % 4 == 0, data and
// every vector 16-byte aligned).  A grid larger than the co-resident blocks
// is refused by the launch (cudaErrorCooperativeLaunchTooLarge).  Returns
// the launch's error code (0 = launched).
extern "C" int ogl_amg_loop(int variant, const int64_t* table, int levels, const float* data,
                            const int* offsets, int nd, float* x, float* r, float* z, float* p,
                            float* pn, float* q, const float* absr, const float* nf,
                            float* partials, float* record, int64_t n, int vec, float relax,
                            int sweeps, float tol, float rel_tol, int min_iter, int max_iter,
                            int frequency, int threads, int64_t blocks, void* stream) {
  const void* kernel = loop_kernel(variant);
  const bool cg_loop = (variant & kIr) == 0;
  if (kernel == nullptr || table == nullptr || levels < 2 || levels > kMaxLevels || n < 1 ||
      nd < 0 || nd > ogl::kMaxDiags || sweeps < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 || max_iter < 0 ||
      frequency < 1 || max_iter > INT32_MAX - frequency || x == nullptr || r == nullptr ||
      z == nullptr || (cg_loop && (p == nullptr || pn == nullptr || q == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ogl::misaligned(data, 16) || ogl::misaligned(x, 16) ||
              ogl::misaligned(r, 16) || ogl::misaligned(z, 16) ||
              (cg_loop && (ogl::misaligned(pn, 16) || ogl::misaligned(q, 16) ||
                           ogl::misaligned(p, 16)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Vectors v{x, r, z, p, pn, q};
  Scalars s{absr, nf, partials, record};
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&table, &levels, &data, &offsets, &nd, &v, &s, &n, &vec, &relax, &sweeps, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream);
}
