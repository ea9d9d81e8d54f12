// The whole merged CG loop as ONE persistent cooperative kernel for Hopper,
// in ten variants: the apply of a Dia, a Gdia, an Ell (Ell also serves
// Hybrid: its tail is added in the same row body), a Csr (also the device
// Coo) or a Sell matrix, with identity or scalar Jacobi preconditioning.
// Each iteration, in the order of ogl_tpu_torch/solve/cg_fused.py:
//   1. check   the OpenFOAM criterion from the summed ||r||_1 (gated by
//              minIter and frequency; stop at maxIter, below tolerance or
//              below relTol * the initial residual; leave at maxIter +
//              frequency without a check);
//   2. beta    0 at iteration 0, else rho / rho_old;
//   3. K1      p' = z + beta * p, q = A p', one partial of p'.q per block
//              (z is r with identity: no z stream); on Ell, Csr and Sell
//              the host route (solve/cg.py) has no K1 kernel: this phase
//              is its z, p and q = A p in the merged order;
//   4. grid barrier; every block sums the partials into delta;
//   5. K2      alpha = rho / delta, x += alpha * p', r -= alpha * q, and
//              with Jacobi z = invd * r'; the partials of r'.z' (r'.r'
//              with identity: K2i) and |r'|;
//   6. grid barrier; the sums give rho' and ||r||_1;
//   7. p and p' swap buffers (neighbours read p during the next K1).
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// Replaces: the K1 (ogl_tpu/kernels/fused.py `_k1_kernel`, Dia, and
// `_k1_gdia_kernel`, Gdia), K2 (`_k2_kernel`, Jacobi) and K2i (`_k2i_kernel`,
// identity) launches of the reference's merged CG and the
// `jax.lax.while_loop` around them with the criterion as loop state
// (ogl_tpu/solve/cg_fused.py:82-123, ogl_tpu/solve/stopping.py); on Ell and
// Hybrid, Csr, Coo and Sell, the reference's general CG loop
// (ogl_tpu/solve/cg.py) over its XLA SpMV.  Plain twin: `cg_loop_plain` in
// ogl_tpu_torch/kernels/fused.py (on Ell, Csr and Sell over the plan's K1,
// kernels/ell.py, kernels/gather_loop.py).  The phases are the standalone
// kernels' bodies: cg_k1.cuh, gdia_k1.cuh, ell_rows.cuh, csr_rows.cuh
// `csr_row`, sell_rows.cuh (over the source p'(j) = z[j] + beta * p[j],
// rounded as its twin rounds it, so q is the twin's bits at every row; a
// Sell K1 walks slots and writes p' and q at each slot's row, a pad slot
// nothing), cg_k2.cuh, cg_k2i.cuh;
// the criterion, the block-order sums and the cooperative launch are
// loop.cuh's, shared with the pipelined loop (cg_pipe_loop.cu).
//
// Bound: device-memory bandwidth.  Per iteration and row, Dia: K1 reads nd
// coefficients, z (r) and p and writes p' and q; K2i reads x, r, p' and q
// and writes x and r: (nd + 4) * 4 + 24 bytes; Jacobi adds invd in and z
// out (+ 8).  Gdia: np * 5 + 16 bytes for K1 instead; Ell: 8 bytes per entry
// and z (r), p, p' and q, 16 bytes per row (ideal; the warps read the slots
// below their group's longest row), plus a Hybrid tail's offsets; Csr the
// same plus its row offsets; Sell plus its row permutation (the slots read
// the lanes below their slice's longest row).  Besides, two grid barriers
// and the redundant partial sums (each block reads every block's partials).
//
// Design.  A loop on the host pays a host launch per kernel and a
// device-to-host read per check; here the host launches once and reads
// once.  The grid is exactly the co-resident blocks of the variant
// (occupancy x SMs, queried once per plan and variant; fewer when the rows
// run out), each block walking its rows (Dia, K2) or row quads (Gdia K1)
// with a grid-stride loop in a fixed order (whole warps: an Ell warp holds one
// 32-row group and stops at its longest row), so cooperative groups'
// grid.sync() is legal and the reduction order is fixed for a given grid:
// every block sums all partials in block order and so computes the same
// bits for delta, rho and ||r||_1, and all blocks take the same branch at
// the check.  x, r, z, p, p' and q are written inside the launch and read
// by other blocks after a barrier, so they go through plain loads: only the
// coefficients, lanes, offsets and invd are __restrict__ (the read-only,
// non-coherent path could return values from before a barrier).  tol and
// relTol arrive as float, as the host loop compares float32 tensors with
// them, and every division is IEEE (no fast math).  The partials of one
// phase are read after the barrier that ends it and rewritten only after
// the next one, so one buffer per sum suffices.  Each variant has its own
// register budget (min_blocks_per_sm): the Gdia K1 phase keeps four rows'
// sums and lanes in registers, the Ell one a chunk of slots' columns, values
// and sources.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k1.cuh"
#include "cg_k2.cuh"
#include "cg_k2i.cuh"
#include "csr_rows.cuh"
#include "ell_rows.cuh"
#include "gdia_k1.cuh"
#include "loop.cuh"
#include "sell_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kJacobi = 1;  // variant bits: scalar Jacobi preconditioning,
constexpr int kGdia = 2;    // the Gdia apply,
constexpr int kEll = 8;     // the Ell (and Hybrid) apply,
constexpr int kCsr = 16;    // the Csr (and device Coo) apply,
constexpr int kSell = 32;   // the Sell apply (else Dia)

// Blocks of 512 per SM each variant is compiled for.  Dia: at most 40
// registers, three blocks (identity spills about 100 bytes): two blocks at
// the 62 registers it takes unbounded, or four at 32, streamed slower at
// 8.4M rows.  Gdia: two blocks at 64 registers; three or four, at 40 or 32
// with spills, ran slower.  Ell: two blocks (56 registers); three, at 40
// with 4-68 bytes of spills, ran level within the spread on the kNN mesh.
// Csr and Sell: two blocks, as Ell, whose phase they mirror.
constexpr int min_blocks_per_sm(int variant) {
  return variant == 0 ? 3 : variant == kJacobi ? 3 : 2;
}

// The vectors of the loop, all rewritten inside the launch (plain pointers);
// z is null with identity preconditioning.
struct Vectors {
  float* x;
  float* r;
  float* z;
  float* p;
  float* pn;
  float* q;
};

struct Scalars {
  const float* rho;
  const float* absr;
  const float* nf;
  float* partials;
  float* record;
};

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
         : (variant & (kEll | kCsr)) ? 1
                                     : ogl::kMaxDiags;
}

// coef: the Dia data (nd, n) or the Gdia values (nd planes, R, 128); lidx
// the Gdia lanes (null for Dia); offsets: the nd diagonal offsets or plane
// block-row offsets; gm: the Ell, Csr or Sell matrix (their variants; nd =
// 0); invd: the Jacobi inverse diagonal (null with identity).
template <int V>
__global__ void __launch_bounds__(kMaxThreads, min_blocks_per_sm(V))
    cg_loop_kernel(const float* __restrict__ coef, const int8_t* __restrict__ lidx,
                   const int* __restrict__ offsets, int nd, int64_t rows, Gather gm,
                   const float* __restrict__ invd, Vectors v, Scalars s, int64_t n, int vec,
                   ogl::Criterion c) {
  constexpr bool jacobi = (V & kJacobi) != 0;
  constexpr bool gdia = (V & kGdia) != 0;
  constexpr bool ell = (V & kEll) != 0;
  constexpr bool csr = (V & kCsr) != 0;
  constexpr bool sell = (V & kSell) != 0;
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) int s_off[shared_ints(V)];
  ogl::SellBuckets& s_buckets = *reinterpret_cast<ogl::SellBuckets*>(s_off);
  if constexpr (sell) {
    ogl::stage_sell(gm.sell, s_buckets);
  } else {
    for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  }
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float* delta_parts = s.partials;           // (blocks,)
  float* k2_parts = s.partials + blocks;     // (2, blocks): r.z (r.r), then |r|
  const float* zk = jacobi ? v.z : v.r;      // what K1 reads as z
  float* p = v.p;
  float* pn = v.pn;
  const float nf = *s.nf;
  float rho = *s.rho, absr = *s.absr, rho_old = 1.0f;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  while (it < hard_cap) {
    // 1. the criterion (stopping.check_from_norm), the same in every block
    if (ogl::stop_at(c, it, absr, nf, rn, init_rn)) break;
    // 2-3. beta, then K1 over this thread's rows (Dia, Ell) or row quads (Gdia)
    const float beta = it == 0 ? 0.0f : rho / rho_old;
    float dot = 0.0f;
    if constexpr (gdia) {
      dot = ogl::gdia_span<true>(coef, lidx, s_off, nd, rows * ogl::kGdiaLanes, zk, p, beta,
                                 pn, v.q, n, vec, first, step);
    } else if constexpr (ell || csr) {
      const ogl::K1Source<false> src{zk, p, beta};
      for (int64_t i = first; i < n; i += step) {
        float qi;
        if constexpr (ell) {
          qi = ogl::ell_row(gm.ell, src, i, n);
        } else {
          qi = ogl::csr_row(gm.csr.row_ptr, gm.csr.cols, gm.csr.vals, src, i);
        }
        const float pc = src.at(i);
        pn[i] = pc;
        v.q[i] = qi;
        dot += pc * qi;
      }
    } else if constexpr (sell) {
      const ogl::K1Source<false> src{zk, p, beta};
      for (int64_t g = first; g < gm.sell.slots; g += step) {
        const float qi = ogl::sell_slot(gm.sell, s_buckets, src, g);
        const int i = __ldg(gm.sell.slot_rows + g);
        if (i < n) {  // a pad slot writes nothing
          const float pc = src.at(i);
          pn[i] = pc;
          v.q[i] = qi;
          dot += pc * qi;
        }
      }
    } else {
      for (int64_t i = first; i < n; i += step) {
        float pc;
        const float qi = ogl::k1_row(coef, s_off, nd, zk, p, beta, i, n, &pc);
        pn[i] = pc;
        v.q[i] = qi;
        dot += pc * qi;
      }
    }
    ogl::block_sum_to(dot, delta_parts);
    grid.sync();
    // 4-5. delta, alpha, then K2 (K2i) over this thread's rows (or quads)
    float delta[1];
    ogl::block_totals<1>(delta_parts, blocks, delta);
    const float alpha = rho / delta[0];
    rho_old = rho;
    float sums[2] = {0.0f, 0.0f};
    if constexpr (jacobi) {
      ogl::k2_span(alpha, v.x, v.r, v.z, pn, v.q, invd, n, vec, first, step, sums[0], sums[1]);
    } else {
      ogl::k2i_span(alpha, v.x, v.r, pn, v.q, n, vec, first, step, sums[0], sums[1]);
    }
    ogl::block_sums_to<2>(sums, k2_parts);
    grid.sync();
    // 6-7. rho' and ||r||_1; p' becomes p
    ogl::block_totals<2>(k2_parts, blocks, sums);
    rho = sums[0];
    absr = sums[1];
    float* t = p;
    p = pn;
    pn = t;
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ogl::write_record(s.record, it, rn, init_rn, c);
}

const void* loop_kernel(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(cg_loop_kernel<0>);
    case 1: return reinterpret_cast<const void*>(cg_loop_kernel<1>);
    case 2: return reinterpret_cast<const void*>(cg_loop_kernel<2>);
    case 3: return reinterpret_cast<const void*>(cg_loop_kernel<3>);
    case 8: return reinterpret_cast<const void*>(cg_loop_kernel<8>);
    case 9: return reinterpret_cast<const void*>(cg_loop_kernel<9>);
    case 16: return reinterpret_cast<const void*>(cg_loop_kernel<16>);
    case 17: return reinterpret_cast<const void*>(cg_loop_kernel<17>);
    case 32: return reinterpret_cast<const void*>(cg_loop_kernel<32>);
    case 33: return reinterpret_cast<const void*>(cg_loop_kernel<33>);
    default: return nullptr;
  }
}

// The checks and the launch every entry point shares.
int launch(int variant, const float* coef, const int8_t* lidx, const int* offsets, int nd,
           int64_t rows, const Gather& gm, const float* invd, const Vectors& vs,
           const Scalars& ss, int64_t n, float tol, float rel_tol, int min_iter, int max_iter,
           int frequency, int vec, int threads, int64_t blocks, void* stream) {
  const void* kernel = loop_kernel(variant);
  const bool jacobi = (variant & kJacobi) != 0;
  if (kernel == nullptr || n < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 ||
      max_iter < 0 || frequency < 1 || max_iter > INT32_MAX - frequency ||
      (jacobi && (vs.z == nullptr || invd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ogl::misaligned(vs.x, 16) || ogl::misaligned(vs.r, 16) ||
              ogl::misaligned(vs.p, 16) || ogl::misaligned(vs.pn, 16) ||
              ogl::misaligned(vs.q, 16) ||
              (jacobi && (ogl::misaligned(vs.z, 16) || ogl::misaligned(invd, 16)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Vectors v = vs;
  if (!jacobi) v.z = nullptr;
  Scalars s = ss;
  Gather g = gm;
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&coef, &lidx, &offsets, &nd, &rows, &g, &invd, &v, &s, &n, &vec, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream);
}

}  // namespace

// The grid of a loop launch of `variant` (bit 0: Jacobi, bit 1: Gdia, bit 3:
// Ell, bit 4: Csr, bit 5: Sell) with
// `threads` per block on the current device: the blocks that fit on it at
// once (occupancy x SMs).  Fails with cudaErrorNotSupported on a device
// without cooperative launch.
extern "C" int ogl_cg_loop_grid(int variant, int threads, int64_t* blocks) {
  const void* kernel = loop_kernel(variant);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(kernel, threads, blocks);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole loop of `variant`.  Dia: coef = data (nd, n), lidx null, offsets the
// nd diagonal offsets, rows ignored.  Gdia: coef = vals (nd, rows, 128),
// 16-byte aligned, lidx the int8 lanes of the same shape, 4-byte aligned,
// offsets the nd plane block-row offsets.  x and r (and, with Jacobi, z =
// invd * r on entry) are updated in place; p and pn are two scratch vectors
// (p all zeros); partials holds 3 * blocks floats; rho (= r.z, r.r with
// identity), absr and nf are 0-d device scalars; record receives 4 words.
// vec != 0 takes the float4 branches (n % 4 == 0, every vector 16-byte
// aligned).  A grid larger than the co-resident blocks is refused by the
// launch (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error
// code (0 = launched).
extern "C" int ogl_cg_loop(int variant, const float* coef, const int8_t* lidx,
                           const int* offsets, int nd, int64_t rows, float* x, float* r,
                           float* z, const float* invd, float* p, float* pn, float* q,
                           const float* rho, const float* absr, const float* nf,
                           float* partials, float* record, int64_t n, float tol,
                           float rel_tol, int min_iter, int max_iter, int frequency, int vec,
                           int threads, int64_t blocks, void* stream) {
  const bool gdia = (variant & kGdia) != 0;
  if ((variant & (kEll | kCsr | kSell)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (gdia ? (nd < 1 || nd > ogl::kGdiaMaxPlanes || lidx == nullptr || rows * 128 < n)
           : (nd < 0 || nd > ogl::kMaxDiags))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gdia && (ogl::misaligned(coef, 16) || ogl::misaligned(lidx, 4)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(variant, coef, lidx, offsets, nd, rows, Gather{}, invd,
                Vectors{x, r, z, p, pn, q}, Scalars{rho, absr, nf, partials, record}, n, tol,
                rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream);
}

// The same on an Ell matrix (`variant` with bit 3): cols and vals (K, n),
// warp_slots (ceil(n / 32),), each at most K, and, for a Hybrid matrix
// with a tail, tail_ptr (n + 1,), tail_cols and tail_vals (tail_ptr null:
// no tail) in place of the Dia or Gdia operands.
extern "C" int ogl_cg_loop_ell(int variant, const int* cols, const float* vals,
                               const int* warp_slots, const int* tail_ptr, const int* tail_cols,
                               const float* tail_vals, float* x, float* r, float* z,
                               const float* invd, float* p, float* pn, float* q,
                               const float* rho, const float* absr, const float* nf,
                               float* partials, float* record, int64_t n, float tol,
                               float rel_tol, int min_iter, int max_iter, int frequency,
                               int vec, int threads, int64_t blocks, void* stream) {
  if ((variant & ~kJacobi) != kEll || cols == nullptr || vals == nullptr ||
      warp_slots == nullptr ||
      (tail_ptr != nullptr && (tail_cols == nullptr || tail_vals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.ell = ogl::EllOperands{cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals};
  return launch(variant, nullptr, nullptr, nullptr, 0, 0, gm, invd,
                Vectors{x, r, z, p, pn, q}, Scalars{rho, absr, nf, partials, record}, n, tol,
                rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream);
}

// The same on a Csr matrix, or a device Coo (`variant` with bit 4): row_ptr
// (n + 1,), cols and vals (nnz,) in place of the Dia or Gdia operands.
extern "C" int ogl_cg_loop_csr(int variant, const int* row_ptr, const int* cols,
                               const float* vals, float* x, float* r, float* z,
                               const float* invd, float* p, float* pn, float* q,
                               const float* rho, const float* absr, const float* nf,
                               float* partials, float* record, int64_t n, float tol,
                               float rel_tol, int min_iter, int max_iter, int frequency,
                               int vec, int threads, int64_t blocks, void* stream) {
  if ((variant & ~kJacobi) != kCsr || row_ptr == nullptr || cols == nullptr || vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.csr = ogl::CsrOperands{row_ptr, cols, vals};
  return launch(variant, nullptr, nullptr, nullptr, 0, 0, gm, invd,
                Vectors{x, r, z, p, pn, q}, Scalars{rho, absr, nf, partials, record}, n, tol,
                rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream);
}

// The same on a Sell matrix (`variant` with bit 5): the bucket table (nb,
// 3) int64, slice_buckets and slice_widths (slots / C,), slot_rows (slots,)
// (every row once, pad slots n), cols and vals (stored,) in place of the Dia
// or Gdia operands.
extern "C" int ogl_cg_loop_sell(int variant, const long long* table, int nb,
                                const unsigned char* slice_buckets, const int* slice_widths,
                                const int* slot_rows, const int* cols, const float* vals,
                                int64_t slots, int slice_height, float* x, float* r, float* z,
                                const float* invd, float* p, float* pn, float* q,
                                const float* rho, const float* absr, const float* nf,
                                float* partials, float* record, int64_t n, float tol,
                                float rel_tol, int min_iter, int max_iter, int frequency,
                                int vec, int threads, int64_t blocks, void* stream) {
  if ((variant & ~kJacobi) != kSell || nb < 1 || nb > ogl::kSellMaxBuckets ||
      slice_height < 1 || slots < n || slots % slice_height != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.sell = ogl::SellOperands{table, nb, slice_buckets, slice_widths, slot_rows, cols, vals,
                              slots, slice_height};
  return launch(variant, nullptr, nullptr, nullptr, 0, 0, gm, invd,
                Vectors{x, r, z, p, pn, q}, Scalars{rho, absr, nf, partials, record}, n, tol,
                rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream);
}
