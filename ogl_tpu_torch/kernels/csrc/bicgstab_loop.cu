// The whole merged BiCGStab loop on a Dia matrix (identity preconditioning)
// as ONE persistent cooperative kernel for Hopper.  Each iteration, in the
// order of the host loop (ogl_tpu_torch/kernels/fused.py
// `bicgstab_loop_plain`, run by solve/bicgstab_fused.py) and of the
// reference's while_loop body:
//   1. check   the OpenFOAM criterion from the carried ||r||_1 (gated by
//              minIter and frequency); when it says stop the loop leaves
//              before any phase and does not count the pass: the
//              reference's alpha = omega = 0 freeze;
//   2. beta    sdiv(rho, rho_old) * sdiv(alpha, omega), where sdiv(n, d) is
//              n / d when |d| > (1e-6)^2, else 0 (the breakdown guard);
//   3. K1B     p' = r + beta * p - beta * omega * v, v' = A p' into the other
//              buffers of the (p, p') and (v, v') pairs, one partial of
//              rhat.v' per block;
//   4. grid barrier; every block sums the partials in block order;
//              alpha = sdiv(rho, rhat.v');
//   5. K1B     b is c: s = r - alpha * v' at each source, t = A s, partials
//              of t.s and t.t (no rhat read);
//   6. grid barrier; omega = sdiv(t.s, t.t);
//   7. KB_update  x += alpha * p' + omega * s, r' = s - omega * t into r,
//              partials of rhat.r' and ||r'||_1;
//   8. grid barrier; rho_old = rho, rho = rhat.r', the carried ||r||_1;
//              the pairs swap; leave at maxIter + frequency without a check.
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// Replaces: the two K1B (ogl_tpu/kernels/fused.py `_k1b_kernel`) and the
// KB_update (`_kb_update_kernel`) launches of the reference's merged
// BiCGStab and the `jax.lax.while_loop` around them with the criterion as
// loop state (ogl_tpu/solve/bicgstab_fused.py:81-101,
// ogl_tpu/solve/stopping.py).  Plain twin: `bicgstab_loop_plain` in
// ogl_tpu_torch/kernels/fused.py.  The phases are the standalone kernels'
// bodies (bicgstab_k1b.cuh, bicgstab_kb_update.cuh); the criterion, the
// block-order sums and the cooperative launch are loop.cuh's, shared with
// the CG loops (cg_loop.cu, cg_pipe_loop.cu).
//
// Bound: device-memory bandwidth.  Per iteration and row: the first K1B
// reads nd coefficients, r, p, v and rhat and writes p' and v' ((nd + 6) *
// 4 bytes); the second reads nd coefficients, r and v' and writes s and t
// ((nd + 4) * 4); KB_update reads x, p', s, t and rhat and writes x and r
// (28): 8 * nd + 68 bytes, 124 at 7 diagonals.  Besides, three grid
// barriers and the redundant partial sums (each block reads every block's
// partials).
//
// Design, as cg_loop.cu: the host launches once per solve and reads once.
// The grid is exactly the co-resident blocks (occupancy x SMs, queried once
// per plan; fewer when the rows run out), each block walking its row quads
// (rows when vec = 0) with a grid-stride loop in a fixed order, so
// grid.sync() is legal and the reduction order is fixed for a given grid:
// every block computes the same bits for the sums and the scalars and takes
// the same branch at the check.  The K1B phases read p, v, r and v' at the
// neighbours, so neither is in place: p' and v' go into the other buffer of
// their pair, s and t into buffers of their own.  x, r, p, p', v, v', s and
// t are written inside the launch and read by other blocks after a barrier,
// so they go through plain loads: only the coefficients, the offsets and
// rhat are __restrict__.  nf, rho and ||r_0||_1 arrive as device scalars,
// tol and relTol as float, as the host loop compares float32 tensors with
// them, and every division is IEEE (no fast math).  Each phase writes its
// own rows of one partials buffer of 5 x blocks floats (rhat.v'; t.s and
// t.t; rhat.r' and ||r'||_1): a row is read by every block after the
// barrier that ends its phase and rewritten only in the next iteration,
// after the two barriers that follow every read of it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bicgstab_k1b.cuh"
#include "bicgstab_kb_update.cuh"
#include "block_sum.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
// Blocks of 512 per SM the kernel is compiled for: two, at most 64
// registers, as the CG loop's Gdia variants (the row-quad K1B phase keeps
// four rows' sums and two source quads in registers).
constexpr int kBlocksPerSm = 2;
// small_of(float32)^2: the breakdown guard of solve/bicgstab.py _safe_div
constexpr float kTiny = 1e-12f;

__device__ __forceinline__ float sdiv(float num, float den) {
  return fabsf(den) > kTiny ? num / den : 0.0f;
}

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
};

struct Scalars {
  const float* rho;
  const float* absr;
  const float* nf;
  float* partials;
  float* record;
};

// data: the Dia data (nd, n); offsets: the nd diagonal offsets; rhat: the
// fixed shadow residual.
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
    bicgstab_loop_kernel(const float* __restrict__ data, const int* __restrict__ offsets, int nd,
                         const float* __restrict__ rhat, Vectors v, Scalars sc, int64_t n,
                         int vec, ogl::Criterion c) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float* rv_parts = sc.partials;               // (blocks,): rhat.v'
  float* ts_parts = sc.partials + blocks;      // (2, blocks): t.s, t.t
  float* rr_parts = sc.partials + 3 * blocks;  // (2, blocks): rhat.r', ||r'||_1
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
    // 2-3. beta, then K1B: p' = r + beta p - beta omega v, v' = A p'
    const float beta = sdiv(rho, rho_old) * sdiv(alpha, omega);
    float sums[3] = {0.0f, 0.0f, 0.0f};
    ogl::k1b_span<false, true>(data, s_off, nd, v.r, p, vv, rhat, beta, -beta * omega, pn, vn,
                               n, vec, first, step, sums);
    ogl::block_sum_to(sums[0], rv_parts);
    grid.sync();
    // 4-5. alpha, then K1B with b is c: s = r - alpha v', t = A s
    float rv[1];
    ogl::block_totals<1>(rv_parts, blocks, rv);
    alpha = sdiv(rho, rv[0]);
    sums[0] = sums[1] = sums[2] = 0.0f;
    ogl::k1b_span<true, false>(data, s_off, nd, v.r, vn, vn, nullptr, -alpha, 0.0f, v.s, v.t, n,
                               vec, first, step, sums);
    float ts[2] = {sums[1], sums[2]};
    ogl::block_sums_to<2>(ts, ts_parts);
    grid.sync();
    // 6-7. omega, then KB_update: x += alpha p' + omega s, r' = s - omega t
    ogl::block_totals<2>(ts_parts, blocks, ts);
    omega = sdiv(ts[0], ts[1]);
    float rr[2] = {0.0f, 0.0f};
    ogl::kb_update_span(alpha, omega, v.x, pn, v.s, v.t, rhat, v.r, n, vec, first, step, rr[0],
                        rr[1]);
    ogl::block_sums_to<2>(rr, rr_parts);
    grid.sync();
    // 8. rho' and ||r'||_1; p' and v' become p and v
    ogl::block_totals<2>(rr_parts, blocks, rr);
    rho_old = rho;
    rho = rr[0];
    absr = rr[1];
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

// The grid of a loop launch (variant 0, the one there is) with `threads`
// per block on the current device: the blocks that fit on it at once
// (occupancy x SMs).  Fails with cudaErrorNotSupported on a device without
// cooperative launch.
extern "C" int ogl_bicgstab_loop_grid(int variant, int threads, int64_t* blocks) {
  if (variant != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(reinterpret_cast<const void*>(bicgstab_loop_kernel), threads, blocks);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole merged BiCGStab loop.  data (nd, n) and offsets as the Dia kernels
// take them; rhat the shadow residual; x and r (r = b - A x0) are updated in
// place; p and v are scratch vectors of zeros, pn, vn, s and t scratch
// vectors; rho (= rhat.r), absr (||r||_1) and nf are 0-d device scalars;
// partials holds 5 * blocks floats; record receives 4 words.  vec != 0
// takes the row-quad branches (n % 4 == 0, data, rhat and every vector
// 16-byte aligned).  A grid larger than the co-resident blocks is refused
// by the launch (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's
// error code (0 = launched).
extern "C" int ogl_bicgstab_loop(const float* data, const int* offsets, int nd, const float* rhat,
                                 float* x, float* r, float* p, float* pn, float* v, float* vn,
                                 float* s, float* t, const float* rho, const float* absr,
                                 const float* nf, float* partials, float* record, int64_t n,
                                 float tol, float rel_tol, int min_iter, int max_iter,
                                 int frequency, int vec, int threads, int64_t blocks,
                                 void* stream) {
  if (n < 1 || nd < 0 || nd > ogl::kMaxDiags || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 || max_iter < 0 ||
      frequency < 1 || max_iter > INT32_MAX - frequency)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 || ogl::misaligned(data, 16) || ogl::misaligned(rhat, 16) ||
              ogl::misaligned(x, 16) || ogl::misaligned(r, 16) || ogl::misaligned(p, 16) ||
              ogl::misaligned(pn, 16) || ogl::misaligned(v, 16) || ogl::misaligned(vn, 16) ||
              ogl::misaligned(s, 16) || ogl::misaligned(t, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Vectors vs{x, r, p, pn, v, vn, s, t};
  Scalars sc{rho, absr, nf, partials, record};
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&data, &offsets, &nd, &rhat, &vs, &sc, &n, &vec, &c};
  return ogl::coop_launch(reinterpret_cast<const void*>(bicgstab_loop_kernel), blocks, threads,
                          args, stream);
}
