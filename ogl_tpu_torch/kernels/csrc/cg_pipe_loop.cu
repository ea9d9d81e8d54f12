// The whole merged pipelined (Chronopoulos-Gear) CG loop on a Dia matrix as
// ONE persistent cooperative kernel for Hopper, in two variants: identity
// or scalar Jacobi preconditioning.  Each iteration, in the order of the
// host loop (ogl_tpu_torch/kernels/fused.py `cg_pipe_loop_plain`, run by
// solve/cg_pipe_fused.py) and of the reference's while_loop body:
//   1. KA      u = invd * r (r with identity), w = A u over this thread's
//              rows; one partial per block of gamma = r.u, delta = w.u and
//              ||r||_1;
//   2. grid barrier; every block sums the three partial rows in block order;
//   3. check   the OpenFOAM criterion from ||r||_1 (gated by minIter and
//              frequency); when it says stop the loop leaves before KB_pipe
//              and does not count the pass: the reference's alpha = 0 freeze;
//   4. scalars beta = 0 and denom = delta at iteration 0, else
//              beta = gamma / gamma_old and denom = delta - beta * gamma /
//              alpha_old; alpha = gamma / denom;
//   5. KB_pipe p' = u + beta * p, s' = w + beta * s, x' = x + alpha * p',
//              r' = r - alpha * s', in place, over rows or row quads;
//   6. grid barrier (the next KA reads r' at the neighbours);
//   7. gamma_old = gamma, alpha_old = alpha; leave at maxIter + frequency
//      without a check.
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// Replaces: the KA (ogl_tpu/kernels/fused.py `_ka_kernel`) and KB_pipe
// (`_kb_pipe_kernel`) launches of the reference's merged pipelined CG and
// the `jax.lax.while_loop` around them with the criterion as loop state
// (ogl_tpu/solve/cg_pipe_fused.py:76-94, ogl_tpu/solve/stopping.py).  Plain
// twin: `cg_pipe_loop_plain` in ogl_tpu_torch/kernels/fused.py.  The phases
// are the standalone kernels' bodies (cg_ka.cuh, cg_kb_pipe.cuh); the
// criterion, the block-order sums and the cooperative launch are loop.cuh's,
// shared with the merged CG loop (cg_loop.cu).
//
// Bound: device-memory bandwidth.  Per iteration and row, KA reads nd
// coefficients and r and writes w; KB_pipe reads w, p, s, x and r and
// writes p, s, x and r: (nd + 2) * 4 + 36 bytes (72 at 7 diagonals); Jacobi
// reads invd in each phase (+ 8).  Besides, two grid barriers and the
// redundant partial sums (each block reads every block's partials).
//
// Design, as cg_loop.cu: the host launches once per solve and reads once.
// The grid is exactly the co-resident blocks of the variant (occupancy x
// SMs, queried once per plan and variant; fewer when the rows run out),
// each block walking its rows (KA) or row quads (KB_pipe) with a
// grid-stride loop in a fixed order, so grid.sync() is legal and the
// reduction order is fixed for a given grid: every block computes the same
// bits for gamma, delta and ||r||_1 and takes the same branch at the check.
// The pipelined recurrence needs one reduction point per iteration where
// the classical one needs two, but KA reads r' at the neighbours, so the
// iteration still has two barriers.  x, r, p, s and w are written inside
// the launch and read by other blocks after a barrier, so they go through
// plain loads: only the coefficients, offsets and invd are __restrict__.
// nf arrives as a device scalar, tol and relTol as float, as the host loop
// compares float32 tensors with them, and every division is IEEE (no fast
// math).  The partials of KA are read after the barrier that ends it and
// rewritten only after the next one, so one buffer suffices.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_ka.cuh"
#include "cg_kb_pipe.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kJacobi = 1;  // variant bit: scalar Jacobi preconditioning

// Blocks of 512 per SM each variant is compiled for: three, at most 40
// registers (spilling 76-144 bytes), as the merged CG loop's Dia variants.
// Timed in turns on the H100 at 8.4M rows, two blocks at the 62-64
// registers the variants take unbounded (no spill) streamed slower, and
// four at 32 no faster.
constexpr int min_blocks_per_sm(int) { return 3; }

// The vectors of the loop, all rewritten inside the launch (plain pointers).
struct Vectors {
  float* x;
  float* r;
  float* p;
  float* s;
  float* w;
};

// data: the Dia data (nd, n); offsets: the nd diagonal offsets; invd: the
// Jacobi inverse diagonal (null with identity); nf: the norm factor (0-d).
template <int V>
__global__ void __launch_bounds__(kMaxThreads, min_blocks_per_sm(V))
    cg_pipe_loop_kernel(const float* __restrict__ data, const int* __restrict__ offsets, int nd,
                        const float* __restrict__ invd, Vectors v,
                        const float* __restrict__ nf_ptr, float* partials, float* record,
                        int64_t n, int vec, ogl::Criterion c) {
  constexpr bool jacobi = (V & kJacobi) != 0;
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float nf = *nf_ptr;
  float gamma_old = 1.0f, alpha_old = 1.0f;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  while (it < hard_cap) {
    // 1. KA over this thread's rows
    float sums[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t i = first; i < n; i += step)
      ogl::ka_row<jacobi>(data, s_off, nd, v.r, invd, v.w, i, n, sums);
    ogl::block_sums_to<3>(sums, partials);
    grid.sync();
    // 2-3. gamma, delta and ||r||_1, then the criterion, the same in every block
    ogl::block_totals<3>(partials, blocks, sums);
    const float gamma = sums[0], delta = sums[1];
    if (ogl::stop_at(c, it, sums[2], nf, rn, init_rn)) break;
    // 4. the scalars, as the host loop forms them
    float beta = 0.0f, denom = delta;
    if (it > 0) {
      beta = gamma / gamma_old;
      denom = delta - beta * gamma / alpha_old;
    }
    const float alpha = gamma / denom;
    // 5-6. KB_pipe over this thread's rows (quads), then the barrier
    ogl::kb_pipe_span<jacobi>(alpha, beta, v.w, v.p, v.s, v.x, v.r, invd, n, vec, first, step);
    grid.sync();
    // 7.
    gamma_old = gamma;
    alpha_old = alpha;
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ogl::write_record(record, it, rn, init_rn, c);
}

const void* pipe_loop_kernel(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(cg_pipe_loop_kernel<0>);
    case 1: return reinterpret_cast<const void*>(cg_pipe_loop_kernel<1>);
    default: return nullptr;
  }
}

}  // namespace

// The grid of a pipelined loop launch of `variant` (bit 0: Jacobi) with
// `threads` per block on the current device: the blocks that fit on it at
// once (occupancy x SMs).  Fails with cudaErrorNotSupported on a device
// without cooperative launch.
extern "C" int ogl_cg_pipe_loop_grid(int variant, int threads, int64_t* blocks) {
  const void* kernel = pipe_loop_kernel(variant);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(kernel, threads, blocks);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole pipelined loop of `variant`.  data (nd, n) and offsets as the Dia
// kernels take them; invd the inverse diagonal (Jacobi) or null; x and r
// (r = b - A x0) are updated in place; p and s are scratch vectors of
// zeros, w a scratch vector; nf is a 0-d device scalar; partials holds
// 3 * blocks floats; record receives 4 words.  vec != 0 takes KB_pipe's
// float4 branch (x, r, p, s, w and invd 16-byte aligned).  A grid larger
// than the co-resident blocks is refused by the launch
// (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error code
// (0 = launched).
extern "C" int ogl_cg_pipe_loop(int variant, const float* data, const int* offsets, int nd,
                                const float* invd, float* x, float* r, float* p, float* s,
                                float* w, const float* nf, float* partials, float* record,
                                int64_t n, float tol, float rel_tol, int min_iter, int max_iter,
                                int frequency, int vec, int threads, int64_t blocks,
                                void* stream) {
  const void* kernel = pipe_loop_kernel(variant);
  const bool jacobi = (variant & kJacobi) != 0;
  if (kernel == nullptr || n < 1 || nd < 0 || nd > ogl::kMaxDiags || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX ||
      min_iter < 0 || max_iter < 0 || frequency < 1 || max_iter > INT32_MAX - frequency ||
      (jacobi && invd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (ogl::misaligned(x, 16) || ogl::misaligned(r, 16) || ogl::misaligned(p, 16) ||
              ogl::misaligned(s, 16) || ogl::misaligned(w, 16) ||
              (jacobi && ogl::misaligned(invd, 16))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (!jacobi) invd = nullptr;
  Vectors v{x, r, p, s, w};
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&data, &offsets, &nd, &invd, &v, &nf, &partials, &record, &n, &vec, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream);
}
