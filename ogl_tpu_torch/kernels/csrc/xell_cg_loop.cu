// The whole merged CG loop on an Xell matrix as ONE persistent cooperative
// kernel for Hopper, in two variants: identity or scalar Jacobi
// preconditioning.  Each iteration, in the order of
// ogl_tpu_torch/solve/cg_fused.py (and of cg_loop.cu, its Dia and Gdia
// counterpart):
//   1. check   the OpenFOAM criterion from the summed ||r||_1 (gated by
//              minIter and frequency; stop at maxIter, below tolerance or
//              below relTol * the initial residual; leave at maxIter +
//              frequency without a check);
//   2. beta    0 at iteration 0, else rho / rho_old;
//   3. K1      over bands blockIdx.x, blockIdx.x + gridDim.x, ...: the band
//              body of xell_band.cuh with the source p'(j) = z[j] + beta *
//              p[j] (z is r with identity), spill included; p' into the other
//              buffer of the (p, p') pair and q; one partial of p'.q per
//              block;
//   4. grid barrier; every block sums the partials into delta;
//   5. K2      alpha = rho / delta, x += alpha * p', r -= alpha * q, and
//              with Jacobi z = invd * r, over rows (cg_k2.cuh, cg_k2i.cuh);
//              the partials of r'.z' (r'.r' with identity: K2i) and |r'|;
//   6. grid barrier; the sums give rho' and ||r||_1;
//   7. p and p' swap buffers (other bands read p during the next K1).
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// Replaces: the K1 (ogl_tpu/kernels/xell.py `_k1x_kernel`, with
// `_spill_corr` inside it), K2 (ogl_tpu/kernels/fused.py `_k2_kernel`,
// Jacobi) and K2i (`_k2i_kernel`, identity) launches of the reference's
// merged CG on an Xell matrix and the `jax.lax.while_loop` around them
// (ogl_tpu/solve/cg_fused.py:82-123).  Plain twin: `cg_loop_plain` in
// ogl_tpu_torch/kernels/fused.py over `xell_k1_plain`.
//
// Bound: device-memory bandwidth.  Per iteration and row: K1 reads K slots
// of vals, ll and bbT (K * 7 bytes), z (r) and p and sp_ptr and writes p'
// and q (K * 7 + 20), plus 12 bytes per spill entry; K2i reads x, r, p' and
// q and writes x and r (24); Jacobi adds invd in and z out (+ 8).  Besides,
// two grid barriers and the redundant partial sums.
//
// Design, as cg_loop.cu: the host launches once per solve and reads once;
// the grid is exactly the co-resident blocks of the variant (occupancy x
// SMs with the 59,392-byte ring of dynamic shared memory, queried once per
// plan and variant; fewer when the rows run out), so grid.sync() is legal
// and every block sums all partials in block order: the same bits for delta,
// rho and ||r||_1 in every block, and one branch at the check.  The K1 phase
// walks bands of 2,048 rows (1M rows: 512 bands over 264 blocks), with a
// block barrier before each band but the block's first, and the band body
// drains its cp.async groups before returning, so no copy is in flight at a
// grid barrier; the K2 phase walks rows (quads with vec) over the whole grid.
// The ragged last band reads the padded storage in full and masks at the
// spill and the store; the K2 phase covers exactly n rows.  x, r, z, p, p'
// and q are rewritten inside the launch, so K1 reads its sources through
// plain loads; vals, ll and bbT arrive by cp.async, the spill tables and
// invd through the read-only path.  Registers: 64 per thread at two blocks
// of 512 per SM (the band body holds four rows' values, sources and sums).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k2.cuh"
#include "cg_k2i.cuh"
#include "loop.cuh"
#include "xell_band.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kJacobi = 1;  // the variant bit: scalar Jacobi preconditioning

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

template <int V>
__global__ void __launch_bounds__(ogl::kBandThreads, 2)
    xell_cg_loop_kernel(ogl::XellOperands m, const float* __restrict__ invd, Vectors v,
                        Scalars s, int64_t n, int vec, ogl::Criterion c) {
  constexpr bool jacobi = (V & kJacobi) != 0;
  extern __shared__ __align__(16) unsigned char ring[];
  cg::grid_group grid = cg::this_grid();

  const int blocks = gridDim.x;
  const int64_t bands = (n + ogl::kBandRows - 1) / ogl::kBandRows;
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
    // 2-3. beta, then K1 over this block's bands
    const float beta = it == 0 ? 0.0f : rho / rho_old;
    const ogl::K1Source<false> src{zk, p, beta};
    float dot = 0.0f;
    for (int64_t band = blockIdx.x; band < bands; band += blocks) {
      if (band != blockIdx.x) __syncthreads();  // the last band's ring stages are free
      float acc[4];
      ogl::band_apply(m, src, n, ring, band, acc);
      dot += ogl::band_k1_store(src, acc, pn, v.q, ogl::band_row0(band), n, vec);
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
    case 0: return reinterpret_cast<const void*>(xell_cg_loop_kernel<0>);
    case 1: return reinterpret_cast<const void*>(xell_cg_loop_kernel<1>);
    default: return nullptr;
  }
}

// The ring attribute of each variant, set once (before its first occupancy
// query or launch).
cudaError_t ring_allowed(int variant) {
  static const cudaError_t err[2] = {ogl::allow_ring(loop_kernel(0)),
                                     ogl::allow_ring(loop_kernel(1))};
  return err[variant];
}

}  // namespace

// The grid of a loop launch of `variant` (bit 0: Jacobi) with `threads` (=
// 512, the band body's) per block on the current device: the blocks that fit
// on it at once with the ring (occupancy x SMs).  Fails with
// cudaErrorNotSupported on a device without cooperative launch.
extern "C" int ogl_xell_cg_loop_grid(int variant, int threads, int64_t* blocks) {
  const void* kernel = loop_kernel(variant);
  if (kernel == nullptr || threads != ogl::kBandThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t ring = ring_allowed(variant);
  if (ring != cudaSuccess) return static_cast<int>(ring);
  return ogl::coop_grid(kernel, threads, blocks, ogl::kRingBytes);
}

// One cooperative launch of `blocks` blocks of `threads` (= 512) on
// `stream`: the whole loop of `variant` on the Xell matrix (vals, ll, bbT:
// (nt, K, 128, 128), vals and ll 16-byte aligned, bbT 4-byte aligned; the
// spill's row CSR, or sp_ptr NULL without spill).  x and r (and, with
// Jacobi, z = invd * r on entry) are updated in place; p and pn are two
// scratch vectors (p all zeros); partials holds 3 * blocks floats; rho (=
// r.z, r.r with identity), absr and nf are 0-d device scalars; record
// receives 4 words.  vec != 0 takes the float4 branches (n % 4 == 0, every
// vector 16-byte aligned).  A grid larger than the co-resident blocks is
// refused by the launch (cudaErrorCooperativeLaunchTooLarge).  Returns the
// launch's error code (0 = launched).
extern "C" int ogl_xell_cg_loop(int variant, const float* vals, const int8_t* ll,
                                const int16_t* bbT, int n_slots, int c_left, const int* sp_ptr,
                                const int* sp_cols, const int* sp_gidx, const float* sp_vals,
                                float* x, float* r, float* z, const float* invd, float* p,
                                float* pn, float* q, const float* rho, const float* absr,
                                const float* nf, float* partials, float* record, int64_t n,
                                float tol, float rel_tol, int min_iter, int max_iter,
                                int frequency, int vec, int threads, int64_t blocks,
                                void* stream) {
  const void* kernel = loop_kernel(variant);
  const bool jacobi = (variant & kJacobi) != 0;
  if (kernel == nullptr || n < 1 || threads != ogl::kBandThreads || blocks < 1 ||
      blocks > INT32_MAX || min_iter < 0 || max_iter < 0 || frequency < 1 ||
      max_iter > INT32_MAX - frequency || n_slots < 1 || c_left < 0 ||
      (jacobi && (z == nullptr || invd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ogl::misaligned(vals, 16) || ogl::misaligned(ll, 16) || ogl::misaligned(bbT, 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (vec && ((n & 3) != 0 || ogl::misaligned(x, 16) || ogl::misaligned(r, 16) ||
              ogl::misaligned(p, 16) || ogl::misaligned(pn, 16) || ogl::misaligned(q, 16) ||
              (jacobi && (ogl::misaligned(z, 16) || ogl::misaligned(invd, 16)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaError_t ring = ring_allowed(variant);
  if (ring != cudaSuccess) return static_cast<int>(ring);
  ogl::XellOperands m{vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals};
  Vectors v{x, r, jacobi ? z : nullptr, p, pn, q};
  Scalars s{rho, absr, nf, partials, record};
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  const float* inv = jacobi ? invd : nullptr;
  void* args[] = {&m, &inv, &v, &s, &n, &vec, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream, ogl::kRingBytes);
}
