// The whole merged CG loop for a Dia matrix with identity preconditioning,
// as ONE persistent cooperative kernel for Hopper.  Each iteration, in the
// order of ogl_tpu_torch/solve/cg_fused.py:
//   1. check   the OpenFOAM criterion from the summed ||r||_1 (gated by
//              minIter and frequency; stop at maxIter, below tolerance or
//              below relTol * the initial residual; leave at maxIter +
//              frequency without a check);
//   2. beta    0 at iteration 0, else rho / rho_old;
//   3. K1      p' = r + beta * p, q = A p', one partial of p'.q per block;
//   4. grid barrier; every block sums the partials into delta;
//   5. K2i     alpha = rho / delta, x += alpha * p', r -= alpha * q, the
//              partials of r.r and |r|;
//   6. grid barrier; the sums give rho' and ||r||_1;
//   7. p and p' swap buffers (neighbours read p during the next K1).
// On exit block 0 writes the record {iterations (int32), final normalised
// residual, initial normalised residual, converged (tolerances met)}.
//
// Replaces: the K1 (ogl_tpu/kernels/fused.py `_k1_kernel`) and K2i
// (`_k2i_kernel`) launches of the reference's merged CG and the
// `jax.lax.while_loop` around them with the criterion as loop state
// (ogl_tpu/solve/cg_fused.py:82-123, ogl_tpu/solve/stopping.py).  Plain twin:
// `cg_loop_plain` in ogl_tpu_torch/kernels/fused.py.
//
// Bound: device-memory bandwidth.  Per iteration and row: K1 reads nd
// coefficients, r and p and writes p' and q; K2i reads x, r, p' and q and
// writes x and r: (nd + 4) * 4 + 24 bytes.  Besides, two grid barriers and
// the redundant partial sums (each block reads every block's partials).
//
// Design.  A loop on the host pays a host launch per kernel and a
// device-to-host read per check; here the host launches once and reads
// once.  The grid is exactly the co-resident blocks (occupancy x SMs,
// queried once per plan; fewer when the rows run out), each block walking
// its rows with a grid-stride loop in a fixed order, so cooperative groups'
// grid.sync() is legal and the reduction order is fixed for a given grid:
// every block sums all partials in block order and so computes the same
// bits for delta, rho and ||r||_1, and all blocks take the same branch at
// the check.  x, r, p, p' and q are written inside the launch and read by
// other blocks after a barrier, so they go through plain loads: only the
// coefficients and offsets are __restrict__ (the read-only, non-coherent
// path could return values from before a barrier).  tol and relTol arrive
// as float, as the host loop compares float32 tensors with them, and every
// division is IEEE (no fast math).  The partials of one phase are read
// after the barrier that ends it and rewritten only after the next one, so
// one buffer per sum suffices.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "cg_k1.cuh"
#include "cg_k2i.cuh"

namespace cg = cooperative_groups;

namespace {

// 512 threads and at most 40 registers, so that three blocks fit on an SM
// (ptxas spills about 100 bytes): two blocks at the 62 registers the
// kernel takes unbounded, or four at 32, streamed slower at 8.4M rows.
constexpr int kMaxThreads = 512;
constexpr int kMinBlocksPerSm = 3;

struct Criterion {
  float tol;
  float rel_tol;
  int min_iter;
  int max_iter;
  int frequency;
};

__device__ __forceinline__ bool hit(const Criterion& c, float rn, float init_rn) {
  return rn < c.tol || (c.rel_tol > 0.0f && rn < c.rel_tol * init_rn);
}

// The N sums of rows v[k * count .. (k + 1) * count) as every thread of the
// block sees them: each thread adds its strided share in index order, then
// the block reduces in a fixed order, so every block gets the same bits.
template <int N>
__device__ __forceinline__ void block_totals(const float* v, int count, float (&out)[N]) {
  __shared__ float s_warps[N][32];
  __shared__ float s_total[N];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < count; b += blockDim.x) acc += v[(int64_t)k * count + b];
    acc = ogl::warp_sum(acc);
    if (lane == 0) s_warps[k][warp] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = ogl::warp_sum(lane < n_warps ? s_warps[k][lane] : 0.0f);
      if (lane == 0) s_total[k] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = s_total[k];
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
    cg_loop_kernel(const float* __restrict__ data, const int* __restrict__ offsets, int nd,
                   float* x, float* r, float* p, float* pn, float* q,
                   const float* __restrict__ rho_ptr, const float* __restrict__ absr_ptr,
                   const float* __restrict__ nf_ptr, float* partials, float* record,
                   int64_t n, int vec, Criterion c) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[ogl::kMaxDiags];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int blocks = gridDim.x;
  const int64_t step = static_cast<int64_t>(blocks) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float* delta_parts = partials;           // (blocks,)
  float* k2i_parts = partials + blocks;    // (2, blocks): r.r, then |r|
  const float nf = *nf_ptr;
  float rho = *rho_ptr, absr = *absr_ptr, rho_old = 1.0f;
  float rn = 0.0f, init_rn = 0.0f;
  const int hard_cap = c.max_iter + c.frequency;
  int it = 0;
  while (it < hard_cap) {
    // 1. the criterion (stopping.check_from_norm), the same in every block
    if (!((it > 0 && it < c.min_iter) || it % c.frequency != 0)) {
      rn = absr / nf;
      if (it == 0) init_rn = rn;
      if (it >= c.max_iter || hit(c, rn, init_rn)) break;
    }
    // 2-3. beta, then K1 over this thread's rows
    const float beta = it == 0 ? 0.0f : rho / rho_old;
    float dot = 0.0f;
    for (int64_t i = first; i < n; i += step) {
      float pc;
      const float qi = ogl::k1_row(data, s_off, nd, r, p, beta, i, n, &pc);
      pn[i] = pc;
      q[i] = qi;
      dot += pc * qi;
    }
    ogl::block_sum_to(dot, delta_parts);
    grid.sync();
    // 4-5. delta, alpha, then K2i over this thread's rows (or quads)
    float delta[1];
    block_totals<1>(delta_parts, blocks, delta);
    const float alpha = rho / delta[0];
    rho_old = rho;
    float sums[2] = {0.0f, 0.0f};
    ogl::k2i_span(alpha, x, r, pn, q, n, vec, first, step, sums[0], sums[1]);
    ogl::block_sums_to<2>(sums, k2i_parts);
    grid.sync();
    // 6-7. rho' and ||r||_1; p' becomes p
    block_totals<2>(k2i_parts, blocks, sums);
    rho = sums[0];
    absr = sums[1];
    float* t = p;
    p = pn;
    pn = t;
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    reinterpret_cast<int*>(record)[0] = it;
    record[1] = rn;
    record[2] = init_rn;
    record[3] = hit(c, rn, init_rn) ? 1.0f : 0.0f;
  }
}

}  // namespace

// The grid of a loop launch with `threads` per block on the current device:
// the blocks that fit on it at once (occupancy x SMs).  Fails with
// cudaErrorNotSupported on a device without cooperative launch.
extern "C" int ogl_cg_loop_grid(int threads, int64_t* blocks) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_loop_kernel, threads, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  cudaGetLastError();  // a failed query must not surface at the next launch check
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = static_cast<int64_t>(per_sm) * sms;
  return 0;
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole loop.  x and r are updated in place; p and pn are two scratch
// vectors (p all zeros); partials holds 3 * blocks floats; rho, absr and nf
// are 0-d device scalars; record receives 4 words.  vec != 0 takes the
// float4 branch of the K2i phase (n % 4 == 0, x, r, p, pn, q 16-byte
// aligned).  A grid larger than the co-resident blocks is refused by the
// launch (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error
// code (0 = launched).
extern "C" int ogl_cg_loop(const float* data, const int* offsets, int nd, float* x, float* r,
                           float* p, float* pn, float* q, const float* rho,
                           const float* absr, const float* nf, float* partials,
                           float* record, int64_t n, float tol, float rel_tol, int min_iter,
                           int max_iter, int frequency, int vec, int threads,
                           int64_t blocks, void* stream) {
  if (nd < 0 || nd > ogl::kMaxDiags || n < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 ||
      max_iter < 0 || frequency < 1 || max_iter > INT32_MAX - frequency)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((n & 3) != 0 ||
              ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(pn) |
                reinterpret_cast<uintptr_t>(q)) & 15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&data, &offsets, &nd, &x, &r, &p, &pn, &q, &rho, &absr, &nf,
                  &partials, &record, &n, &vec, &c};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cg_loop_kernel), dim3(static_cast<unsigned int>(blocks)),
      dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  // also clears a refused launch's error, which would else surface at the
  // next kernel's cudaGetLastError()
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
