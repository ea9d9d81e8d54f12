// The block-Jacobi apply ("BJ" with maxBlockSize > 1) for Hopper, as a body
// over a SOURCE FUNCTOR:
//   y[b * bs + i] = sum_k inv[b, i, k] * w(b * bs + k)
// over uniform contiguous blocks of bs rows (the last one padded with
// identity rows, as the set-up pads it, and w = 0 past n), for bs from 2 to
// 32.  The standalone launch (block_jacobi.cu) takes w(g) = r[g]; the
// general-BiCGStab loop (bicgstab_gen_loop.cu) runs it as its two
// preconditioner phases, with w(g) the direction p' or s formed at row g.
// A source is a struct with
//   float at(int64_t g) const;   // w at row g, 0 <= g < n
// and a sink a struct with
//   void operator()(int64_t g, float w, float y) const;  // row g < n done
//
// Arithmetic: y accumulates in float32 in k order from 0.0f, every product
// and every sum rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as block_jacobi_plain (kernels/block_jacobi.py) writes it,
// so the body and its twin give the same bits.
//
// Bound: device-memory bandwidth.  Per row it reads one row of its block's
// inverse (bs floats) and what the source reads, and writes what the sink
// writes: standalone (bs + 2) * 4 bytes.
//
// Design: one thread per output row.  A CTA tile holds whole Jacobi blocks,
// per = floor(blockDim.x / bs) * bs rows (bs need not divide blockDim.x:
// 3, 5, 7 leave threads idle), and the CTAs walk the tiles of the padded
// rows grid-stride.  Each thread forms its source once and stages it in
// shared memory; after a CTA barrier every thread of a Jacobi block reads
// that block's bs values from there.  The inverses are stored transposed
// within each block, inv_t[b, k, i] = inv[b, i, k] (precond/jacobi.py), so
// for each k the threads of a Jacobi block read consecutive floats: the bs
// steps of k read the block's bs * bs floats once, coalesced.  A second
// barrier ends the tile before the next one overwrites the stage.  The
// inverses are read-only for a launch and take the non-coherent path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {
namespace bj {

constexpr int kMinBlock = 2;
constexpr int kMaxBlock = 32;

// A thread's place in the tiling of n rows by blocks of bs, taken once per
// launch (the divisions by bs stay out of the tiles).
struct Tiling {
  int bs;
  int per;        // rows per tile: whole Jacobi blocks
  int i;          // this thread's row within its Jacobi block
  int64_t tiles;  // tiles of the padded rows
};

__device__ __forceinline__ Tiling tiling(int64_t n, int bs) {
  const int per = (static_cast<int>(blockDim.x) / bs) * bs;
  const int64_t padded = (n + bs - 1) / bs * bs;
  return Tiling{bs, per, static_cast<int>(threadIdx.x) % bs, (padded + per - 1) / per};
}

// The tiles first, first + step, ... of this CTA: every thread of the CTA
// calls it (it synchronises the CTA); `stage` holds blockDim.x floats of
// shared memory.
template <class Src, class Sink>
__device__ __forceinline__ void apply_tiles(const float* __restrict__ inv_t, const Tiling& tl,
                                            const Src& src, const Sink& sink, int64_t n,
                                            float* stage, int64_t first, int64_t step) {
  const int local = threadIdx.x;
  const int bs = tl.bs;
  for (int64_t tile = first; tile < tl.tiles; tile += step) {
    const int64_t g = tile * tl.per + local;
    const bool live = local < tl.per && g < n;
    const float w = live ? src.at(g) : 0.0f;
    stage[local] = w;
    __syncthreads();
    if (live) {
      const float* inv = inv_t + (g - tl.i) * bs + tl.i;  // block g / bs, column i
      const float* wb = stage + (local - tl.i);
      float acc = 0.0f;
      for (int k = 0; k < bs; ++k)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(inv + static_cast<int64_t>(k) * bs), wb[k]));
      sink(g, w, acc);
    }
    __syncthreads();
  }
}

}  // namespace bj
}  // namespace ogl
