// Kernel 2 of the ILU family's apply (`triSolve exact`): forward and
// backward substitution over both triangular factors as ONE cooperative
// launch per preconditioner apply, with no grid barrier: each row waits on
// ready words of its sources (the body tri_levels.cuh `level_apply`).
//
// Replaces no TPU kernel: the reference runs its sweep (XLA ops over the
// factors' fast-format SpMV) to the factor's dependency depth
// (ogl_tpu/precond/ilu.py:17-28, 45-62).  Plain twin: `tri_levels_plain` in
// ogl_tpu_torch/kernels/tri_solve.py, bit-equal, and bit-equal to kernel 1
// (tri_sweep.cu) run to the depth.
//
// Bound: each factor, r, d and the result move once (the bytes of one
// sweep), but the rows depend on each other: the time is at least the
// dependency depth (L's levels + U's, 636 on the 128x128x64 grid's IC(0))
// times one dependent hop: a row's sources read from L2, its sum, its word
// written back and seen by the next row's poll.
//
// Design: a persistent grid with blocks on every SM, sized by the wrapper
// from the factors' mean rows per level (`level_launch`, measured on the
// card: on narrow levels fewer threads poll L2, on wide ones more threads
// take rows); each factor in level order, its sources named by position
// (tri_solve.py `level_layout`, built once per factor); the 2n positions
// (L's, then U's) dealt to the threads in rounds, each thread loading its
// next positions' layout while it waits; a row waits only on its own
// sources' words, so rows of many levels are in flight at once and no
// thread waits on a whole level.  Two instances: a row's words loaded 4 at
// a time (68 registers, for factors of at most 4 entries a row) or 16 at a
// time (193).
#include <cuda_runtime.h>
#include <stdint.h>

#include "loop.cuh"
#include "tri_levels.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads per block a launch takes

// B: the entries of a row whose words a thread loads at once (4 or 16).
template <int B>
__global__ void __launch_bounds__(kThreads)
    tri_levels_kernel(ogl::tri::LevelRows lo, uint64_t* lo_words, ogl::tri::LevelRows up,
                      uint64_t* up_words, const float* r, float* out, int64_t n, uint32_t epoch,
                      ogl::tri::Patience pat) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  ogl::tri::level_apply<B>(lo, lo_words, up, up_words, r, out, n, epoch, pat, first, stride);
}

const void* levels_kernel(int block) {
  return block == 4    ? reinterpret_cast<const void*>(&tri_levels_kernel<4>)
         : block == 16 ? reinterpret_cast<const void*>(&tri_levels_kernel<16>)
                       : nullptr;
}

}  // namespace

// The co-resident blocks of `threads` (32..256, a multiple of 32) of the
// level kernel of `block` entries (4 or 16) on the current device
// (occupancy x SMs).
extern "C" int ogl_tri_levels_grid(int block, int threads, int64_t* blocks) {
  if (threads < 32 || threads > kThreads || threads % 32 != 0 || levels_kernel(block) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(levels_kernel(block), threads, blocks);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: out =
// the exact apply of the two strict factors to r.  Each factor in level
// order (tri_solve.py `level_layout`): *_ptr (n + 1,) entry offsets by
// position, *_src and *_vals (nnz,) each entry's source position and value,
// *_rows (n,) the row at each position, *_inv (n,) each row's position,
// *_d (n,) the scale by position (null: none).  l_words and u_words (n
// 64-bit words each, zeroed before the first apply of the factor and
// whenever the epoch restarts) are the factors' ready words by position;
// `epoch` (1 .. 2^32 - 1) is higher than that of every earlier apply since
// the words were zeroed.  A wait longer than limit_ns traps; sleep_ns is the
// longest backoff between polls; `block` (4 or 16) the entries of a row whose
// words a thread loads at once.  Returns the launch's error code (0 =
// launched).
extern "C" int ogl_tri_levels(const int* l_ptr, const int* l_src, const float* l_vals,
                              const int* l_rows, const int* l_inv, const float* l_d,
                              const int* u_ptr, const int* u_src, const float* u_vals,
                              const int* u_rows, const int* u_inv, const float* u_d,
                              const float* r, float* out, uint64_t* l_words, uint64_t* u_words,
                              int64_t epoch, int sleep_ns, int64_t limit_ns, int block,
                              int64_t n, int threads, int64_t blocks, void* stream) {
  if (n < 1 || blocks < 1 || blocks > INT32_MAX || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || epoch < 1 || epoch > UINT32_MAX || sleep_ns < 0 || limit_ns < 1 ||
      l_ptr == nullptr || u_ptr == nullptr || l_rows == nullptr || u_rows == nullptr ||
      l_inv == nullptr || u_inv == nullptr || r == nullptr || out == nullptr ||
      l_words == nullptr || u_words == nullptr || l_words == u_words ||
      ogl::misaligned(l_words, 8) || ogl::misaligned(u_words, 8) ||
      levels_kernel(block) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ogl::tri::LevelRows lo{l_ptr, l_src, l_vals, l_rows, l_inv, l_d};
  ogl::tri::LevelRows up{u_ptr, u_src, u_vals, u_rows, u_inv, u_d};
  uint32_t e = static_cast<uint32_t>(epoch);
  ogl::tri::Patience pat{static_cast<uint32_t>(sleep_ns), static_cast<uint64_t>(limit_ns)};
  void* args[] = {&lo, &l_words, &up, &u_words, &r, &out, &n, &e, &pat};
  return ogl::coop_launch(levels_kernel(block), blocks, threads, args, stream);
}
