// Exact substitution of the ILU family's apply for Hopper (`triSolve
// exact`), with no grid barrier: every row waits on ready words of its own
// sources, written by the rows that computed them,
//   x[i] = (b[i] - sum_j F[i, j] * x[j]) * d[i],
// first over the lower factor (b = r, into z), then over the upper one
// (b = z, into out).
//
// Positions.  Each factor comes in level order (`LevelRows`, built once by
// kernels/tri_solve.py `level_layout`): position p holds row rows[p], the
// rows level after level, ascending within a level; its entries, in the
// row's own entry order, sit at [ptr[p], ptr[p + 1]), each source named by
// its position; d is in position order too.  A row's level is 0 without
// entries, else 1 + the largest level of its sources (precond/ilu.py
// `factor_levels`), so every source sits at an earlier position.  The 2n
// positions of both factors form one list, the lower factor's first; an
// upper row also waits on the lower row of its own index (its b = z[i]).
// Position p belongs to thread p mod S of the S threads of the grid, taken
// in rounds (p, p + S, ...); the threads of a warp take neighbouring
// positions, so their loads of a position's layout are contiguous.
//
// A thread's rounds are pipelined: the layout of its position two rounds
// ahead is loaded, and the entries of the next one, while it waits on the
// sources of the current one.  A row: the ready words of its sources (B at
// once: 4 where no row has more, which leaves registers for more threads,
// else 16) and, on the upper factor, the lower word of its row are loaded
// and, while some are not yet of this apply's epoch, loaded again
// (`gather_ready`); then the row's sum in entry order and tri_sweep.cuh's
// `finish` (the arithmetic of kernel 1, so a row's bits are those of kernel
// 1 run to the factor's depth), and its own word is published.
//
// Ready words: a row's value and the epoch of the apply that wrote it in
// one 64-bit word per position, stored and loaded at device scope (relaxed:
// single-copy atomic, so the value comes with its epoch and no fence orders
// two stores; a flag beside the value, released and acquired, costs one more
// L2 round trip per dependent hop: PERF.md §6, row 26).  The wrapper passes an
// epoch that rises with every apply of the factors; a word is ready when
// its epoch equals it, so no apply clears the words (the wrapper zeroes them
// once, and again when the epoch wraps).
//
// Progress.  The first unfinished position always progresses: its sources
// are at earlier positions, so finished; its thread has finished its earlier
// positions; every thread is resident (a cooperative launch); and the
// threads of one warp that wait on each other's rows rely on Hopper's
// independent thread scheduling (each lane polls on its own; no warp-wide
// step is assumed).  A wait longer than `limit_ns` cannot be legal (a
// broken layout, a row placed before its source): it traps, so the launch
// ends with an error and never returns wrong bits or hangs.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_sweep.cuh"  // finish, mul_add_rn
#include "tri_sync.cuh"

namespace ogl {
namespace tri {

// One factor in level order; read-only for the launch.
struct LevelRows {
  const int* ptr;     // (n + 1,) entry offsets by position
  const int* src;     // (nnz,) each entry's source position
  const float* vals;  // (nnz,)
  const int* rows;    // (n,) the row at each position
  const int* inv;     // (n,) the position of each row
  const float* d;     // (n,) the scale by position, or null
};

// How long a thread waits on a word: backoff and the trap's bound.
struct Patience {
  uint32_t sleep_ns;  // the longest __nanosleep between polls (0: none)
  uint64_t limit_ns;  // a wait this long traps
};

__device__ __forceinline__ bool ready(uint64_t w, uint32_t epoch) {
  return static_cast<uint32_t>(w >> 32) == epoch;
}

__device__ __forceinline__ float word_value(uint64_t w) {
  return __uint_as_float(static_cast<uint32_t>(w));
}

// A position's layout, loaded before anything is waited on: stage A (its
// row, entry range and scale), stage B (its first block of B entries, b of
// a lower row, the lower position of an upper row).
template <int B>
struct Staged {
  int row, begin, end, zpos;
  float d, b;
  int c[B];
  float v[B];
};

template <int B>
__device__ __forceinline__ void stage_a(const LevelRows& f, int64_t q, Staged<B>& s) {
  s.row = __ldg(f.rows + q);
  s.begin = __ldg(f.ptr + q);
  s.end = __ldg(f.ptr + q + 1);
  s.d = f.d ? __ldg(f.d + q) : 1.0f;
}

template <int B>
__device__ __forceinline__ void stage_b(const LevelRows& f, bool upper, const int* lo_inv,
                                        const float* r, Staged<B>& s) {
  s.zpos = upper ? __ldg(lo_inv + s.row) : 0;
  s.b = upper ? 0.0f : __ldg(r + s.row);
#pragma unroll
  for (int e = 0; e < B; ++e) {
    s.c[e] = s.begin + e < s.end ? __ldg(f.src + s.begin + e) : 0;
    s.v[e] = s.begin + e < s.end ? __ldg(f.vals + s.begin + e) : 0.0f;
  }
}

// g[e] = the values of the block's sources c[0..m) in `words` (and *b = the
// value of zword, when given), once every one is of this epoch: every
// pending word is loaded again each round, so the last source to be ready is
// seen one load after it is published, with __nanosleep backoff between
// rounds; a wait beyond the patience (timed from the 64th round, so a short
// wait never reads the clock) traps.
template <int B>
__device__ __forceinline__ void gather_ready(const uint64_t* words, const int (&c)[B], int m,
                                             float (&g)[B],
                                             const uint64_t* zword, float* b, uint32_t epoch,
                                             const Patience& pat) {
  uint64_t t[B];
#pragma unroll
  for (int e = 0; e < B; ++e)
    if (e < m) t[e] = load_relaxed(words + c[e]);
  uint64_t zt = zword ? load_relaxed(zword) : 0;
  uint64_t start = 0;
  uint32_t nap = 0;
  for (uint32_t polls = 1;; ++polls) {
    bool pending = zword && !ready(zt, epoch);
#pragma unroll
    for (int e = 0; e < B; ++e) pending |= e < m && !ready(t[e], epoch);
    if (!pending) break;
    if (pat.sleep_ns) {
      nap = nap == 0 ? (pat.sleep_ns < 32 ? pat.sleep_ns : 32)
                     : (2 * nap < pat.sleep_ns ? 2 * nap : pat.sleep_ns);
      __nanosleep(nap);
    }
#pragma unroll
    for (int e = 0; e < B; ++e)
      if (e < m && !ready(t[e], epoch)) t[e] = load_relaxed(words + c[e]);
    if (zword && !ready(zt, epoch)) zt = load_relaxed(zword);
    if ((polls & 63) == 0) {
      const uint64_t now = clock_ns();
      if (start == 0)
        start = now;
      else if (now - start > pat.limit_ns)
        __trap();
    }
  }
#pragma unroll
  for (int e = 0; e < B; ++e)
    if (e < m) g[e] = word_value(t[e]);
  if (zword) *b = word_value(zt);
}

// The row at position q of factor f (own words `words`; upper: b from the
// lower words at s.zpos) from its staged layout; publishes it and returns
// it.  Entries beyond the first block are loaded here, a block at a time.
template <int B>
__device__ __forceinline__ float level_row(const LevelRows& f, const Staged<B>& s, int64_t q,
                                           uint64_t* words, const uint64_t* lo_words, bool upper,
                                           uint32_t epoch, const Patience& pat) {
  float b = s.b, acc = 0.0f, g[B];
  const int m = s.end - s.begin < B ? s.end - s.begin : B;
  gather_ready(words, s.c, m, g, upper ? lo_words + s.zpos : nullptr, &b, epoch, pat);
#pragma unroll
  for (int e = 0; e < B; ++e)
    if (e < m) acc = mul_add_rn(acc, s.v[e], g[e]);
  for (int j0 = s.begin + B; j0 < s.end; j0 += B) {
    int c[B];
    float v[B];
    const int mm = s.end - j0 < B ? s.end - j0 : B;
#pragma unroll
    for (int e = 0; e < B; ++e) {
      c[e] = e < mm ? __ldg(f.src + j0 + e) : 0;
      v[e] = e < mm ? __ldg(f.vals + j0 + e) : 0.0f;
    }
    gather_ready(words, c, mm, g, nullptr, nullptr, epoch, pat);
#pragma unroll
    for (int e = 0; e < B; ++e)
      if (e < mm) acc = mul_add_rn(acc, v[e], g[e]);
  }
  const float x = finish(b, acc, f.d != nullptr, s.d);
  store_relaxed(words + q, (static_cast<uint64_t>(epoch) << 32) | __float_as_uint(x));
  return x;
}

// The whole exact apply over the positions first, first + stride, ... of
// the 2n (lower factor lo into lo_words, upper factor up into up_words and
// out, both by position), pipelined two rounds deep.
template <int B>
__device__ __forceinline__ void level_apply(const LevelRows& lo, uint64_t* lo_words,
                                            const LevelRows& up, uint64_t* up_words,
                                            const float* r, float* out, int64_t n,
                                            uint32_t epoch, Patience pat, int64_t first,
                                            int64_t stride) {
  const int64_t total = 2 * n;
  Staged<B> cur, nxt, far;
  const auto a = [&](int64_t p, Staged<B>& s) {
    stage_a(p < n ? lo : up, p < n ? p : p - n, s);
  };
  const auto b = [&](int64_t p, Staged<B>& s) {
    stage_b(p < n ? lo : up, p >= n, lo.inv, r, s);
  };
  if (first < total) {
    a(first, cur);
    b(first, cur);
  }
  if (first + stride < total) a(first + stride, nxt);
  for (int64_t p = first; p < total; p += stride) {
    const bool upper = p >= n;
    if (p + 2 * stride < total) a(p + 2 * stride, far);
    if (p + stride < total) b(p + stride, nxt);
    const float x = level_row(upper ? up : lo, cur, upper ? p - n : p,
                              upper ? up_words : lo_words, lo_words, upper, epoch, pat);
    if (upper) out[cur.row] = x;
    cur = nxt;
    nxt = far;
  }
}

}  // namespace tri
}  // namespace ogl
