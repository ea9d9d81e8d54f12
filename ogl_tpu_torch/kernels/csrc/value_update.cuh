// The body of the steady step's value update (csrc/value_update.cu): one
// work item per decoded block position and per written container slot, so
// that one launch applies any number of blocks.
//
//   decode  out[p]  = old[p] + float(delta[p])        (uploadPrecision bfloat16)
//   write   flat[slot] = scale · value(entry)          (one entry per slot)
//           flat[slot] = Σ scale · value(e), e ascending, from 0   (a slot of
//                        several entries: a cyclic interface on a face's slot)
//
// value(e) reads the resident block at the entry's source position; where the
// block came with a bfloat16 delta it reads old + float(delta) there itself,
// the very sum the decode writes.  So no item reads what another writes:
// the decoded copy goes to a buffer of its own (`out`), and the gathers of a
// symmetric matrix's upper block, which feeds both triangles, never see a
// position half decoded — no second pass, no grid barrier, any item order.
// The slot sums add in ascending entry order from tables sorted once by
// slot (core/formats.py `accumulate_plan`), with no float atomics: the same
// bits on every run.  Every product and sum is rounded on its own, as the
// plain twin (kernels/value_update.py `value_update_plain`) rounds them.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl::vu {

constexpr int kMaxSources = 8;
constexpr int kMaxWrites = 8;
constexpr int kRanges = kMaxSources + kMaxWrites;

// one resident source block
struct Source {
  const float* old;        // the resident values (read only)
  const uint16_t* delta;   // bfloat16 bits of an uploaded delta, or null
  float* out;              // with a delta: old + delta written here, or null
  int64_t size;            // positions
  int64_t offset;          // its first position among the blocks in order
};

// one write into the container's flat values
struct Write {
  const int* src;   // entry -> source position; null: the entry's own index
  const int* dest;  // item -> slot; null: start + item
  const int* seg;   // item -> entries seg[item] .. seg[item + 1] - 1; null: entry = item
  int64_t start;
  int64_t items;
  float scale;
  int block;  // its source block, or -1: src names positions over all blocks in order
};

struct Params {
  Source sources[kMaxSources];
  Write writes[kMaxWrites];
  // item ranges: the decode of each source (empty without delta and out),
  // then each write; range r holds items first[r] .. first[r + 1] - 1
  int64_t first[kRanges + 1];
  float* flat;
  int n_sources;
  int n_writes;
};

__device__ __forceinline__ float widen_bf16(uint16_t bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ float source_value(const Source& s, int64_t p) {
  const float v = s.old[p];
  return s.delta != nullptr ? __fadd_rn(v, widen_bf16(s.delta[p])) : v;
}

__device__ __forceinline__ float entry_value(const Params& P, const Write& w, int64_t e) {
  const int64_t p = w.src != nullptr ? static_cast<int64_t>(w.src[e]) : e;
  if (w.block >= 0) return source_value(P.sources[w.block], p);
  int b = 0;
  while (b + 1 < P.n_sources && p >= P.sources[b + 1].offset) ++b;
  return source_value(P.sources[b], p - P.sources[b].offset);
}

// the work of item t, 0 <= t < first[n_sources + n_writes]
__device__ __forceinline__ void update_item(const Params& P, int64_t t) {
  const int ranges = P.n_sources + P.n_writes;
  int r = 0;
  while (r + 1 < ranges && t >= P.first[r + 1]) ++r;
  const int64_t k = t - P.first[r];
  if (r < P.n_sources) {
    const Source& s = P.sources[r];
    s.out[k] = __fadd_rn(s.old[k], widen_bf16(s.delta[k]));
    return;
  }
  const Write& w = P.writes[r - P.n_sources];
  const int64_t slot = w.dest != nullptr ? static_cast<int64_t>(w.dest[k]) : w.start + k;
  if (w.seg == nullptr) {
    P.flat[slot] = __fmul_rn(w.scale, entry_value(P, w, k));
    return;
  }
  float acc = 0.0f;
  const int64_t end = w.seg[k + 1];
  for (int64_t e = w.seg[k]; e < end; ++e)
    acc = __fadd_rn(acc, __fmul_rn(w.scale, entry_value(P, w, e)));
  P.flat[slot] = acc;
}

}  // namespace ogl::vu
