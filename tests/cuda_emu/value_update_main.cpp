// Runs the value update's body (csrc/value_update.cuh) as a launch of
// csrc/value_update.cu runs it: one work item per decoded position and per
// written slot, the item ranges laid out as ogl_value_update lays them out.
// The body never synchronises and no item reads what another writes, so the
// items run one after another — in a shuffled order, so that a body whose
// items depended on each other's order would show it.
//
//   value_update_emu IN OUT
//
// IN: int32 n_sources, n_writes, seed; int64 flat_n; then per source int64
// size, int32 has_delta, has_out, size floats (old) and, with a delta, size
// uint16 (its bfloat16 bits); per write int32 block, has_src, has_dest,
// has_seg, int64 start, items, n_src, float scale, then n_src int32 (src),
// items int32 (dest), items + 1 int32 (seg), each where present; then
// flat_n floats (flat before the call).
// OUT: flat_n floats, then each source's decoded copy (size floats) where it
// has one.
#include <stdio.h>
#include <stdlib.h>

#include <algorithm>
#include <limits>
#include <random>
#include <vector>

#include "value_update.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;

namespace {

FILE* in;

template <class T>
std::vector<T> take(size_t count) {
  std::vector<T> out(count);
  if (count && fread(out.data(), sizeof(T), count, in) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return out;
}

template <class T>
T one() {
  return take<T>(1)[0];
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: value_update_emu IN OUT\n");
    return 2;
  }
  in = fopen(argv[1], "rb");
  const int n_sources = one<int>(), n_writes = one<int>(), seed = one<int>();
  const int64_t flat_n = one<int64_t>();
  std::vector<std::vector<float>> olds(n_sources), outs(n_sources);
  std::vector<std::vector<uint16_t>> deltas(n_sources);
  std::vector<std::vector<int>> srcs(n_writes), dests(n_writes), segs(n_writes);
  ogl::vu::Params P{};
  P.n_sources = n_sources;
  P.n_writes = n_writes;
  int64_t at = 0, offset = 0;
  for (int s = 0; s < n_sources; ++s) {
    const int64_t size = one<int64_t>();
    const int has_delta = one<int>(), has_out = one<int>();
    olds[s] = take<float>(size);
    if (has_delta) deltas[s] = take<uint16_t>(size);
    if (has_out) outs[s].assign(size, std::numeric_limits<float>::quiet_NaN());
    ogl::vu::Source& src = P.sources[s];
    src.old = olds[s].data();
    src.delta = has_delta ? deltas[s].data() : nullptr;
    src.out = has_out ? outs[s].data() : nullptr;
    src.size = size;
    src.offset = offset;
    offset += size;
    P.first[s] = at;
    if (has_out) at += size;
  }
  for (int k = 0; k < n_writes; ++k) {
    ogl::vu::Write& w = P.writes[k];
    w.block = one<int>();
    const int has_src = one<int>(), has_dest = one<int>(), has_seg = one<int>();
    w.start = one<int64_t>();
    w.items = one<int64_t>();
    const int64_t n_src = one<int64_t>();
    w.scale = one<float>();
    if (has_src) srcs[k] = take<int>(n_src);
    if (has_dest) dests[k] = take<int>(w.items);
    if (has_seg) segs[k] = take<int>(w.items + 1);
    w.src = has_src ? srcs[k].data() : nullptr;
    w.dest = has_dest ? dests[k].data() : nullptr;
    w.seg = has_seg ? segs[k].data() : nullptr;
    P.first[n_sources + k] = at;
    at += w.items;
  }
  P.first[n_sources + n_writes] = at;
  std::vector<float> flat = take<float>(flat_n);
  fclose(in);
  P.flat = flat.data();

  std::vector<int64_t> order(at);
  for (int64_t t = 0; t < at; ++t) order[t] = t;
  std::shuffle(order.begin(), order.end(), std::mt19937_64(seed));
  for (int64_t t : order) ogl::vu::update_item(P, t);

  FILE* out = fopen(argv[2], "wb");
  fwrite(flat.data(), sizeof(float), flat.size(), out);
  for (int s = 0; s < n_sources; ++s)
    if (!outs[s].empty()) fwrite(outs[s].data(), sizeof(float), outs[s].size(), out);
  fclose(out);
  return 0;
}
