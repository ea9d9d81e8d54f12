// The steady step's value update for Hopper: the resident LDU source blocks
// (with an uploaded bfloat16 delta decoded on the way) written into a
// container's flat value storage, any number of blocks in one launch.
//
// Replaces: no TPU kernel.  The reference runs the update as one jit'd XLA
// program per changed-block set (ogl_tpu/foam/solver.py `_apply_block_updates`,
// :483-529: a slice write per affine block, a scatter per other block, `take`
// through a symmetric block's src table), the full path's concat + gather +
// scatter (`_assemble_from_blocks`, `ValueMap.update`, ogl_tpu/core/
// formats.py:641-654) and the delta decode `_apply_delta` (:38-42).  In the
// port it also replaces torch.cat + index_select + zeros + a scatter (or
// `index_add_`, float atomics on the card, whose order changes from run to
// run, where slots take several entries).
//
// Bound: device-memory bandwidth.  Each written slot reads its entry's value
// and writes one float, plus 4 bytes per int32 table it reads (dest, src,
// seg); a decoded position reads 4 + 2 bytes and writes 4.
//
// Design: the body is csrc/value_update.cuh (why no item waits on another is
// said there); a grid-stride grid of 256-thread blocks walks the items of
// every range in turn, the block and write descriptors a __grid_constant__
// parameter, so the launch needs no table upload.
#include <cuda_runtime.h>
#include <stdint.h>

#include "value_update.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    value_update_kernel(const __grid_constant__ ogl::vu::Params P) {
  const int64_t total = P.first[P.n_sources + P.n_writes];
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += step)
    ogl::vu::update_item(P, t);
}

}  // namespace

// source_words: 5 int64 words per source block: old, delta (bfloat16 bits or
// 0), out (0 without a decoded copy), size, offset.  write_words: 6 words per
// write: src, dest, seg (each an int32 table or 0), start, items, block (-1:
// src over all blocks in order); scales: one float per write.  flat: the
// container's float32 values, written in place.  Launches `blocks` blocks of
// 256 threads on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ogl_value_update(const int64_t* source_words, int n_sources,
                                const int64_t* write_words, const float* scales, int n_writes,
                                float* flat, int64_t blocks, void* stream) {
  using ogl::vu::Params;
  if (n_sources < 0 || n_sources > ogl::vu::kMaxSources || n_writes < 0 ||
      n_writes > ogl::vu::kMaxWrites || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{};
  P.flat = flat;
  P.n_sources = n_sources;
  P.n_writes = n_writes;
  int64_t at = 0;
  for (int s = 0; s < n_sources; ++s) {
    const int64_t* w = source_words + 5 * s;
    ogl::vu::Source& src = P.sources[s];
    src.old = reinterpret_cast<const float*>(w[0]);
    src.delta = reinterpret_cast<const uint16_t*>(w[1]);
    src.out = reinterpret_cast<float*>(w[2]);
    src.size = w[3];
    src.offset = w[4];
    if (src.old == nullptr || src.size < 0 || (src.out != nullptr && src.delta == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    P.first[s] = at;
    if (src.out != nullptr) at += src.size;
  }
  for (int k = 0; k < n_writes; ++k) {
    const int64_t* w = write_words + 6 * k;
    ogl::vu::Write& wr = P.writes[k];
    wr.src = reinterpret_cast<const int*>(w[0]);
    wr.dest = reinterpret_cast<const int*>(w[1]);
    wr.seg = reinterpret_cast<const int*>(w[2]);
    wr.start = w[3];
    wr.items = w[4];
    wr.block = static_cast<int>(w[5]);
    wr.scale = scales[k];
    if (wr.items < 0 || wr.block < -1 || wr.block >= n_sources || flat == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    P.first[n_sources + k] = at;
    at += wr.items;
  }
  P.first[n_sources + n_writes] = at;
  if (at == 0) return 0;
  value_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
