// The staged body of the Ell level operator for Hopper: a level's A x with
// its columns and values brought into shared memory by bulk copies (tma.cuh)
// on mbarriers, the Ell phases of the device V-cycle (amg_loop.cuh).  It gives
// the bits of the register body (ell_rows.cuh `ell_row`): the same products
// and sums, rounded on their own, in the same order.
//
// A warp owns whole 32-row groups (the slot-major storage puts a group's slot
// k in one contiguous run: 128 B of columns and 64 B (bfloat16) or 128 B of
// values).  Lane 0 brings a chunk of up to S of the group's `warp_slots`
// slots into the warp's stage in shared memory (two buffers, two mbarriers),
// two copies per slot, and the chunk after it into the other buffer before
// the warp reads this one: the next chunk's column and value bytes are in
// flight while the lanes gather x.  Each row then issues the gathers of all
// of its chunk's slots at once (kEllSlots registers), where the register
// body issues four and waits for their column loads first.  S is sized on the
// host from the level's K and the shared memory the loop stages in
// (kernels/amg_loop.py `ell_stage_slots`); a group's rows past n are neither
// copied nor gathered.  Needs n % 4 == 0 (float values) or n % 8 == 0
// (bfloat16): a copy's size is a multiple of 16 bytes.
//
// Measured on the H100 (PERF.md rows 27-28): inside the device V-cycle, whose
// 512-thread blocks run two per SM, staging the Ell levels of the kNN-6
// hierarchy in chunks of 8 slots (48 KB per block) took 0.4464 ms per CG
// iteration against 0.4894 for the register body; chunks of 16 (96 KB) took
// 0.5989 against 0.5169, the shared memory taking L1 from the gathers of the
// other phases.  The standalone smoother (amg_ell_smooth.cu, full occupancy)
// ran 3-9% slower staged and keeps the register body.  Staged source windows
// of a Gdia level, tried the same way, lost both in the loop and alone and
// were taken out.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "amg_level.cuh"
#include "tma.cuh"

namespace ogl {
namespace stage {

constexpr int kEllSlots = 8;  // most slots of one chunk: a row's gathers in flight

// Bytes of one warp's Ell stage of S slots per buffer (two buffers).
template <typename T>
__host__ __device__ constexpr int ell_warp_bytes(int slots) {
  return 2 * slots * 32 * (4 + static_cast<int>(sizeof(T)));
}

// A warp's Ell stage: cols [2][S][32], vals [2][S][32] in shared memory, the
// two buffers' mbarriers, and `t`, the chunks this warp has consumed (the
// same in every lane; buffer t & 1, its use t >> 1).
template <typename T>
struct EllStage {
  int* cols;
  T* vals;
  uint64_t* bar;
  int slots;
  uint32_t t;
};

// The calling warp's stage in `smem` (one region per warp of the block) with
// its barriers bars[2 * warp], bars[2 * warp + 1].
template <typename T>
__device__ __forceinline__ EllStage<T> ell_stage_of(unsigned char* smem, uint64_t* bars,
                                                    int slots, uint32_t t) {
  const int warp = static_cast<int>(threadIdx.x >> 5);
  unsigned char* base = smem + static_cast<size_t>(warp) * ell_warp_bytes<T>(slots);
  return EllStage<T>{reinterpret_cast<int*>(base),
                     reinterpret_cast<T*>(base + 2 * slots * 32 * 4), bars + 2 * warp, slots, t};
}

// Lane 0: slots [k0, k0 + S) ∩ [k0, w) of group g into buffer `chunk` & 1.
template <typename T>
__device__ __forceinline__ void ell_issue(const EllOperandsOf<T>& m, const EllStage<T>& st,
                                          uint32_t chunk, int64_t g, int k0, int w, int64_t n) {
  const int b = static_cast<int>(chunk & 1);
  const int cnt = w - k0 < st.slots ? w - k0 : st.slots;
  const int64_t r0 = g << 5;
  const uint32_t rows = static_cast<uint32_t>(n - r0 < 32 ? n - r0 : 32);
  tma::fence_proxy_shared();  // the buffer's last reads were plain loads
  tma::arrive_expect_tx(st.bar + b,
                        cnt > 0 ? static_cast<uint32_t>(cnt) * rows * (4 + sizeof(T)) : 0u);
  for (int k = 0; k < cnt; ++k) {
    const int64_t at = static_cast<int64_t>(k0 + k) * n + r0;
    tma::copy(st.cols + (b * st.slots + k) * 32, m.cols + at, rows * 4, st.bar + b);
    tma::copy(st.vals + (b * st.slots + k) * 32, m.vals + at,
              rows * static_cast<uint32_t>(sizeof(T)), st.bar + b);
  }
}

// The warp's groups g0, g0 + gstep, ... below ceil(n / 32): for each, every
// lane's row i = 32 g + lane and its (A x)[i] (0 for a row at or past n) go
// to f(i, ax), called by every lane of the warp in group order.  The
// operands are read-only for the launch; src is read with its own loads.
template <typename T, class Src, class F>
__device__ __forceinline__ void ell_groups_staged(const EllOperandsOf<T>& m, EllStage<T>& st,
                                                  const Src& src, int64_t n, int64_t g0,
                                                  int64_t gstep, F&& f) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t groups = (n + 31) >> 5;
  if (g0 >= groups) return;
  int64_t g = g0;
  int k0 = 0;
  int w = __ldg(m.warp_slots + g);
  if (lane == 0) ell_issue(m, st, st.t, g, 0, w, n);
  float acc = 0.0f;
  for (;;) {
    int64_t gn = g;
    int kn = k0 + st.slots, wn = w;
    const bool group_done = kn >= w;
    if (group_done) {
      gn = g + gstep;
      kn = 0;
      wn = gn < groups ? __ldg(m.warp_slots + gn) : 0;
    }
    const bool more = gn < groups;
    // the other buffer was read by chunk t - 1, which ended at a __syncwarp
    if (more && lane == 0) ell_issue(m, st, st.t + 1, gn, kn, wn, n);
    const int b = static_cast<int>(st.t & 1);
    tma::wait(st.bar + b, (st.t >> 1) & 1u);
    const int cnt = w - k0 < st.slots ? w - k0 : st.slots;
    const int64_t i = (g << 5) + lane;
    const bool live = i < n;
    const int* c = st.cols + b * st.slots * 32 + lane;
    const T* v = st.vals + b * st.slots * 32 + lane;
    float gv[kEllSlots];
#pragma unroll
    for (int k = 0; k < kEllSlots; ++k) gv[k] = k < cnt && live ? src.at(c[k * 32]) : 0.0f;
#pragma unroll
    for (int k = 0; k < kEllSlots; ++k)
      if (k < cnt) acc = mul_add_rn(acc, to_f32(v[k * 32]), gv[k]);
    __syncwarp();
    ++st.t;
    if (group_done) {
      f(i, acc);
      acc = 0.0f;
    }
    if (!more) break;
    g = gn;
    k0 = kn;
    w = wn;
  }
}

}  // namespace stage
}  // namespace ogl
