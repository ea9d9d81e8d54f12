// The body of one Arnoldi step's orthogonalisation on Hopper: blocked
// modified Gram-Schmidt of w = A M^-1 v_j against the live basis rows
// V[0..j], in blocks of 8 rows (the 8 dots of a block against the same w,
// then w -= sum_b h_b V_b, then the next block; the reference's order,
// ogl_tpu/solve/gmres.py:264-301, no re-orthogonalisation), then ||w||_2 and
// V[j+1] = w / max(||w||, tiny) in the basis type (float32 or bfloat16; every
// sum in float32), h[0..j+1] into a device vector.  With a bfloat16 basis, w
// itself becomes the float32 v_{j+1}.
//
// It runs on a cooperative grid of one CTA per SM (kThreads threads: 16
// consumer warps and one producer warp) and works over the calling CTA's
// slice of the n entries, with the dynamic shared memory the caller hands
// it, carved as `carve` says: one GMRES step of a kernel of its own
// (gmres.cu) or the Arnoldi phase of a device loop.
//
// Bound: device-memory bandwidth.  The function reads the j + 1 live rows
// once and w once, and writes one row (bfloat16: and w).  What the design
// does about it:
//   * Each CTA owns one contiguous slice [r0, r0 + slice) (slice a multiple
//     of 8 entries, so every slice starts 16-byte aligned in both types) and
//     walks it in chunks of kConsumers * (2 or 1) entries: one step per
//     chunk, each consumer thread the same 2 (bfloat16) or 1 (float32)
//     entries of every chunk, so a thread only ever touches its own entries
//     of w and w needs no barrier of its own.  Pass p subtracts block p-1's
//     projection from w and forms block p's 8 dots against the updated w; a
//     grid barrier ends the pass; every CTA sums all partials in CTA order,
//     so every CTA holds the same bits of h.  The pass after the last block
//     forms ||w||^2.
//   * The basis rows arrive by bulk copies (tma.cuh), 2 KB per row and chunk,
//     issued by the producer warp (a lane per row) into shared memory; a
//     ring of `stages` steps completes on `full` mbarriers and is released
//     by the consumer warps on `empty` ones, so the copies run `stages`
//     steps ahead of the compute, across the grid barrier too: the next
//     pass's first chunks stream in while the barrier completes.  The last
//     slice's copies run into the row's padding (the row stride is a
//     multiple of 8 entries, at least n rounded up to 8), whose entries are
//     never used.
//   * Block p's first `resident` rows stay in shared memory until pass p+1
//     has subtracted them: a chunk lands in slot t mod (chunks + stages) of
//     the held region (t the step), and its slot is free again once the next
//     pass has subtracted it, `chunks` steps later.  The rows that are not
//     held pass through the ring: with `hint`, their first read keeps their
//     lines in L2 (evict_last), so the re-read comes from L2; the re-read,
//     their last, drops them (evict_first).  With no row held, odd passes
//     walk the chunks backwards: a pass starts on the chunks the previous
//     one read last, still in L2.
//   * With `w_resident`, w's slice stays in shared memory for the whole
//     step: read once at the start, written once at the end.  Otherwise each
//     step reads and writes the thread's own entries of w in device memory,
//     loaded one step ahead.
// The plan (ogl_tpu_torch/kernels/gmres.py `arnoldi_plan`) picks the slice,
// the held rows, the stages and w's residency for n, the basis type and the
// SMs; `smem_bytes` is its shared memory, at most kSmemMax.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "block_sum.cuh"
#include "tma.cuh"

namespace ogl {
namespace arnoldi {

constexpr int kRows = 8;           // basis rows per block of the blocked MGS
constexpr int kConsumers = 512;    // the threads that compute: 16 warps
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kPieceBytes = 2048;  // one row's share of a chunk: every bulk copy,
                                   // 4 bytes of each consumer thread
constexpr int kMaxStages = 8;
constexpr int kMaxCtas = 256;      // the most CTAs of a launch (one per SM)
constexpr int kFixedBytes = 1280;  // the barriers (128 B), the reduction scratch
constexpr int64_t kSmemMax = 232448;

struct Plan {
  int64_t slice;   // entries of each CTA's slice, a multiple of 8
  int chunk;       // entries of a step: kPieceBytes / the basis type's size
  int chunks;      // steps of a pass: ceil(slice / chunk)
  int resident;    // rows of a block held in shared memory across the barrier, 0..8
  int stages;      // steps whose copies are in flight, 2..kMaxStages
  int w_resident;  // w's slice held in shared memory
  int hint;        // evict_last on the first read of the rows that are not held
};

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The dynamic shared memory of a plan (elem: the basis type's bytes).
__host__ __device__ inline int64_t smem_bytes(const Plan& p, int elem) {
  const int64_t piece = static_cast<int64_t>(p.chunk) * elem;
  return kFixedBytes + (p.w_resident ? p.slice * 4 : 0) +
         static_cast<int64_t>(p.chunks + p.stages) * p.resident * piece +
         static_cast<int64_t>(p.stages) * 2 * (kRows - p.resident) * piece;
}

struct Smem {
  uint64_t* bars;       // [2][kMaxStages] mbarriers: full, then empty
  float* red;           // [kRows][32] warp sums
  float* tot;           // [kRows] the CTA's totals
  float* w;             // [slice] w's slice (w_resident)
  unsigned char* held;  // [chunks + stages][resident] pieces of held rows
  unsigned char* ring;  // [stages][2 * (8 - resident)] pieces: the new and the old rows not held
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Plan& p, int elem) {
  const int64_t piece = static_cast<int64_t>(p.chunk) * elem;
  Smem s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.red = reinterpret_cast<float*>(base + 128);
  s.tot = reinterpret_cast<float*>(base + 128 + kRows * 32 * 4);
  unsigned char* q = base + kFixedBytes;
  s.w = reinterpret_cast<float*>(q);
  if (p.w_resident) q += p.slice * 4;
  s.held = q;
  s.ring = q + static_cast<int64_t>(p.chunks + p.stages) * p.resident * piece;
  return s;
}

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}

// A thread's entries of a piece (at shared address `a`: the piece plus 4
// bytes per thread): 1 float32, or 2 bfloat16 as one 32-bit word, loaded as
// a raw word; decoded, the first m are kept, the rest are 0.
template <bool BF16>
struct Elem;

template <>
struct Elem<false> {
  using T = float;
  using Raw = float;
  static constexpr int kPer = 1;
  static __device__ __forceinline__ Raw load(uint32_t a) { return lds_f32(a); }
  static __device__ __forceinline__ void decode(Raw r, int m, float (&x)[1]) {
    x[0] = m > 0 ? r : 0.0f;
  }
  static __device__ __forceinline__ void put(float* row, int m, const float (&x)[1]) {
    if (m > 0) row[0] = x[0];
  }
};

template <>
struct Elem<true> {
  using T = __nv_bfloat16;
  using Raw = uint32_t;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ Raw load(uint32_t a) { return lds_u32(a); }
  static __device__ __forceinline__ void decode(Raw u, int m, float (&x)[2]) {
    x[0] = m > 0 ? __uint_as_float(u << 16) : 0.0f;
    x[1] = m > 1 ? __uint_as_float(u & 0xffff0000u) : 0.0f;
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* row, int m, const float (&x)[2]) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[0]));
    if (m > 1) {
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[1]));
      *reinterpret_cast<uint32_t*>(row) = lo | (hi << 16);
    } else {
      *reinterpret_cast<unsigned short*>(row) = static_cast<unsigned short>(lo);
    }
  }
};

// The CTA's sums of v[k] into out[k * gridDim.x + blockIdx.x]: warp sums,
// then warp k over them, in a fixed order.
template <int N>
__device__ __forceinline__ void cta_sums(const float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[k * 32 + warp] = s;
  }
  __syncthreads();
  if (warp < N) {
    const int warps = blockDim.x / 32;
    const float s = warp_sum(lane < warps ? red[warp * 32 + lane] : 0.0f);
    if (lane == 0) out[static_cast<int64_t>(warp) * gridDim.x + blockIdx.x] = s;
  }
}

// After the grid barrier: the sums over all CTAs' partials, warp k totalling
// sum k (each lane CTAs lane, lane + 32, ... in order, then the warp), so
// every CTA gets the same bits.
template <int N>
__device__ __forceinline__ void cta_totals(const float* part, float* tot, float (&out)[N]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ctas = gridDim.x;
  if (warp < N) {
    const float* p = part + static_cast<int64_t>(warp) * ctas;
    constexpr int kMax = (kMaxCtas + 31) / 32;
    float x[kMax];
#pragma unroll
    for (int i = 0; i < kMax; ++i) x[i] = lane + 32 * i < ctas ? p[lane + 32 * i] : 0.0f;
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < kMax; ++i) a += x[i];
    a = warp_sum(a);
    if (lane == 0) tot[warp] = a;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = tot[k];
}

// The next step whose copies the producer issues, advanced step by step (no
// division on the way).
struct Cursor {
  int pass = 0, k = 0, stage = 0, slot = 0;
  uint32_t parity = 0;  // of the stage's use
  __device__ __forceinline__ void advance(int chunks, int stages, int slots) {
    if (++k == chunks) {
      k = 0;
      ++pass;
    }
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
    }
    if (++slot == slots) slot = 0;
  }
};

// One Arnoldi step over the calling CTA's slice (every thread of every CTA
// of the cooperative grid calls it; blockDim.x == kThreads: kConsumers
// threads that compute, then one producer warp that issues the copies).
// partials holds 2 * 8 * gridDim.x floats, double-buffered by pass parity.
// A stage completes on its `full` barrier when its bytes have landed and is
// free again when each consumer warp has arrived on its `empty` barrier, so
// the warps do not wait for each other at every step.  Each step's
// bookkeeping is 32-bit and incremental, and the pieces are read with
// ld.shared at addresses formed once a step: the fixed cost of a step, paid
// by every consumer thread, is what a step of 2 KB pieces cannot afford.
template <bool BF16>
__device__ __forceinline__ void step(const typename Elem<BF16>::T* __restrict__ V, int64_t ld,
                                     float* __restrict__ w, typename Elem<BF16>::T* __restrict__ vnext,
                                     float* __restrict__ h, float* __restrict__ partials, int64_t n,
                                     int j, float tiny, const Plan& pl, unsigned char* smem,
                                     cooperative_groups::grid_group& grid) {
  using E = Elem<BF16>;
  using T = typename E::T;
  constexpr int kPer = E::kPer;
  constexpr uint32_t kElem = sizeof(T);
  const int tid = threadIdx.x;
  const bool producer = tid >= kConsumers;
  const Smem sm = carve(smem, pl, kElem);
  uint64_t* full = sm.bars;
  uint64_t* empty = sm.bars + kMaxStages;
  const int C = pl.chunk, NC = pl.chunks, D = pl.stages, R = pl.resident;
  const int slots = NC + D;  // held slots: a chunk's until the next pass subtracts it
  const uint32_t piece = static_cast<uint32_t>(C) * kElem;
  const uint32_t held_stride = static_cast<uint32_t>(R) * piece;
  const uint32_t ring_stride = 2u * (kRows - R) * piece;
  const uint32_t lane = 4u * tid;  // the thread's bytes in a piece
  const uint32_t s_held = tma::smem_addr(sm.held) + lane;
  const uint32_t s_ring = tma::smem_addr(sm.ring) + lane;
  const uint32_t s_w = tma::smem_addr(sm.w) + 4u * kPer * tid;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * pl.slice;
  const int64_t n8 = (n + 7) & ~static_cast<int64_t>(7);
  const int span = static_cast<int>(clamp64(n8 - r0, 0, pl.slice));  // what the copies cover
  const int lim = static_cast<int>(clamp64(n - r0, 0, pl.slice));     // the entries < n
  const int live = j + 1;
  const int nblk = (live + kRows - 1) / kRows;
  const int total = (nblk + 1) * NC;
  const bool back = R == 0;
  const T* vs = V + r0;
  float* ws = w + r0;
  T* vn = vnext + r0;

  if (tid == 0) {
    for (int s = 0; s < D; ++s) {
      tma::bar_init(full + s, 1);
      tma::bar_init(empty + s, kConsumers / 32);
    }
    tma::fence_init();
  }
  if (pl.w_resident && !producer) {
    for (int c = 0; c < NC; ++c) {
      const int off = c * C + kPer * tid;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (off + i < span) sm.w[off + i] = off + i < lim ? ws[off + i] : 0.0f;
    }
  }
  __syncthreads();

  float hp[kRows];  // h of the block the next pass subtracts
#pragma unroll
  for (int b = 0; b < kRows; ++b) hp[b] = 0.0f;
  float wnorm = 0.0f;
  if (producer) {
    // the copies of each step, lane b issuing one row's: block `pass`'s rows
    // for the dots, then the rows of block pass-1 that are not held, for the
    // subtraction; step t once the consumers have released step t - D
    const int pl_lane = tid - kConsumers;
    const uint64_t keep = tma::evict_last_policy(), drop = tma::evict_first_policy();
    Cursor q;
    int issued = 0;
    for (int pass = 0; pass <= nblk; ++pass) {
      for (const int upto = min((pass + 1) * NC + D, total); issued < upto; ++issued) {
        if (issued >= D && pl_lane == 0) tma::wait(empty + q.stage, q.parity ^ 1u);
        const int c = back && (q.pass & 1) ? NC - 1 - q.k : q.k;
        const int lo = c * C;
        const int len = min(max(span - lo, 0), C);
        const uint32_t bytes = static_cast<uint32_t>(len) * kElem;
        const int n_new = q.pass < nblk ? min(kRows, live - kRows * q.pass) : 0;
        const int n_old = q.pass > 0 ? max(0, min(kRows, live - kRows * (q.pass - 1)) - R) : 0;
        uint64_t* bar = full + q.stage;
        if (pl_lane == 0) tma::arrive_expect_tx(bar, bytes * static_cast<uint32_t>(n_new + n_old));
        __syncwarp();
        if (bytes > 0 && pl_lane < n_new + n_old) {
          unsigned char* ring = sm.ring + q.stage * ring_stride;
          if (pl_lane < n_new) {
            const int b = pl_lane;
            const T* src = vs + static_cast<int64_t>(kRows * q.pass + b) * ld + lo;
            if (b < R)
              tma::copy(sm.held + q.slot * held_stride + b * piece, src, bytes, bar);
            else if (pl.hint)
              tma::copy_hint(ring + (b - R) * piece, src, bytes, bar, keep);
            else
              tma::copy(ring + (b - R) * piece, src, bytes, bar);
          } else {
            const int b = pl_lane - n_new;  // row R + b of block pass-1
            const T* src = vs + static_cast<int64_t>(kRows * (q.pass - 1) + R + b) * ld + lo;
            tma::copy_hint(ring + (kRows - R + b) * piece, src, bytes, bar, drop);
          }
        }
        q.advance(NC, D, slots);
      }
      // the pass's sums: the producer warp adds zeros and keeps the barriers' count
      float* part = partials + static_cast<int64_t>(pass & 1) * kRows * gridDim.x;
      if (pass < nblk) {
        const float zeros[kRows] = {};
        cta_sums<kRows>(zeros, sm.red, part);
        grid.sync();
        cta_totals<kRows>(part, sm.tot, hp);
      } else {
        const float zero[1] = {0.0f};
        cta_sums<1>(zero, sm.red, part);
        grid.sync();
        float total_sq[1];
        cta_totals<1>(part, sm.tot, total_sq);
      }
    }
  } else {
    float wn[kPer];  // w in device memory: the next step's entries
    auto load_w = [&](int c, float (&x)[kPer]) {
      const int off = c * C + kPer * tid;
#pragma unroll
      for (int i = 0; i < kPer; ++i) x[i] = off + i < lim ? ws[off + i] : 0.0f;
    };
    if (!pl.w_resident) load_w(0, wn);
    int stage = 0, slot = 0;  // of step t
    uint32_t parity = 0;
    for (int pass = 0; pass <= nblk; ++pass) {
      const int n_new = pass < nblk ? min(kRows, live - kRows * pass) : 0;
      const int n_old = pass > 0 ? min(kRows, live - kRows * (pass - 1)) : 0;
      const bool rev = back && (pass & 1);
      float acc[kRows];
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[b] = 0.0f;
      float nrm = 0.0f;
      for (int k = 0; k < NC; ++k) {
        const int t = pass * NC + k;
        const int c = rev ? NC - 1 - k : k;
        const int off = c * C + kPer * tid;
        const int m = min(max(lim - off, 0), kPer);
        float wv[kPer];
        bool carry = false;
        if (pl.w_resident) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) wv[i] = i < m ? lds_f32(s_w + 4u * (c * C + i)) : 0.0f;
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) wv[i] = wn[i];
          if (t + 1 < total) {
            // the next step's chunk: the same one across a backward pass's turn
            const bool turn = k + 1 == NC;
            const int c1 = turn ? (back && !(pass & 1) ? NC - 1 : 0) : (rev ? c - 1 : c + 1);
            if (c1 != c)
              load_w(c1, wn);
            else
              carry = true;
          }
        }
        tma::wait(full + stage, parity);
        if (m > 0) {
          // every piece's word is loaded first (rows past the live ones read a
          // stale slot, masked below), then the sums
          const uint32_t ring = s_ring + stage * ring_stride;
          // the held rows of block pass-1 sit in slot (t - NC) mod slots = slot + D
          const int old_slot = slot + D < slots ? slot + D : slot + D - slots;
          const uint32_t held_old = s_held + old_slot * held_stride;
          const uint32_t rest_old = ring + (kRows - 2 * R) * piece;
          const uint32_t held_new = s_held + slot * held_stride;
          const uint32_t rest_new = ring - R * piece;
          typename E::Raw ro[kRows], rn[kRows];
          if (pass > 0) {
#pragma unroll
            for (int b = 0; b < kRows; ++b) ro[b] = E::load((b < R ? held_old : rest_old) + b * piece);
          }
          if (pass < nblk) {
#pragma unroll
            for (int b = 0; b < kRows; ++b) rn[b] = E::load((b < R ? held_new : rest_new) + b * piece);
          }
          // whole steps (every entry < n, every row of both blocks live) take
          // the instance without masks
          auto sums = [&](auto whole) {
            constexpr bool kWhole = decltype(whole)::value;
            const int mm = kWhole ? kPer : m;
            if (pass > 0) {
              float s[kPer];
#pragma unroll
              for (int i = 0; i < kPer; ++i) s[i] = 0.0f;
#pragma unroll
              for (int b = 0; b < kRows; ++b) {
                float x[kPer];
                E::decode(ro[b], kWhole || b < n_old ? mm : 0, x);
#pragma unroll
                for (int i = 0; i < kPer; ++i) s[i] += hp[b] * x[i];
              }
#pragma unroll
              for (int i = 0; i < kPer; ++i) {
                wv[i] -= s[i];
                if (i < mm) {
                  if (pl.w_resident)
                    sts_f32(s_w + 4u * (c * C + i), wv[i]);
                  else
                    ws[off + i] = wv[i];
                }
              }
            }
            if (pass < nblk) {
#pragma unroll
              for (int b = 0; b < kRows; ++b) {
                float x[kPer];
                E::decode(rn[b], kWhole || b < n_new ? mm : 0, x);
#pragma unroll
                for (int i = 0; i < kPer; ++i) acc[b] += x[i] * wv[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < kPer; ++i) nrm += wv[i] * wv[i];
            }
          };
          if (m == kPer && (pass == 0 || n_old == kRows) && (pass == nblk || n_new == kRows))
            sums(std::true_type());
          else
            sums(std::false_type());
        }
        if (carry) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) wn[i] = wv[i];
        }
        __syncwarp();  // the warp is done with step t's pieces
        if (tid % 32 == 0) tma::arrive(empty + stage);
        if (++stage == D) {
          stage = 0;
          parity ^= 1u;
        }
        if (++slot == slots) slot = 0;
      }
      float* part = partials + static_cast<int64_t>(pass & 1) * kRows * gridDim.x;
      if (pass < nblk) {
        cta_sums<kRows>(acc, sm.red, part);
        grid.sync();
        cta_totals<kRows>(part, sm.tot, hp);
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          if (b >= n_new) hp[b] = 0.0f;
          if (blockIdx.x == 0 && tid == b && b < n_new) h[kRows * pass + b] = hp[b];
        }
      } else {
        const float mine[1] = {nrm};
        cta_sums<1>(mine, sm.red, part);
        grid.sync();
        float total_sq[1];
        cta_totals<1>(part, sm.tot, total_sq);
        wnorm = sqrtf(total_sq[0]);
      }
    }
    const float den = fmaxf(wnorm, tiny);
    for (int c = 0; c < NC; ++c) {
      const int off = c * C + kPer * tid;
      const int m = min(max(lim - off, 0), kPer);
      if (m == 0) continue;
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float x = i < m ? (pl.w_resident ? sm.w[off + i] : ws[off + i]) : 0.0f;
        v[i] = __fdiv_rn(x, den);
      }
      E::put(vn + off, m, v);
      if (BF16) {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (i < m) ws[off + i] = v[i];
      }
    }
    if (blockIdx.x == 0 && tid == 0) h[live] = wnorm;
  }
  __syncthreads();  // every wait is over, every arrival made
  if (tid == 0)
    for (int s = 0; s < D; ++s) {
      tma::bar_inval(full + s);
      tma::bar_inval(empty + s);
    }
}

}  // namespace arnoldi
}  // namespace ogl
