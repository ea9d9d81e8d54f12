// The Xell band body, shared by the standalone SpMV and K1 (xell.cu), the K1
// phase of the persistent CG loop's Xell variants (xell_cg_loop.cu) and the
// two SpMV phases of the general-BiCGStab loop's Xell variants
// (bicgstab_gen_loop.cu), each over its own source functor, as dia_rows.cuh
// and gdia_k1.cuh serve the Dia and Gdia formats.
//
// Layout.  Destination row i = (tile*128 + t)*128 + l; for each slot k of
// its tile (main storage (nt, K, 128, 128), flat slot base
// S = (tile*K + k) * 16384):
//   v   = vals[S + t*128 + l]
//   b   = ll[S + t*128 + l]              (int8 source residue)
//   blk = bbT[S + b*128 + t]             (int16, transposed (residue, t)
//                                         order: indexed by the SOURCE
//                                         residue b, inside one 32 KB table)
//   j   = (tile*128 + blk - c_left*128)*128 + b
// then the row's spill entries s in [sp_ptr[i], sp_ptr[i+1]): source
// sp_cols[s], value sp_vals[sp_gidx[s]] (the gather index lets the value
// update write spill.vals in its own order).  Sources outside [0, n) read
// 0: padding slots (val 0, indices 0) decode to arbitrary j, where the TPU
// reads a zero-padded window.  The row's sum is
//   acc = sum over the slots in order of v * src(j), then the spill in
//         row-CSR order,
// every product and sum rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as the plain version's separate torch ops round
// (kernels/xell.py `xell_spmv_plain`: slot by slot, then index_add), so a
// row's sum is the plain version's bits when that runs on the CPU (on the
// card its index_add adds with atomics, in no fixed order).  sp_ptr ==
// NULL means no spill.
//
// Design: a band is 16 consecutive t of one tile (2,048 destination rows)
// and is walked by one block of 512 threads; a warp owns one t and each
// thread 4 consecutive lanes.  Per slot the block stages, with cp.async into
// a ring of kStages shared-memory stages, the band's vals (8 KB, one 16-byte
// copy per thread), its ll (2 KB) and its 128 x 16 slice of the slot's bbT
// table (4 KB: every 32-byte sector used whole and read once per band, where
// a warp of one-thread-per-row reads touched 32 sectors for 64 useful bytes
// and 8 blocks re-read each).  So the device bytes stream kStages - 1 slots
// ahead of the arithmetic, and the chain of three dependent reads per slot
// (ll, then bbT at the residue ll names, then the source at j) has its
// first two links in shared memory.  The bbT slice is stored with an odd
// stride of 9 words per residue, so the 32 random residues of a warp's
// lookups spread over the 32 banks.  The source gathers of slot k are issued
// before the products of slot k-1 are added, so each warp has a slot of
// gathers in flight across the block barrier.  The ragged last band (n not a
// multiple of 2,048) is read in full from the padded storage and masked at
// the spill and at the store.  The band is a parameter: the standalone
// kernels launch one block per band, the loops walk bands blockIdx.x,
// blockIdx.x + gridDim.x, ... on their co-resident grid, with a block
// barrier before every band but a block's first (the next prologue refills
// ring stages that slower warps may still be reading).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_rows.cuh"  // K1Source

namespace ogl {

constexpr int kBandT = 16;                       // t values per band
constexpr int kBandRows = kBandT * 128;          // 2,048 destination rows
constexpr int kBandThreads = kBandRows / 4;      // 512: 4 lanes per thread
constexpr int kStages = 4;                       // slots in the shared ring
constexpr int kRowWords = 9;                     // 16 int16 + 1 pad word
constexpr int kValsBytes = kBandRows * 4;        // 8,192
constexpr int kLlBytes = kBandRows;              // 2,048
constexpr int kBbBytes = 128 * kRowWords * 4;    // 4,608
constexpr int kStageBytes = kValsBytes + kLlBytes + kBbBytes;  // 14,848
constexpr int kRingBytes = kStages * kStageBytes;              // 59,392

// An Xell matrix as the band body reads it.
struct XellOperands {
  const float* vals;     // (nt, K, 128, 128), 16-byte aligned
  const int8_t* ll;      // the same shape, 16-byte aligned
  const int16_t* bbT;    // (nt, K, 128, 128) in (residue, t) order, 4-byte aligned
  int n_slots;           // K
  int c_left;
  const int* sp_ptr;     // the spill's row CSR (n + 1), or NULL: no spill
  const int* sp_cols;
  const int* sp_gidx;
  const float* sp_vals;
};

// Allow `kernel` the ring of dynamic shared memory, above the 48 KB default
// (before its occupancy query and its launch).
inline cudaError_t allow_ring(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage slot `plane` (= tile*K + k) of the band starting at row t0 of its
// tile: vals and ll as 16-byte copies, the bbT slice as 4-byte copies into
// the padded (residue, t) rows.
__device__ __forceinline__ void stage_slot(unsigned char* stage, const XellOperands& m,
                                           int64_t plane, int t0) {
  const int q = threadIdx.x;
  const int64_t band0 = (plane << 14) + t0 * 128;
  cp_async16(stage + 16 * q, m.vals + band0 + 4 * q);
  if (q < kLlBytes / 16) cp_async16(stage + kValsBytes + 16 * q, m.ll + band0 + 16 * q);
  uint32_t* bb = reinterpret_cast<uint32_t*>(stage + kValsBytes + kLlBytes);
  const int16_t* table = m.bbT + (plane << 14) + t0;
#pragma unroll
  for (int c = q; c < 128 * 8; c += kBandThreads) {
    const int b = c >> 3, w = c & 7;
    cp_async4(bb + b * kRowWords + w, table + b * 128 + 2 * w);
  }
}

// The first of the 4 rows of this thread in `band`.
__device__ __forceinline__ int64_t band_row0(int64_t band) {
  return (band << 11) + 4 * static_cast<int64_t>(threadIdx.x);
}

// The sources of the band body: a struct with `float at(int64_t j) const`,
// the source at row j (0 <= j < n).
// The SpMV's: x[j], read-only for the whole launch.
struct XellLdgSource {
  const float* x;
  __device__ __forceinline__ float at(int64_t j) const { return __ldg(x + j); }
};

// The band's sums for the thread's 4 rows i0..i0+3 (i0 = band_row0(band):
// slots, then the spill of the rows < n): acc[e] for row i0 + e.  Every
// thread of the block must call it (it holds block barriers); no copy is
// left in flight when it returns.
template <class Src>
__device__ __forceinline__ void band_apply(const XellOperands& m, const Src& src, int64_t n,
                                           unsigned char* ring, int64_t band, float (&acc)[4]) {
  const int64_t tile = band >> 3;
  const int t0 = static_cast<int>(band & 7) * kBandT;
  const int q = threadIdx.x;
  const int tt = q >> 5;  // the warp's t within the band
  const int n_slots = m.n_slots;
  const int64_t plane0 = tile * n_slots;
  const int64_t base = (tile - m.c_left) * 16384;  // j = base + blk*128 + b

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slots) stage_slot(ring + s * kStageBytes, m, plane0 + s, t0);
    cp_async_commit();
  }
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // slot k-1's values
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // and its gathered sources
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
  for (int k = 0; k < n_slots; ++k) {
    cp_async_wait<kStages - 2>();  // slot k's copies of this thread landed
    __syncthreads();               // everyone's, and stage k-1 is free
    const int kn = k + kStages - 1;
    if (kn < n_slots) stage_slot(ring + (kn % kStages) * kStageBytes, m, plane0 + kn, t0);
    cp_async_commit();
    if (k > 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], g[e]));
    }
    const unsigned char* stage = ring + (k % kStages) * kStageBytes;
    const float4 v4 = reinterpret_cast<const float4*>(stage)[q];
    const uint32_t r = reinterpret_cast<const uint32_t*>(stage + kValsBytes)[q];
    const int16_t* tab = reinterpret_cast<const int16_t*>(stage + kValsBytes + kLlBytes);
    v[0] = v4.x;
    v[1] = v4.y;
    v[2] = v4.z;
    v[3] = v4.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = (r >> (8 * e)) & 127;
      const int64_t j = base + static_cast<int64_t>(tab[b * (2 * kRowWords) + tt]) * 128 + b;
      g[e] = (j >= 0 && j < n) ? src.at(j) : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], g[e]));
  cp_async_wait<0>();  // no copy outlives the band (the trailing groups are empty)
  if (m.sp_ptr != nullptr) {
    const int64_t i0 = band_row0(band);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t i = i0 + e;
      if (i < n) {
        const int end = __ldg(m.sp_ptr + i + 1);
        for (int s = __ldg(m.sp_ptr + i); s < end; ++s)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(__ldg(m.sp_vals + __ldg(m.sp_gidx + s)),
                                               src.at(__ldg(m.sp_cols + s))));
      }
    }
  }
}

// K1's epilogue for the rows i0..i0+3 of a band: p' (recomputed from z and
// p, as at every source) and q = acc stored for the rows below n, as one
// float4 each when `vec` (z, p, pout and q 16-byte aligned) and the quad
// lies below n; returns the quad's sum of p' * q.
template <bool kLdg>
__device__ __forceinline__ float band_k1_store(const K1Source<kLdg>& src,
                                               const float (&acc)[4], float* pout, float* q,
                                               int64_t i0, int64_t n, int vec) {
  if (vec && i0 + 3 < n) {
    float4 zv, pv;
    if constexpr (kLdg) {
      zv = __ldg(reinterpret_cast<const float4*>(src.z + i0));
      pv = __ldg(reinterpret_cast<const float4*>(src.p + i0));
    } else {
      zv = *reinterpret_cast<const float4*>(src.z + i0);
      pv = *reinterpret_cast<const float4*>(src.p + i0);
    }
    const float b = src.beta;
    const float4 pw = make_float4(
        __fadd_rn(zv.x, __fmul_rn(b, pv.x)), __fadd_rn(zv.y, __fmul_rn(b, pv.y)),
        __fadd_rn(zv.z, __fmul_rn(b, pv.z)), __fadd_rn(zv.w, __fmul_rn(b, pv.w)));
    *reinterpret_cast<float4*>(pout + i0) = pw;
    *reinterpret_cast<float4*>(q + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return pw.x * acc[0] + pw.y * acc[1] + pw.z * acc[2] + pw.w * acc[3];
  }
  float dot = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = i0 + e;
    if (i < n) {
      const float pc = src.at(i);
      pout[i] = pc;
      q[i] = acc[e];
      dot += pc * acc[e];
    }
  }
  return dot;
}

}  // namespace ogl
