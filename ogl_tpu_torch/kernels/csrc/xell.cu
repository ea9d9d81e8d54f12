// Xell SpMV and merged-CG K1 for Hopper, with the COO spill tail applied
// in-kernel.  Destination row i = (tile*128 + t)*128 + l; for each slot k
// of its tile (main storage (nt, K, 128, 128), flat slot base
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
// reads a zero-padded window.
//   SpMV:  y[i] = sum of v * x[j] over the slots, then the spill
//   K1:    p'[i] = z[i] + beta*p[i];  q[i] = the same sum over p';
//          partials[block] = sum over the block's rows of p'[i]*q[i]
// so q and delta include the spill, as the reference's in-kernel spill makes
// them.  Both accumulate in float32, slots in order and then the spill in
// row order (the plain version's order).  sp_ptr == NULL means no spill.
//
// Replaces: ogl_tpu/kernels/xell.py `_xell_kernel` (`_xell_padded`,
// `xell_matvec`), `_k1x_kernel` (`XellCgKernels.k1`, and `apply` = K1 with
// z = p = x, beta = 0), and the helper `_spill_corr` inside both.  The TPU
// kernels stream (tile, slot) planes through VMEM, cross two in-register
// lane gathers with MXU identity-matmul transposes and apply the spill as
// one-hot MXU matmuls, because a TPU has no fast gather; the GPU gathers
// x[j] directly and the spill is a short per-row loop.
//
// Bound: device-memory bytes, and the latency of a chain of three
// dependent reads per slot (ll, then bbT at the residue ll names, then
// x[j]).  Minimum traffic per row: K*(4 + 1 + 2) bytes of slots + x in and
// y out = K*7 + 8 bytes, plus 12 bytes per spill entry and 4 for sp_ptr.
//
// SpMV design (xell_band_kernel): one block owns a band of 16 consecutive
// t of one tile (2,048 destination rows, 512 threads); a warp owns one t
// and each thread 4 consecutive lanes.  Per slot the block stages, with
// cp.async into a ring of kStages shared-memory stages, the band's vals
// (8 KB, one 16-byte copy per thread), its ll (2 KB) and its 128 x 16
// slice of the slot's bbT table (4 KB: every 32-byte sector used whole and
// read once per band, where a warp of one-thread-per-row reads touched 32
// sectors for 64 useful bytes and 8 blocks re-read each).  So the device
// bytes stream kStages - 1 slots ahead of the arithmetic, and the chain's
// first two links are shared-memory reads.  The bbT slice is stored with
// an odd stride of 9 words per residue, so the 32 random residues of a
// warp's lookups spread over the 32 banks.  The x gathers (__ldg) of slot k
// are issued before the products of slot k-1 are added, so each warp has
// a slot of gathers in flight across the block barrier.  y goes out as one
// float4 per thread.  The ragged last band (n not a multiple of 2,048) is
// read in full from the padded storage and masked at the spill and the
// store.  `band_apply` takes the source as a functor (x[j] here), so a K1
// can adopt the same apply with z[j] + beta*p[j].
//
// K1 design (xell_k1_kernel, unchanged since the port's first Xell kernel):
// one thread per row, coalesced slot streams and outputs; K1 recomputes
// z[j] + beta*p[j] at every source (no read-back of p' across blocks; z and
// p may alias); beta through a device pointer; one float32 partial per
// block (no atomics); int64 indices.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kBandT = 16;                       // t values per band
constexpr int kBandRows = kBandT * 128;          // 2,048 destination rows
constexpr int kBandThreads = kBandRows / 4;      // 4 lanes per thread
constexpr int kStages = 4;                       // slots in the shared ring
constexpr int kRowWords = 9;                     // 16 int16 + 1 pad word
constexpr int kValsBytes = kBandRows * 4;        // 8,192
constexpr int kLlBytes = kBandRows;              // 2,048
constexpr int kBbBytes = 128 * kRowWords * 4;    // 4,608
constexpr int kStageBytes = kValsBytes + kLlBytes + kBbBytes;  // 14,848
constexpr int kRingBytes = kStages * kStageBytes;              // 59,392

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage slot `plane` (= tile*K + k) of the band starting at row t0 of its
// tile: vals and ll as 16-byte copies, the bbT slice as 4-byte copies into
// the padded (residue, t) rows.
__device__ __forceinline__ void stage_slot(unsigned char* stage,
                                           const float* __restrict__ vals,
                                           const int8_t* __restrict__ ll,
                                           const int16_t* __restrict__ bbT,
                                           int64_t plane, int t0) {
  const int q = threadIdx.x;
  const int64_t band0 = (plane << 14) + t0 * 128;
  cp_async16(stage + 16 * q, vals + band0 + 4 * q);
  if (q < kLlBytes / 16) cp_async16(stage + kValsBytes + 16 * q, ll + band0 + 16 * q);
  uint32_t* bb = reinterpret_cast<uint32_t*>(stage + kValsBytes + kLlBytes);
  const int16_t* table = bbT + (plane << 14) + t0;
#pragma unroll
  for (int c = q; c < 128 * 8; c += kBandThreads) {
    const int b = c >> 3, w = c & 7;
    cp_async4(bb + b * kRowWords + w, table + b * 128 + 2 * w);
  }
}

// y = x[j]: the SpMV's source.
struct XSource {
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(int64_t j) const { return __ldg(x + j); }
};

// The band's sums for the thread's 4 rows i0..i0+3 (slots, then the spill
// of the rows < n): acc[e] for row i0 + e.  Every thread of the block must
// call it (it holds block barriers).
template <class Src>
__device__ __forceinline__ void band_apply(
    const float* __restrict__ vals, const int8_t* __restrict__ ll,
    const int16_t* __restrict__ bbT, int n_slots, int c_left,
    const int* __restrict__ sp_ptr, const int* __restrict__ sp_cols,
    const int* __restrict__ sp_gidx, const float* __restrict__ sp_vals,
    const Src& src, int64_t n, unsigned char* ring, int64_t i0, float (&acc)[4]) {
  const int64_t tile = blockIdx.x >> 3;
  const int t0 = static_cast<int>(blockIdx.x & 7) * kBandT;
  const int q = threadIdx.x;
  const int tt = q >> 5;  // the warp's t within the band
  const int64_t plane0 = tile * n_slots;
  const int64_t base = (tile - c_left) * 16384;  // j = base + blk*128 + b

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slots) stage_slot(ring + s * kStageBytes, vals, ll, bbT, plane0 + s, t0);
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
    if (kn < n_slots)
      stage_slot(ring + (kn % kStages) * kStageBytes, vals, ll, bbT, plane0 + kn, t0);
    cp_async_commit();
    if (k > 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += v[e] * g[e];
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
      g[e] = (j >= 0 && j < n) ? src(j) : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += v[e] * g[e];
  cp_async_wait<0>();  // no copy outlives the block (the trailing groups are empty)
  if (sp_ptr != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t i = i0 + e;
      if (i < n) {
        const int end = sp_ptr[i + 1];
        for (int s = sp_ptr[i]; s < end; ++s)
          acc[e] += sp_vals[sp_gidx[s]] * src(static_cast<int64_t>(sp_cols[s]));
      }
    }
  }
}

__global__ void __launch_bounds__(kBandThreads, 2)
    xell_band_kernel(const float* __restrict__ vals, const int8_t* __restrict__ ll,
                     const int16_t* __restrict__ bbT, int n_slots, int c_left,
                     const int* __restrict__ sp_ptr, const int* __restrict__ sp_cols,
                     const int* __restrict__ sp_gidx, const float* __restrict__ sp_vals,
                     const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) << 11) + 4 * threadIdx.x;
  float acc[4];
  band_apply(vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals,
             XSource{x}, n, ring, i0, acc);
  if (i0 + 3 < n) {
    reinterpret_cast<float4*>(y + i0)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e < n) y[i0 + e] = acc[e];
  }
}

__global__ void xell_k1_kernel(const float* __restrict__ vals,
                               const int8_t* __restrict__ ll,
                               const int16_t* __restrict__ bbT, int n_slots,
                               int c_left, const int* __restrict__ sp_ptr,
                               const int* __restrict__ sp_cols,
                               const int* __restrict__ sp_gidx,
                               const float* __restrict__ sp_vals, const float* z,
                               const float* p, const float* __restrict__ beta_ptr,
                               float* __restrict__ pout, float* __restrict__ q,
                               float* __restrict__ partials, int64_t n) {
  const float beta = *beta_ptr;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float prod = 0.0f;
  if (i < n) {
    const int64_t tile = i >> 14;
    const int64_t t = (i >> 7) & 127;
    const int64_t base = (tile * 128 - (int64_t)c_left * 128) * 128;
    float acc = 0.0f;
    for (int k = 0; k < n_slots; ++k) {
      const int64_t slot = (tile * n_slots + k) << 14;
      const int64_t at = slot + (i & 16383);
      const int64_t b = (int64_t)ll[at] & 127;
      const int64_t j = base + (int64_t)bbT[slot + (b << 7) + t] * 128 + b;
      if (j >= 0 && j < n) acc += vals[at] * (z[j] + beta * p[j]);
    }
    if (sp_ptr != nullptr) {
      const int end = sp_ptr[i + 1];
      for (int s = sp_ptr[i]; s < end; ++s) {
        const int64_t j = sp_cols[s];
        acc += sp_vals[sp_gidx[s]] * (z[j] + beta * p[j]);
      }
    }
    q[i] = acc;
    const float pc = z[i] + beta * p[i];
    pout[i] = pc;
    prod = pc * acc;
  }
  ogl::block_sum_to(prod, partials);
}

bool misaligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
}

}  // namespace

// y = A x over `bands` = ceil(n / 2048) blocks of 2,048 rows on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int ogl_xell_spmv(const float* vals, const int8_t* ll,
                             const int16_t* bbT, int n_slots, int c_left,
                             const int* sp_ptr, const int* sp_cols,
                             const int* sp_gidx, const float* sp_vals,
                             const float* x, float* y, int64_t n, int64_t bands,
                             void* stream) {
  if (n_slots < 1 || c_left < 0 || n < 0 || bands != (n + kBandRows - 1) / kBandRows ||
      bands > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(vals, 16) || misaligned(ll, 16) || misaligned(bbT, 4) || misaligned(y, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (bands == 0) return 0;
  static bool ring_set = false;  // the ring is above the 48 KB default
  if (!ring_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        xell_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ring_set = true;
  }
  xell_band_kernel<<<static_cast<unsigned int>(bands), kBandThreads, kRingBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, x, y, n);
  return static_cast<int>(cudaGetLastError());
}

// K1; `partials` holds `grid` floats and grid must cover n.
extern "C" int ogl_xell_k1(const float* vals, const int8_t* ll,
                           const int16_t* bbT, int n_slots, int c_left,
                           const int* sp_ptr, const int* sp_cols,
                           const int* sp_gidx, const float* sp_vals,
                           const float* z, const float* p, const float* beta,
                           float* pout, float* q, float* partials, int64_t n,
                           int threads, int64_t grid, void* stream) {
  if (n_slots < 1 || c_left < 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      n < 0 || grid * threads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  xell_k1_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, z, p,
      beta, pout, q, partials, n);
  return static_cast<int>(cudaGetLastError());
}
