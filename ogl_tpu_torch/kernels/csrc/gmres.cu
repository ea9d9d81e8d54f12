// The two basis kernels of restarted GMRES, for Hopper, with the Krylov basis
// V stored in float32 or bfloat16 (a template parameter; every sum in
// float32):
//
//   ogl_gmres_arnoldi  one Arnoldi step's orthogonalisation, as ONE
//                      cooperative launch: blocked modified Gram-Schmidt of
//                      w = A M^-1 v_j against the live rows V[0..j], in
//                      blocks of 8 rows (the 8 dots of a block against the
//                      same w, then w -= sum_b h_b V_b, then the next block),
//                      no re-orthogonalisation; then ||w||_2 and
//                      V[j+1] = w / max(||w||, tiny) in the basis type;
//                      h[0..j+1] written to a device buffer.  With a bfloat16
//                      basis, w itself becomes the float32 v_{j+1} (the
//                      running vector of the next step, as the reference
//                      keeps it beside the stored row).
//   ogl_gmres_combine  acc = sum_{k<j} y_k V_k over the live rows only (the
//                      basis recombination of x = x0 + M^-1 V y).
//
// Replaces no TPU kernel: the reference runs both as XLA ops inside its
// while_loop, the blocked MGS as a fori_loop of two einsums per block
// (ogl_tpu/solve/gmres.py:264-301) and the combine as a blocked einsum
// (:108-123).  Plain twins: `gmres_arnoldi_plain` and `gmres_combine_plain`
// in ogl_tpu_torch/kernels/gmres.py.
//
// Bound: device-memory bandwidth.  An Arnoldi step at j reads the j + 1 live
// rows and w, and writes one row (and, bfloat16, w): at n = 1M and j = 99
// about 0.41 GB in float32 (122 us at 3.35 TB/s), 0.21 GB in bfloat16.  The
// combine reads j rows and writes one vector.
//
// Design (Arnoldi).  Each thread owns a fixed set of row quads of the n
// entries (grid-stride over the co-resident grid), so each quad of w is only
// ever touched by one thread and w needs no barrier of its own.  Pass p
// streams the quads once: it subtracts block p-1's projection h_b V_b from
// w (rows read again: a block of 8 rows is 32 MB in float32 at 1M, 16 MB in
// bfloat16, against the 50 MB L2; odd passes walk the quads backwards, so a
// pass starts on the lines the previous one loaded last), stores w, and
// forms the 8 partial dots of block p against the updated w; one float32
// partial per CUDA block and row, then a grid barrier, then every block sums
// all partials in block order (loop.cuh block_totals), so every block holds the
// same bits of h.  The pass after the last block subtracts it and forms
// ||w||^2 the same way; a last pass writes V[j+1].  So j + 1 live rows cost
// ceil((j + 1) / 8) + 1 barriers, and the dots and the subtraction share
// one stream of the basis per block.  The partials are double-buffered by
// pass parity: a block that runs ahead writes the other half.  Holding a
// block's rows in registers across the barrier instead does not fit: 8 rows
// of 1M floats are the whole register file of the card.
//
// Design (combine).  One thread per row quad, grid-stride; for each k in
// order acc = acc + y_k * V_k, every product and sum rounded, as the twin
// writes it, so kernel and twin give the same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // basis rows per block of the blocked MGS

// Row quads of the basis, float32 or bfloat16, read through the read-only
// path (the basis rows a launch reads are not written by it).
template <bool BF16>
struct Basis;

template <>
struct Basis<false> {
  using T = float;
  static __device__ __forceinline__ float4 load(const float* row, int64_t i, int64_t n) {
    if (i + 4 <= n) return __ldg(reinterpret_cast<const float4*>(row + i));
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < 4 && i + t < n; ++t) e[t] = __ldg(row + i + t);
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ void store(float* row, int64_t i, float4 q, int64_t n) {
    if (i + 4 <= n) {
      *reinterpret_cast<float4*>(row + i) = q;
      return;
    }
    const float e[4] = {q.x, q.y, q.z, q.w};
    for (int t = 0; t < 4 && i + t < n; ++t) row[i + t] = e[t];
  }
};

__device__ __forceinline__ float bf16_bits(unsigned int u) { return __uint_as_float(u << 16); }

template <>
struct Basis<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* row, int64_t i,
                                                int64_t n) {
    if (i + 4 <= n) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + i));
      return make_float4(bf16_bits(raw.x & 0xffffu), __uint_as_float(raw.x & 0xffff0000u),
                         bf16_bits(raw.y & 0xffffu), __uint_as_float(raw.y & 0xffff0000u));
    }
    const unsigned short* u = reinterpret_cast<const unsigned short*>(row);
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < 4 && i + t < n; ++t) e[t] = bf16_bits(__ldg(u + i + t));
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* row, int64_t i, float4 q,
                                               int64_t n) {
    const unsigned int u[4] = {__bfloat16_as_ushort(__float2bfloat16_rn(q.x)),
                               __bfloat16_as_ushort(__float2bfloat16_rn(q.y)),
                               __bfloat16_as_ushort(__float2bfloat16_rn(q.z)),
                               __bfloat16_as_ushort(__float2bfloat16_rn(q.w))};
    if (i + 4 <= n) {
      uint2 raw;
      raw.x = u[0] | (u[1] << 16);
      raw.y = u[2] | (u[3] << 16);
      *reinterpret_cast<uint2*>(row + i) = raw;
      return;
    }
    unsigned short* d = reinterpret_cast<unsigned short*>(row);
    for (int t = 0; t < 4 && i + t < n; ++t) d[i + t] = static_cast<unsigned short>(u[t]);
  }
};

// w is written by the launch that reads it: plain loads, not __ldg.
__device__ __forceinline__ float4 load_w(const float* w, int64_t i, int64_t n) {
  if (i + 4 <= n) return *reinterpret_cast<const float4*>(w + i);
  float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < 4 && i + t < n; ++t) e[t] = w[i + t];
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 4)
    gmres_arnoldi_kernel(const typename Basis<BF16>::T* __restrict__ V, int64_t ld,
                         float* __restrict__ w, typename Basis<BF16>::T* __restrict__ vnext,
                         float* __restrict__ h, float* __restrict__ partials, int64_t n, int j,
                         float tiny) {
  using B = Basis<BF16>;
  cg::grid_group grid = cg::this_grid();
  const int64_t nq = (n + 3) / 4;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int live = j + 1;
  const int nblk = (live + kRows - 1) / kRows;
  float hp[kRows];  // h of the block the next pass subtracts
#pragma unroll
  for (int b = 0; b < kRows; ++b) hp[b] = 0.0f;
  float wnorm = 0.0f;
  for (int pass = 0; pass <= nblk; ++pass) {
    const int old_base = (pass - 1) * kRows;
    const int old_cnt = pass > 0 ? min(kRows, live - old_base) : 0;
    const int new_base = pass * kRows;
    const int new_cnt = pass < nblk ? min(kRows, live - new_base) : 0;
    float acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = 0.0f;
    float nrm = 0.0f;
    // rows past the live ones read the last live row again (a cache hit)
    // with h = 0, so the unrolled loads need no branch
    const typename B::T* old_rows[kRows];
    const typename B::T* new_rows[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      old_rows[b] = V + static_cast<int64_t>(min(max(old_base + b, 0), j)) * ld;
      new_rows[b] = V + static_cast<int64_t>(min(new_base + b, j)) * ld;
    }
    // odd passes walk the quads backwards: the first quads a pass re-reads
    // are the last the previous pass loaded, still in L2
    const bool back = (pass & 1) != 0;
    const int64_t mine = first < nq ? (nq - 1 - first) / stride + 1 : 0;
    for (int64_t t = 0; t < mine; ++t) {
      const int64_t q = first + (back ? mine - 1 - t : t) * stride;
      const int64_t i = q * 4;
      float4 wq = load_w(w, i, n);
      if (old_cnt > 0) {
        float4 v[kRows];
#pragma unroll
        for (int b = 0; b < kRows; ++b) v[b] = B::load(old_rows[b], i, n);
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          s.x += hp[b] * v[b].x;
          s.y += hp[b] * v[b].y;
          s.z += hp[b] * v[b].z;
          s.w += hp[b] * v[b].w;
        }
        wq.x -= s.x;
        wq.y -= s.y;
        wq.z -= s.z;
        wq.w -= s.w;
        Basis<false>::store(w, i, wq, n);
      }
      if (new_cnt > 0) {
        float4 v[kRows];
#pragma unroll
        for (int b = 0; b < kRows; ++b) v[b] = B::load(new_rows[b], i, n);
#pragma unroll
        for (int b = 0; b < kRows; ++b) acc[b] += dot4(v[b], wq);
      } else {
        nrm += dot4(wq, wq);
      }
    }
    float* part = partials + (pass & 1) * kRows * static_cast<int64_t>(gridDim.x);
    if (pass < nblk) {
      ogl::block_sums_to<kRows>(acc, part);
      grid.sync();
      ogl::block_totals<kRows>(part, gridDim.x, hp);
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        if (b >= new_cnt) hp[b] = 0.0f;
        if (blockIdx.x == 0 && threadIdx.x == b && b < new_cnt) h[new_base + b] = hp[b];
      }
    } else {
      const float mine[1] = {nrm};
      ogl::block_sums_to<1>(mine, part);
      grid.sync();
      float total[1];
      ogl::block_totals<1>(part, gridDim.x, total);
      wnorm = sqrtf(total[0]);
    }
  }
  const float den = fmaxf(wnorm, tiny);
  for (int64_t q = first; q < nq; q += stride) {
    const int64_t i = q * 4;
    float4 v = load_w(w, i, n);
    v.x = __fdiv_rn(v.x, den);
    v.y = __fdiv_rn(v.y, den);
    v.z = __fdiv_rn(v.z, den);
    v.w = __fdiv_rn(v.w, den);
    B::store(vnext, i, v, n);
    if (BF16) Basis<false>::store(w, i, v, n);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) h[live] = wnorm;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    gmres_combine_kernel(const typename Basis<BF16>::T* __restrict__ V, int64_t ld,
                         const float* __restrict__ y, int j, float* __restrict__ out,
                         int64_t n) {
  using B = Basis<BF16>;
  const int64_t nq = (n + 3) / 4;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < nq;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = q * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < j; ++k) {
      const float yk = __ldg(y + k);
      const float4 v = B::load(V + static_cast<int64_t>(k) * ld, i, n);
      a.x = __fadd_rn(a.x, __fmul_rn(yk, v.x));
      a.y = __fadd_rn(a.y, __fmul_rn(yk, v.y));
      a.z = __fadd_rn(a.z, __fmul_rn(yk, v.z));
      a.w = __fadd_rn(a.w, __fmul_rn(yk, v.w));
    }
    Basis<false>::store(out, i, a, n);
  }
}

const void* arnoldi_kernel(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(&gmres_arnoldi_kernel<true>)
              : reinterpret_cast<const void*>(&gmres_arnoldi_kernel<false>);
}

// Row alignment the quad loads need: 16 bytes for float32 rows, 8 for
// bfloat16; every row starts a multiple of 4 entries after V.
bool bad_rows(int bf16, const void* V, int64_t ld) {
  return (ld & 3) != 0 || ogl::misaligned(V, bf16 ? 8 : 16);
}

}  // namespace

// The grid of an Arnoldi launch (bf16: the basis type) with `threads` per
// block: the co-resident blocks on the current device.
extern "C" int ogl_gmres_arnoldi_grid(int bf16, int threads, int64_t* blocks) {
  if (threads != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  return ogl::coop_grid(arnoldi_kernel(bf16), threads, blocks);
}

// One cooperative launch of `blocks` blocks of 256 threads on `stream`: the
// orthogonalisation of w (n,) against V's rows 0..j (row stride ld, in the
// basis type), V[j+1] written at `vnext`, h[0..j+1] at `h`; partials holds
// 2 * 8 * blocks floats.  With bf16, w becomes v_{j+1} in float32.  Returns
// the launch's error code (0 = launched).
extern "C" int ogl_gmres_arnoldi(int bf16, const void* V, int64_t ld, float* w, void* vnext,
                                 float* h, float* partials, int64_t n, int j, float tiny,
                                 int64_t blocks, void* stream) {
  if (n < 1 || j < 0 || ld < n || blocks < 1 || blocks > INT32_MAX || V == nullptr ||
      w == nullptr || vnext == nullptr || h == nullptr || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bad_rows(bf16, V, ld) || ogl::misaligned(w, 16) || ogl::misaligned(vnext, bf16 ? 8 : 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  void* args[] = {&V, &ld, &w, &vnext, &h, &partials, &n, &j, &tiny};
  return ogl::coop_launch(arnoldi_kernel(bf16), blocks, kThreads, args, stream);
}

// Launches `blocks` blocks of 256 threads on `stream`: out (n,) = the sum of
// y[k] * V[k] over k < j, in k order.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_gmres_combine(int bf16, const void* V, int64_t ld, const float* y, int j,
                                 float* out, int64_t n, int64_t blocks, void* stream) {
  if (n < 1 || j < 1 || ld < n || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bad_rows(bf16, V, ld) || ogl::misaligned(out, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    gmres_combine_kernel<true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(V), ld, y, j, out, n);
  else
    gmres_combine_kernel<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(V), ld, y, j, out, n);
  return static_cast<int>(cudaGetLastError());
}
