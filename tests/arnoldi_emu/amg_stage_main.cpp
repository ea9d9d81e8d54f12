// Runs the staged Ell body of the device V-cycle (csrc/amg_stage.cuh
// `ell_groups_staged`, the Ell level phases of amg_loop.cuh) on the CPU
// stand-in, as a smoother sweep or residual over a level: one std::thread per
// CUDA thread, CTAS blocks of THREADS, each warp walking the groups warp,
// warp + warps, ... of the grid, the bulk copies landing at random later
// times (tma.cuh), the CTA's stand-in shared memory filled with NaN first.
// The copies may read only the level's columns and values.
//
//   amg_stage_emu IN OUT
//
// IN: int32 ctas, threads, int64 n, int32 K, bf16, sweep, slots, float relax,
// then cols (K * n int32), vals (K * n of 4 or 2 bytes), warp_slots
// (ceil(n / 32) int32), x, b, invd (n floats each).
// OUT: the n results, NaN where nothing was stored.
#include <stdio.h>
#include <stdlib.h>

#include <thread>
#include <vector>

#include "amg_stage.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local Cta* this_cta;
thread_local unsigned char* emu_smem_base;
std::barrier<>* grid_barrier;
namespace ogl {
namespace tma {
Engine* engine;
}
}  // namespace ogl

namespace {

FILE* in;

template <class T>
std::vector<T> take(size_t count) {
  std::vector<T> out(count);
  if (fread(out.data(), sizeof(T), count, in) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return out;
}

template <class T>
T one() {
  return take<T>(1)[0];
}

// Bytes read into a 16-byte aligned place of `pool`.
unsigned char* take_into(std::vector<unsigned char>& pool, size_t& at, size_t bytes) {
  at = (at + 15) & ~size_t{15};
  unsigned char* p = pool.data() + at;
  if (fread(p, 1, bytes, in) != bytes) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  at += bytes;
  return p;
}

// Every CUDA thread of `ctas` CTAs of `threads` runs body(smem, bars of its CTA).
template <class Body>
void launch(int ctas, int threads, size_t smem, const unsigned char* lo, const unsigned char* hi,
            Body body) {
  blockDim.x = threads;
  gridDim.x = ctas;
  ogl::tma::Engine engine;
  ogl::tma::engine = &engine;
  engine.src_lo = lo;
  engine.src_hi = hi;
  std::thread copier([&] { engine.run(); });
  std::vector<Cta> cta(ctas);
  std::vector<std::vector<unsigned char>> mem(ctas);
  std::vector<std::vector<uint64_t>> bars(ctas, std::vector<uint64_t>(2 * 32 + 1));
  std::vector<std::barrier<>*> owned;
  for (int c = 0; c < ctas; ++c) {
    cta[c].bar = new std::barrier<>(threads);
    owned.push_back(cta[c].bar);
    for (auto& wb : cta[c].warp_bars) owned.push_back(wb = new std::barrier<>(32));
    mem[c].assign(smem + 256, 0xff);  // NaN in every float a copy does not land on
  }
  std::vector<std::thread> pool;
  for (int c = 0; c < ctas; ++c)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, c, t] {
        threadIdx.x = t;
        blockIdx.x = c;
        this_cta = &cta[c];
        emu_smem_base = reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(mem[c].data()) + 127) & ~static_cast<uintptr_t>(127));
        body(emu_smem_base, bars[c].data());
      });
  for (auto& t : pool) t.join();
  {
    std::lock_guard<std::mutex> g(engine.mu);
    engine.stop = true;
    engine.cv.notify_all();
  }
  copier.join();
  for (auto* b : owned) delete b;
}

// Every thread of one CTA: the sweep or residual of its warps' groups.
template <bool kSweep, typename T>
void ell_smooth(const ogl::EllOperandsOf<T>& m, const float* x, const float* b,
                const float* invd, float relax, float* out, int64_t n, int slots,
                unsigned char* smem, uint64_t* bars) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  if (lane == 0) {
    ogl::tma::bar_init(bars + 2 * warp, 1);
    ogl::tma::bar_init(bars + 2 * warp + 1, 1);
  }
  __syncwarp();
  ogl::stage::EllStage<T> st = ogl::stage::ell_stage_of<T>(smem, bars, slots, 0);
  const int64_t per_block = blockDim.x >> 5;
  ogl::stage::ell_groups_staged(
      m, st, ogl::XSource{x}, n, static_cast<int64_t>(blockIdx.x) * per_block + warp,
      static_cast<int64_t>(gridDim.x) * per_block, [&](int64_t i, float ax) {
        if (i < n)
          out[i] = ogl::smooth_value<kSweep>(x[i], b[i], kSweep ? invd[i] : 0.0f, relax, ax);
      });
  __syncwarp();
  if (lane == 0) {
    ogl::tma::bar_inval(bars + 2 * warp);
    ogl::tma::bar_inval(bars + 2 * warp + 1);
  }
}

template <bool kSweep, typename T>
void ell(int ctas, int threads, int64_t n, int slots, const int* cols, const T* vals,
         const std::vector<int>& ws, const std::vector<float>& x, const std::vector<float>& b,
         const std::vector<float>& invd, float relax, float* out, const unsigned char* lo,
         const unsigned char* hi) {
  const ogl::EllOperandsOf<T> m{cols, vals, ws.data(), nullptr, nullptr, nullptr};
  const size_t smem = static_cast<size_t>(threads / 32) * ogl::stage::ell_warp_bytes<T>(slots);
  launch(ctas, threads, smem, lo, hi, [&](unsigned char* s, uint64_t* bars) {
    ell_smooth<kSweep>(m, x.data(), b.data(), invd.data(), relax, out, n, slots, s, bars);
  });
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: amg_stage_emu IN OUT\n");
    return 2;
  }
  in = fopen(argv[1], "rb");
  const int ctas = one<int32_t>(), threads = one<int32_t>();
  const int64_t n = one<int64_t>();
  const int k = one<int32_t>(), bf16 = one<int32_t>(), sweep = one<int32_t>();
  const int slots = one<int32_t>();
  const float relax = one<float>();
  const size_t width = bf16 ? 2 : 4;
  std::vector<float> out(n, NAN);
  std::vector<unsigned char> pool(static_cast<size_t>(k) * n * (4 + width) + 64);
  size_t at = 0;
  const auto* cols = reinterpret_cast<const int*>(take_into(pool, at, size_t(k) * n * 4));
  const unsigned char* raw = take_into(pool, at, size_t(k) * n * width);
  const auto ws = take<int>((n + 31) / 32);
  const auto x = take<float>(n), b = take<float>(n), invd = take<float>(n);
  const auto* lo = reinterpret_cast<const unsigned char*>(cols);
  const unsigned char* hi = raw + size_t(k) * n * width;
  if (bf16) {
    const auto* v = reinterpret_cast<const __nv_bfloat16*>(raw);
    (sweep ? ell<true, __nv_bfloat16> : ell<false, __nv_bfloat16>)(
        ctas, threads, n, slots, cols, v, ws, x, b, invd, relax, out.data(), lo, hi);
  } else {
    const auto* v = reinterpret_cast<const float*>(raw);
    (sweep ? ell<true, float> : ell<false, float>)(ctas, threads, n, slots, cols, v, ws, x, b,
                                                   invd, relax, out.data(), lo, hi);
  }
  fclose(in);
  FILE* f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return 0;
}
