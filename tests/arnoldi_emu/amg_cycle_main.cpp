// Runs the transfer phases of the device V-cycle on Gdia and Ell levels
// (csrc/amg_loop.cuh `resid_restrict` and `sweep_children`, as the mixed
// variants run them) on the CPU stand-in: one std::thread per CUDA thread,
// CTAS blocks of THREADS, each thread walking the phase's rows, quads, warp
// groups or coarse rows from its grid index with the grid's stride; an
// Ell level with a stage takes the staged body, whose bulk copies land at
// random later times (tma.cuh) into stand-in shared memory filled with NaN
// first.  The copies may read only the level's columns or lanes and values.
//
//   amg_cycle_emu IN OUT
//
// IN: int32 mode (0: the restricting residual b - A x summed per coarse row;
// 1: the same from the zero guess x1 = relax * invd * b, x1 stored at the
// rows; 2: the last sweep of the level added to the x of its fine rows on
// the level above), ctas, threads, bf16, fmt (1 Gdia, 2 Ell), nd (planes or
// slots K), stage (Ell slots per staged chunk, 0: the register body), kind
// and width (the level's transfer: modes 0-1), fine kind and width (the
// level above's: mode 2); int64 n, rows (Gdia block rows R), m (modes 0-1:
// coarse rows; mode 2: the level above's rows); float relax; then Gdia
// lanes (nd * R * 128 int8) or Ell columns (nd * n int32), values (nd * R *
// 128 or nd * n of 4 or 2 bytes), Gdia plane offsets (nd int32), Ell warp
// slots (ceil(n / 32) int32), x, b, invd (n floats each), and in mode 2 the
// level above's x (m floats).
// OUT: modes 0-1: the m coarse right-hand sides (NaN where nothing was
// stored), mode 1 then the n stored x1; mode 2: the level above's x.
#include <stdio.h>
#include <stdlib.h>

#include <thread>
#include <vector>

#include "cuda_runtime.h"
// The kernel's declarations of shared memory are parsed, never run, here
// (an extern __shared__ array has no `static` stand-in); the phases run take
// their stage from main.
#undef __shared__
#define __shared__
#include "amg_loop.cuh"

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

struct Args {
  int mode, ctas, threads;
  ogl::amg::Level L, f;  // the level, and (mode 2) the level above
  const int* off;        // Gdia plane offsets
  float relax;
  const float* b;
  const float* x;
  float* out;  // modes 0-1: the coarse right-hand sides; mode 2: the level above's x
  float* xs;   // mode 1: the stored x1
};

// Every thread of one CTA: the phase over its share of the level.
template <typename T>
void phase(const Args& a, unsigned char* smem, uint64_t* bars) {
  using namespace ogl::amg;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  if (lane == 0) {
    ogl::tma::bar_init(bars + 2 * warp, 1);
    ogl::tma::bar_init(bars + 2 * warp + 1, 1);
  }
  __syncthreads();
  Staging sg{smem, bars, 0u};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (a.mode == 0) {
    resid_restrict<true, T, ogl::BufSrc<false>, false>(a.L, a.off, sg, ogl::BufSrc<false>{a.x},
                                                       a.b, a.out, a.f.n, nullptr, first, step);
  } else if (a.mode == 1) {
    const ogl::ZeroGuessSrc zg{a.L.invd, a.b, a.relax};
    resid_restrict<true, T, ogl::ZeroGuessSrc, true>(a.L, a.off, sg, zg, a.b, a.out, a.f.n,
                                                     a.xs, first, step);
  } else {
    sweep_children<true, T>(a.L, a.off, sg, a.x, a.b, a.f, a.out, a.relax, first, step);
  }
  __syncthreads();  // every wait on the barriers is over
  if (lane == 0) {
    ogl::tma::bar_inval(bars + 2 * warp);
    ogl::tma::bar_inval(bars + 2 * warp + 1);
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: amg_cycle_emu IN OUT\n");
    return 2;
  }
  in = fopen(argv[1], "rb");
  Args a{};
  a.mode = one<int32_t>();
  a.ctas = one<int32_t>();
  a.threads = one<int32_t>();
  const int bf16 = one<int32_t>();
  ogl::amg::Level& L = a.L;
  ogl::amg::Level& f = a.f;
  L.fmt = one<int32_t>();
  L.nd = one<int32_t>();
  L.stage = one<int32_t>();
  L.kind = one<int32_t>();
  L.width = one<int32_t>();
  f.kind = one<int32_t>();
  f.width = one<int32_t>();
  L.n = one<int64_t>();
  L.rows = one<int64_t>();
  f.n = one<int64_t>();
  a.relax = one<float>();
  const bool gdia = L.fmt == ogl::amg::kGdiaLevel;
  const int64_t n = L.n, m = f.n;
  const size_t entries = static_cast<size_t>(L.nd) * (gdia ? L.rows * 128 : n);
  const size_t width = bf16 ? 2 : 4;
  std::vector<unsigned char> pool(entries * (5 + width) + 64);
  size_t at = 0;
  const unsigned char* lo = take_into(pool, at, entries * (gdia ? 1 : 4));
  L.coef = take_into(pool, at, entries * width);
  const unsigned char* hi = static_cast<const unsigned char*>(L.coef) + entries * width;
  if (gdia) {
    L.lidx = reinterpret_cast<const int8_t*>(lo);
  } else {
    L.cols = reinterpret_cast<const int*>(lo);
  }
  const auto off = gdia ? take<int>(L.nd) : std::vector<int>();
  const auto ws = gdia ? std::vector<int>() : take<int>((n + 31) / 32);
  const auto x = take<float>(n), b = take<float>(n), invd = take<float>(n);
  L.ws = ws.data();
  L.invd = invd.data();
  a.off = off.data();
  a.x = x.data();
  a.b = b.data();
  std::vector<float> out = a.mode == 2 ? take<float>(m) : std::vector<float>(m, NAN);
  std::vector<float> xs(n, NAN);
  a.out = out.data();
  a.xs = xs.data();
  fclose(in);
  const size_t smem =
      gdia ? 0
           : static_cast<size_t>(a.threads / 32) *
                 (bf16 ? ogl::stage::ell_warp_bytes<__nv_bfloat16>(L.stage)
                       : ogl::stage::ell_warp_bytes<float>(L.stage));
  launch(a.ctas, a.threads, smem, lo, hi, [&](unsigned char* s, uint64_t* bars) {
    if (bf16)
      phase<__nv_bfloat16>(a, s, bars);
    else
      phase<float>(a, s, bars);
  });
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  if (a.mode == 1) fwrite(xs.data(), 4, xs.size(), o);
  fclose(o);
  return 0;
}
