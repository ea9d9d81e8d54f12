// Runs csrc/tri_sweep.cuh `sweep_apply` (kernel 1) or csrc/tri_levels.cuh
// `level_apply` (kernel 2) as their cooperative launches run them: CTAS
// CTAs of THREADS threads, one std::thread per CUDA thread.  Kernel 1: each
// CTA with its own dynamic shared memory of CAPACITY bytes (0xff in every
// byte the body does not write) and its own mbarrier, the bulk copies of
// tests/arnoldi_emu/tma.cuh landing at random later times, grid.sync() a
// std::barrier over every thread.  Kernel 2: no barrier at all, each thread
// walking its positions and polling ready words (tests/cuda_emu/tri_sync.cuh).
// The factors' arrays sit in one arena, 0xff between them, and every bulk
// copy must read inside it.
//
//   tri_emu IN OUT
//
// IN: int32 mode (0 sweeps, 1 levels), int64 n, int32 threads, int32 ctas,
// int64 capacity, int32 block (kernel 2: the entries whose words a thread
// loads at once, 4 or 16), int32 applies, int64 limit_ns, then per factor
// (lower, upper): int32
// nnz, int32 sweeps, int32 has_d, row_ptr (n + 1 int32), cols (nnz int32),
// vals (nnz floats), d (n floats, when has_d), its level layout
// (tri_solve.py `level_layout`: ptr (n + 1 int32), src (nnz int32), vals
// (nnz floats), rows (n int32), inv (n int32), d (n floats, when has_d)),
// int32 planned, then (when planned) bounds (ctas + 1 int32) and held (ctas
// int32); then r (applies x n floats).
// OUT: the results (applies x n floats), the applies one after another on
// the same ready words (kernel 2: epochs 1, 2, ...).
#include <stdio.h>
#include <stdlib.h>

#include <memory>
#include <thread>
#include <vector>

#include "tri_levels.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;
thread_local unsigned char* emu_smem_base;

namespace ogl {
namespace tma {
Engine* engine;
}  // namespace tma
}  // namespace ogl

namespace {

template <class T>
void take(FILE* f, T* out, size_t count) {
  if (count && fread(out, sizeof(T), count, f) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
}

// One block of memory for every array the bulk copies may read: each array
// 64-byte aligned behind 64 bytes of 0xff.
struct Arena {
  std::vector<unsigned char> mem;
  size_t used = 0;
  explicit Arena(size_t bytes) : mem(bytes + 4096, 0xff) {}
  template <class T>
  T* put(const std::vector<T>& v) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(mem.data());
    size_t at = ((base + used + 64 + 63) & ~uintptr_t{63}) - base;
    if (at + v.size() * sizeof(T) + 64 > mem.size()) {
      fprintf(stderr, "arena too small\n");
      exit(2);
    }
    memcpy(mem.data() + at, v.data(), v.size() * sizeof(T));
    used = at + v.size() * sizeof(T);
    return reinterpret_cast<T*>(mem.data() + at);
  }
};

struct Factor {
  int32_t nnz = 0, sweeps = 0, has_d = 0;
  std::vector<int32_t> row_ptr, cols, bounds, held, lv_ptr, lv_src, lv_rows, lv_inv;
  std::vector<float> vals, d, lv_vals, lv_d;
  const int32_t *a_ptr = nullptr, *a_cols = nullptr;
  const float* a_vals = nullptr;

  void read(FILE* f, int64_t n, int ctas) {
    take(f, &nnz, 1);
    take(f, &sweeps, 1);
    take(f, &has_d, 1);
    row_ptr.resize(n + 1);
    cols.resize(nnz);
    vals.resize(nnz);
    take(f, row_ptr.data(), n + 1);
    take(f, cols.data(), nnz);
    take(f, vals.data(), nnz);
    if (has_d) {
      d.resize(n);
      take(f, d.data(), n);
    }
    lv_ptr.resize(n + 1);
    lv_src.resize(nnz);
    lv_vals.resize(nnz);
    lv_rows.resize(n);
    lv_inv.resize(n);
    take(f, lv_ptr.data(), n + 1);
    take(f, lv_src.data(), nnz);
    take(f, lv_vals.data(), nnz);
    take(f, lv_rows.data(), n);
    take(f, lv_inv.data(), n);
    if (has_d) {
      lv_d.resize(n);
      take(f, lv_d.data(), n);
    }
    int32_t planned;
    take(f, &planned, 1);
    if (planned) {
      bounds.resize(ctas + 1);
      held.resize(ctas);
      take(f, bounds.data(), ctas + 1);
      take(f, held.data(), ctas);
    }
  }
  void place(Arena& arena) {
    a_ptr = arena.put(row_ptr);
    a_cols = arena.put(cols);
    a_vals = arena.put(vals);
  }
  size_t bytes() const { return 4 * row_ptr.size() + 8 * cols.size() + 3 * 128; }
  ogl::tri::Triangle triangle() const {
    return ogl::tri::Triangle{ogl::CsrOperands{a_ptr, a_cols, a_vals},
                              has_d ? d.data() : nullptr, sweeps};
  }
  // not planned: nothing held, the rows dealt over the grid
  ogl::tri::Part part() const {
    return bounds.empty() ? ogl::tri::Part{nullptr, nullptr}
                          : ogl::tri::Part{bounds.data(), held.data()};
  }
  ogl::tri::LevelRows levels() const {
    return ogl::tri::LevelRows{lv_ptr.data(),  lv_src.data(), lv_vals.data(),
                               lv_rows.data(), lv_inv.data(), has_d ? lv_d.data() : nullptr};
  }
};

struct GridSync {
  std::barrier<>* bar;
  void operator()() { bar->arrive_and_wait(); }
};

// Every CUDA thread of the launch as a std::thread running fn(cta, thread).
template <class Fn>
void launch(int ctas, int threads, Fn fn) {
  std::vector<std::thread> pool;
  for (int c = 0; c < ctas; ++c)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&fn, c, t] {
        threadIdx.x = t;
        blockIdx.x = c;
        fn(c, t);
      });
  for (auto& th : pool) th.join();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: tri_emu IN OUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  int32_t mode, threads, ctas, block, applies;
  int64_t n, capacity, limit_ns;
  take(in, &mode, 1);
  take(in, &n, 1);
  take(in, &threads, 1);
  take(in, &ctas, 1);
  take(in, &capacity, 1);
  take(in, &block, 1);
  take(in, &applies, 1);
  take(in, &limit_ns, 1);
  Factor lo, up;
  lo.read(in, n, ctas);
  up.read(in, n, ctas);
  std::vector<float> r(static_cast<size_t>(applies) * n);
  take(in, r.data(), r.size());
  fclose(in);

  Arena arena(lo.bytes() + up.bytes());
  lo.place(arena);
  up.place(arena);
  ogl::tma::Engine engine;
  ogl::tma::engine = &engine;
  engine.src_lo = arena.mem.data();
  engine.src_hi = arena.mem.data() + arena.mem.size();
  std::thread copier([&] { engine.run(); });

  blockDim.x = threads;
  gridDim.x = ctas;
  const ogl::tri::Triangle tl = lo.triangle(), tu = up.triangle();
  std::vector<uint64_t> lw(n, 0), uw(n, 0);  // the ready words, zeroed once
  std::vector<float> out(static_cast<size_t>(applies) * n, NAN);
  for (int a = 0; a < applies; ++a) {
    const float* ra = r.data() + static_cast<size_t>(a) * n;
    float* oa = out.data() + static_cast<size_t>(a) * n;
    if (mode == 0) {
      std::vector<float> t0(n, NAN), t1(n, NAN);
      std::vector<std::unique_ptr<std::barrier<>>> ctab;
      std::vector<std::vector<unsigned char>> smem;
      std::vector<uint64_t> bars(ctas);
      for (int c = 0; c < ctas; ++c) {
        ctab.emplace_back(new std::barrier<>(threads));
        smem.emplace_back(capacity + 128, 0xff);
      }
      std::barrier<> grid(static_cast<ptrdiff_t>(threads) * ctas);
      const ogl::tri::Part lp = lo.part(), upart = up.part();
      launch(ctas, threads, [&](int c, int) {
        cta_barrier = ctab[c].get();
        const uintptr_t s = reinterpret_cast<uintptr_t>(smem[c].data());
        emu_smem_base = reinterpret_cast<unsigned char*>((s + 127) & ~uintptr_t{127});
        GridSync sync{&grid};
        float* t0p = t0.data();
        float* t1p = t1.data();
        unsigned char* sm = emu_smem_base;
        ogl::tri::sweep_apply(tl, lp, tu, upart, n, ra, t0p, t1p, oa, sm, capacity, &bars[c],
                              sync);
      });
    } else {
      const ogl::tri::Patience pat{64, static_cast<uint64_t>(limit_ns)};
      const uint32_t epoch = static_cast<uint32_t>(a + 1);
      const int64_t stride = static_cast<int64_t>(ctas) * threads;
      const ogl::tri::LevelRows ll = lo.levels(), lu = up.levels();
      launch(ctas, threads, [&](int c, int t) {
        const int64_t first = static_cast<int64_t>(c) * threads + t;
        if (block == 4)
          ogl::tri::level_apply<4>(ll, lw.data(), lu, uw.data(), ra, oa, n, epoch, pat, first,
                                   stride);
        else
          ogl::tri::level_apply<16>(ll, lw.data(), lu, uw.data(), ra, oa, n, epoch, pat, first,
                                    stride);
      });
    }
  }
  {
    std::lock_guard<std::mutex> g(engine.mu);
    engine.stop = true;
    engine.cv.notify_all();
  }
  copier.join();
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0;
}
