// Runs csrc/tri_sweep.cuh `sweep_apply` (kernel 1) or csrc/tri_levels.cuh
// `level_apply` (kernel 2) as their cooperative launches run them: CTAS
// CTAs of THREADS threads, one std::thread per CUDA thread, each walking its
// rows grid-stride, and grid.sync() a std::barrier over every thread.
//
//   tri_emu IN OUT
//
// IN: int32 mode (0 sweeps, 1 levels), int64 n, int32 threads, int32 ctas,
// then per factor (lower, upper): int32 nnz, int32 sweeps, int32 has_d,
// int32 levels, row_ptr (n + 1 int32), cols (nnz int32), vals (nnz
// floats), d (n floats, when has_d), order (n int32), level_ptr (levels + 1
// int32); then r (n floats).  OUT: the result (n floats).
#include <stdio.h>
#include <stdlib.h>

#include <thread>
#include <vector>

#include "tri_levels.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;

namespace {

template <class T>
void take(FILE* f, T* out, size_t count) {
  if (count && fread(out, sizeof(T), count, f) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
}

struct Factor {
  int32_t sweeps = 0, has_d = 0, levels = 0;
  std::vector<int32_t> row_ptr, cols, order, level_ptr;
  std::vector<float> vals, d;

  void read(FILE* f, int64_t n) {
    int32_t nnz;
    take(f, &nnz, 1);
    take(f, &sweeps, 1);
    take(f, &has_d, 1);
    take(f, &levels, 1);
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
    order.resize(n);
    level_ptr.resize(levels + 1);
    take(f, order.data(), n);
    take(f, level_ptr.data(), levels + 1);
  }
  ogl::tri::Triangle triangle() const {
    return ogl::tri::Triangle{ogl::CsrOperands{row_ptr.data(), cols.data(), vals.data()},
                              has_d ? d.data() : nullptr, sweeps};
  }
  ogl::tri::Levels schedule() const {
    return ogl::tri::Levels{order.data(), level_ptr.data(), levels};
  }
};

struct GridSync {
  std::barrier<>* bar;
  void operator()() { bar->arrive_and_wait(); }
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: tri_emu IN OUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  int32_t mode, threads, ctas;
  int64_t n;
  take(in, &mode, 1);
  take(in, &n, 1);
  take(in, &threads, 1);
  take(in, &ctas, 1);
  Factor lo, up;
  lo.read(in, n);
  up.read(in, n);
  std::vector<float> r(n);
  take(in, r.data(), n);
  fclose(in);
  std::vector<float> t0(n, NAN), t1(n, NAN), out(n, NAN);
  blockDim.x = threads;
  gridDim.x = ctas;
  std::barrier<> grid(static_cast<ptrdiff_t>(threads) * ctas);
  const ogl::tri::Triangle tl = lo.triangle(), tu = up.triangle();
  const ogl::tri::Levels ll = lo.schedule(), lu = up.schedule();
  std::vector<std::thread> pool;
  for (int c = 0; c < ctas; ++c)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, c, t] {
        threadIdx.x = t;
        blockIdx.x = c;
        GridSync sync{&grid};
        const int64_t first = static_cast<int64_t>(c) * threads + t;
        const int64_t stride = static_cast<int64_t>(ctas) * threads;
        if (mode == 0)
          ogl::tri::sweep_apply(tl, tu, r.data(), t0.data(), t1.data(), out.data(), n, first,
                                stride, sync);
        else
          ogl::tri::level_apply(tl, ll, tu, lu, r.data(), t0.data(), out.data(), first, stride,
                                sync);
      });
  for (auto& th : pool) th.join();
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, n, o);
  fclose(o);
  return 0;
}
