// Runs csrc/block_jacobi.cuh as the general-BiCGStab loop runs it in its P
// phase (bicgstab_gen_loop.cu): the source p'(g) = r + beta * (p - omega *
// v), rounded op by op, preconditioned over whole Jacobi blocks, and the
// sink writing p' and y = M^-1 p'; CTAS CTAs of THREADS threads walk the
// tiles grid-stride, one std::thread per CUDA thread.
//
//   block_jacobi_emu IN OUT
//
// IN: int64 n, int32 bs, int32 threads, int32 ctas, float beta, float omega,
// then inv_t (ceil(n / bs) * bs * bs floats), r, p, v (n floats each).  OUT:
// p' and y (n floats each).
#include <stdio.h>
#include <stdlib.h>

#include <thread>
#include <vector>

#include "block_jacobi.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;

namespace {

// the P phase's source and sink, as bicgstab_gen_loop.cu writes them
struct PSource {
  const float* r;
  const float* p;
  const float* v;
  float beta;
  float omega;
  float at(int64_t g) const {
    return __fadd_rn(r[g], __fmul_rn(beta, __fsub_rn(p[g], __fmul_rn(omega, v[g]))));
  }
};

struct DirSink {
  float* d;
  float* w;
  void operator()(int64_t g, float dir, float y) const {
    d[g] = dir;
    w[g] = y;
  }
};

template <class T>
void take(FILE* f, T* out, size_t count) {
  if (fread(out, sizeof(T), count, f) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: block_jacobi_emu IN OUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  int64_t n;
  int32_t bs, threads, ctas;
  float beta, omega;
  take(in, &n, 1);
  take(in, &bs, 1);
  take(in, &threads, 1);
  take(in, &ctas, 1);
  take(in, &beta, 1);
  take(in, &omega, 1);
  const int64_t nb = (n + bs - 1) / bs;
  std::vector<float> inv_t(nb * bs * bs), r(n), p(n), v(n);
  take(in, inv_t.data(), inv_t.size());
  take(in, r.data(), n);
  take(in, p.data(), n);
  take(in, v.data(), n);
  fclose(in);
  std::vector<float> pn(n, NAN), y(n, NAN);
  blockDim.x = threads;
  gridDim.x = ctas;
  std::vector<std::barrier<>*> bars;
  std::vector<std::vector<float>> stages(ctas, std::vector<float>(threads, NAN));
  for (int c = 0; c < ctas; ++c) bars.push_back(new std::barrier<>(threads));
  std::vector<std::thread> pool;
  for (int c = 0; c < ctas; ++c)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, c, t] {
        threadIdx.x = t;
        blockIdx.x = c;
        cta_barrier = bars[c];
        const ogl::bj::Tiling tl = ogl::bj::tiling(n, bs);
        ogl::bj::apply_tiles(inv_t.data(), tl, PSource{r.data(), p.data(), v.data(), beta, omega},
                             DirSink{pn.data(), y.data()}, n, stages[c].data(), blockIdx.x,
                             gridDim.x);
      });
  for (auto& th : pool) th.join();
  for (auto* b : bars) delete b;
  FILE* out = fopen(argv[2], "wb");
  fwrite(pn.data(), 4, n, out);
  fwrite(y.data(), 4, n, out);
  fclose(out);
  return 0;
}
