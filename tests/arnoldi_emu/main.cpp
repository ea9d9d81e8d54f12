// Runs one Arnoldi step of csrc/gmres_arnoldi.cuh on the CPU stand-in (one
// std::thread per CUDA thread) and holds it against blocked modified
// Gram-Schmidt in float64 on the stored rows:
//
//   emu BF16 N J CTAS SLICE RESIDENT STAGES W_RESIDENT HINT SEED
//
// rows 0..J orthonormal-ish (random unit rows) with w = V^T c + e; the
// padding of every row and every row past J holds NaN, so a read of either
// shows.  Prints one line ending in "ok" (exit 0) or "FAIL" (exit 1): h
// within 1e-4 of ||w||, v within 1e-5 (float32; bfloat16 within one ulp of
// the float64 v and w within 1e-5), the padding of the new row untouched.
#include <stdio.h>
#include <stdlib.h>

#include <random>
#include <thread>
#include <vector>

#include "gmres_arnoldi.cuh"

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

static float bf(unsigned short u) { return __uint_as_float(static_cast<unsigned>(u) << 16); }

template <bool BF16>
int run(int64_t n, int j, int ctas, int64_t slice, int resident, int stages, int w_res, int hint,
        int seed) {
  using T = typename ogl::arnoldi::Elem<BF16>::T;
  const int elem = sizeof(T);
  const int64_t ld = (n + 7) / 8 * 8;
  const int mp = (j + 2 + 7) / 8 * 8 + 8;
  std::mt19937 rng(seed);
  std::normal_distribution<double> nd;
  std::vector<T> V(mp * ld);
  for (auto& x : V) {
    if constexpr (BF16)
      x.v = 0x7fc0;
    else
      x = NAN;
  }
  std::vector<double> rows((j + 1) * n);
  for (int r = 0; r <= j; ++r) {
    std::vector<double> v(n);
    double nrm = 0;
    for (auto& x : v) {
      x = nd(rng);
      nrm += x * x;
    }
    for (int64_t i = 0; i < n; ++i) {
      const float f = static_cast<float>(v[i] / sqrt(nrm));
      if constexpr (BF16) {
        V[r * ld + i] = __float2bfloat16_rn(f);
        rows[r * n + i] = bf(V[r * ld + i].v);
      } else {
        V[r * ld + i] = f;
        rows[r * n + i] = f;
      }
    }
  }
  std::vector<float> w(n), h(j + 2, -1.0f), partials(2 * 8 * ctas, NAN);
  for (auto& x : w) x = static_cast<float>(nd(rng));
  for (int r = 0; r <= j; ++r) {
    const double c = 0.3 * nd(rng);
    for (int64_t i = 0; i < n; ++i) w[i] += static_cast<float>(c * rows[r * n + i]);
  }
  std::vector<double> wd(w.begin(), w.end());
  double w0 = 0;
  for (double x : wd) w0 += x * x;
  w0 = sqrt(w0);
  std::vector<double> href(j + 2);
  for (int k0 = 0; k0 <= j; k0 += 8) {
    const int cnt = std::min(8, j + 1 - k0);
    double hb[8];
    for (int b = 0; b < cnt; ++b) {
      double s = 0;
      for (int64_t i = 0; i < n; ++i) s += rows[(k0 + b) * n + i] * wd[i];
      hb[b] = href[k0 + b] = s;
    }
    for (int64_t i = 0; i < n; ++i) {
      double s = 0;
      for (int b = 0; b < cnt; ++b) s += hb[b] * rows[(k0 + b) * n + i];
      wd[i] -= s;
    }
  }
  double nrm = 0;
  for (double x : wd) nrm += x * x;
  nrm = sqrt(nrm);
  href[j + 1] = nrm;

  const int chunk = ogl::arnoldi::kPieceBytes / elem;
  const ogl::arnoldi::Plan plan{slice,    chunk,  static_cast<int>((slice + chunk - 1) / chunk),
                                resident, stages, w_res,
                                hint};
  const int64_t smem = ogl::arnoldi::smem_bytes(plan, elem);
  blockDim.x = ogl::arnoldi::kThreads;
  gridDim.x = ctas;
  ogl::tma::Engine engine;
  ogl::tma::engine = &engine;
  engine.src_lo = reinterpret_cast<const unsigned char*>(V.data());
  engine.src_hi = reinterpret_cast<const unsigned char*>(V.data() + (j + 1) * ld);
  std::thread copier([&] { engine.run(); });
  std::barrier<> grid(ctas * ogl::arnoldi::kThreads);
  grid_barrier = &grid;
  std::vector<Cta> cta(ctas);
  std::vector<std::vector<unsigned char>> mem(ctas);
  std::vector<std::barrier<>*> owned;
  for (int c = 0; c < ctas; ++c) {
    cta[c].bar = new std::barrier<>(ogl::arnoldi::kThreads);
    owned.push_back(cta[c].bar);
    for (auto& wb : cta[c].warp_bars) owned.push_back(wb = new std::barrier<>(32));
    mem[c].assign(smem + 128, 0xff);
  }
  std::vector<std::thread> threads;
  for (int c = 0; c < ctas; ++c)
    for (int t = 0; t < ogl::arnoldi::kThreads; ++t)
      threads.emplace_back([&, c, t] {
        threadIdx.x = t;
        blockIdx.x = c;
        this_cta = &cta[c];
        emu_smem_base = reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(mem[c].data()) + 127) & ~static_cast<uintptr_t>(127));
        cooperative_groups::grid_group g;
        ogl::arnoldi::step<BF16>(V.data(), ld, w.data(), V.data() + (j + 1) * ld, h.data(),
                                 partials.data(), n, j, 1e-12f, plan, emu_smem_base, g);
      });
  for (auto& t : threads) t.join();
  {
    std::lock_guard<std::mutex> g(engine.mu);
    engine.stop = true;
    engine.cv.notify_all();
  }
  copier.join();
  for (auto* b : owned) delete b;

  int bad = 0;
  double herr = 0, verr = 0;
  for (int k = 0; k <= j + 1; ++k) herr = std::max(herr, fabs(h[k] - href[k]) / w0);
  if (!(herr <= 1e-4)) ++bad;
  for (int64_t i = 0; i < n; ++i) {
    const double want = wd[i] / nrm;
    double got;
    if constexpr (BF16) {
      got = bf(V[(j + 1) * ld + i].v);
      if (!(fabs(w[i] - want) <= 1e-5)) ++bad;
    } else {
      got = V[(j + 1) * ld + i];
    }
    const double tol = BF16 ? fabs(want) / 128 + 1e-6 : 1e-5;
    if (!(fabs(got - want) <= tol)) ++bad;
    verr = std::max(verr, fabs(got - want));
  }
  for (int64_t i = n; i < ld; ++i) {
    if constexpr (BF16) {
      if (V[(j + 1) * ld + i].v != 0x7fc0) ++bad;
    } else {
      if (!std::isnan(V[(j + 1) * ld + i])) ++bad;
    }
  }
  printf("%s n %ld j %d ctas %d slice %ld resident %d stages %d w_resident %d hint %d: "
         "h err %.2e, v err %.2e, %lu copies -> %s\n",
         BF16 ? "bfloat16" : "float32", static_cast<long>(n), j, ctas, static_cast<long>(slice),
         resident, stages, w_res, hint, herr, verr, static_cast<unsigned long>(engine.copies),
         bad ? "FAIL" : "ok");
  return bad ? 1 : 0;
}

int main(int argc, char** argv) {
  if (argc != 11) {
    fprintf(stderr, "usage: emu BF16 N J CTAS SLICE RESIDENT STAGES W_RESIDENT HINT SEED\n");
    return 2;
  }
  const int64_t n = atoll(argv[2]), slice = atoll(argv[5]);
  const int j = atoi(argv[3]), ctas = atoi(argv[4]), r = atoi(argv[6]), d = atoi(argv[7]),
            wr = atoi(argv[8]), hint = atoi(argv[9]), seed = atoi(argv[10]);
  if (ctas * slice < n || slice % 8 != 0) {
    fprintf(stderr, "the slices do not cover n\n");
    return 2;
  }
  return atoi(argv[1]) ? run<true>(n, j, ctas, slice, r, d, wr, hint, seed)
                       : run<false>(n, j, ctas, slice, r, d, wr, hint, seed);
}
