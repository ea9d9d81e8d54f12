// Runs the AMG level bodies of csrc/amg_level.cuh as their launches run them
// (amg_ell_smooth.cu, amg_gdia_smooth.cu, amg_transfer.cu): one CUDA thread
// per Ell row, per Gdia row quad, per coarse row of the restriction and per
// fine row of the prolongation.  The bodies never synchronise, so the CUDA
// threads run one after another.
//
//   amg_level_emu IN OUT
//
// IN starts with int32 mode:
//   0 Ell:  int64 n, int32 K, bf16, sweep, float relax, then cols (K * n
//           int32), vals (K * n of 4 or 2 bytes), warp_slots (ceil(n / 32)
//           int32), x, b, invd (n floats each);
//   1 Gdia: int64 n, int32 np, bf16, sweep, float relax, then qoffs (np
//           int32), vals (np * R * 128 of 4 or 2 bytes, R = ceil(n / 128)),
//           lidx (np * R * 128 int8), x, b, invd (n floats each);
//   2 restrict: int64 n, nc, then starts (nc + 1 int32), members (n int32),
//           r (n floats);
//   3 prolong:  int64 n, nc, then agg (n int32), x (n), ec (nc floats).
// OUT: the result (n floats; nc for the restriction), NaN where nothing was
// stored.
#include <stdio.h>
#include <stdlib.h>

#include <vector>

#include "amg_level.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;

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

template <bool kSweep, typename T>
void ell(const std::vector<int>& cols, const std::vector<unsigned char>& raw,
         const std::vector<int>& slots, const std::vector<float>& x,
         const std::vector<float>& b, const std::vector<float>& invd, float relax, float* out,
         int64_t n) {
  const ogl::EllOperandsOf<T> m{cols.data(), reinterpret_cast<const T*>(raw.data()),
                                slots.data(), nullptr, nullptr, nullptr};
  for (int64_t i = 0; i < n; ++i)
    out[i] = ogl::ell_smooth_row<kSweep>(m, x.data(), b.data(), invd.data(), relax, i, n);
}

template <bool kSweep, typename T>
void gdia(const std::vector<unsigned char>& raw, const std::vector<int8_t>& lidx,
          const std::vector<int>& qoffs, int64_t r, const std::vector<float>& x,
          const std::vector<float>& b, const std::vector<float>& invd, float relax, float* out,
          int64_t n) {
  for (int64_t t = 0; t < (n + 3) / 4; ++t)
    ogl::gdia_smooth_quad<kSweep>(reinterpret_cast<const T*>(raw.data()), lidx.data(),
                                  qoffs.data(), static_cast<int>(qoffs.size()), r * 128,
                                  x.data(), b.data(), invd.data(), relax, out, t, n);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: amg_level_emu IN OUT\n");
    return 2;
  }
  in = fopen(argv[1], "rb");
  const int mode = one<int32_t>();
  const int64_t n = one<int64_t>();
  std::vector<float> out;
  if (mode == 0 || mode == 1) {
    const int k = one<int32_t>(), bf16 = one<int32_t>(), sweep = one<int32_t>();
    const float relax = one<float>();
    const size_t width = bf16 ? 2 : 4;
    out.assign(n, NAN);
    if (mode == 0) {
      const auto cols = take<int>(static_cast<size_t>(k) * n);
      const auto raw = take<unsigned char>(static_cast<size_t>(k) * n * width);
      const auto slots = take<int>((n + 31) / 32);
      const auto x = take<float>(n), b = take<float>(n), invd = take<float>(n);
      if (bf16)
        (sweep ? ell<true, __nv_bfloat16> : ell<false, __nv_bfloat16>)(
            cols, raw, slots, x, b, invd, relax, out.data(), n);
      else
        (sweep ? ell<true, float> : ell<false, float>)(cols, raw, slots, x, b, invd, relax,
                                                       out.data(), n);
    } else {
      const int64_t r = (n + 127) / 128;
      const auto qoffs = take<int>(k);
      const auto raw = take<unsigned char>(static_cast<size_t>(k) * r * 128 * width);
      const auto lidx = take<int8_t>(static_cast<size_t>(k) * r * 128);
      const auto x = take<float>(n), b = take<float>(n), invd = take<float>(n);
      if (bf16)
        (sweep ? gdia<true, __nv_bfloat16> : gdia<false, __nv_bfloat16>)(
            raw, lidx, qoffs, r, x, b, invd, relax, out.data(), n);
      else
        (sweep ? gdia<true, float> : gdia<false, float>)(raw, lidx, qoffs, r, x, b, invd, relax,
                                                         out.data(), n);
    }
  } else if (mode == 2) {
    const int64_t nc = one<int64_t>();
    const auto starts = take<int>(nc + 1), members = take<int>(n);
    const auto r = take<float>(n);
    out.assign(nc, NAN);
    for (int64_t c = 0; c < nc; ++c)
      out[c] = ogl::pgm_restrict_row(starts.data(), members.data(), r.data(), c);
  } else {
    const int64_t nc = one<int64_t>();
    const auto agg = take<int>(n);
    const auto x = take<float>(n), ec = take<float>(nc);
    out.assign(n, NAN);
    for (int64_t i = 0; i < n; ++i)
      out[i] = ogl::pgm_prolong_row(x.data(), ec.data(), agg.data(), i);
  }
  fclose(in);
  FILE* f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return 0;
}
