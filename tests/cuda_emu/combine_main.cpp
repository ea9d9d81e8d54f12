// Runs csrc/gmres_combine.cuh as the standalone combine launch runs it
// (gmres.cu): CTAS CTAs of THREADS threads walk the column groups
// grid-stride.  The body never synchronises, so the CUDA threads run one
// after another.
//
//   combine_emu IN OUT
//
// IN: int32 bf16, int64 n, int64 ld, int32 j, int32 threads, int32 ctas,
// then y (j floats) and the j rows of V (j * ld entries of 4 or 2 bytes).
// OUT: ld floats: acc at the first n, the rest as the output buffer was
// (NaN), so a store past n shows.
#include <stdio.h>
#include <stdlib.h>

#include <vector>

#include "gmres_combine.cuh"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::barrier<>* cta_barrier;

namespace {

template <class T>
void take(FILE* f, T* out, size_t count) {
  if (fread(out, sizeof(T), count, f) != count) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
}

template <bool BF16>
void run(const std::vector<unsigned char>& V, int64_t ld, const std::vector<float>& y, int j,
         float* out, int64_t n) {
  using T = typename ogl::combine::Cols<BF16>::T;
  const T* rows = reinterpret_cast<const T*>(V.data());
  for (unsigned c = 0; c < gridDim.x; ++c)
    for (unsigned t = 0; t < blockDim.x; ++t) {
      blockIdx.x = c;
      threadIdx.x = t;
      ogl::combine::combine_groups<BF16>(
          rows, ld, y.data(), j, out, n, static_cast<int64_t>(c) * blockDim.x + t,
          static_cast<int64_t>(gridDim.x) * blockDim.x);
    }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: combine_emu IN OUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  int32_t bf16, j, threads, ctas;
  int64_t n, ld;
  take(in, &bf16, 1);
  take(in, &n, 1);
  take(in, &ld, 1);
  take(in, &j, 1);
  take(in, &threads, 1);
  take(in, &ctas, 1);
  std::vector<float> y(j);
  take(in, y.data(), j);
  // 16-byte aligned rows, as the basis the kernel takes
  std::vector<unsigned char> V(static_cast<size_t>(j) * ld * (bf16 ? 2 : 4) + 16);
  take(in, V.data(), V.size() - 16);
  fclose(in);
  std::vector<float> out(ld, NAN);
  blockDim.x = threads;
  gridDim.x = ctas;
  if (bf16)
    run<true>(V, ld, y, j, out.data(), n);
  else
    run<false>(V, ld, y, j, out.data(), n);
  FILE* f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, ld, f);
  fclose(f);
  return 0;
}
