// The pgm transfers of the AMG cycle for Hopper (piecewise-constant P, one
// aggregate per fine row):
//   ogl_pgm_restrict:     rc[c]  = sum of r[i] over the fine rows i of aggregate c
//   ogl_pgm_prolong_add:  out[i] = x[i] + ec[agg[i]]
//
// Replaces: no TPU kernel.  The reference runs them as XLA ops,
// `jax.ops.segment_sum` and `jnp.take` (ogl_tpu/precond/amg.py `_restrict`,
// `_prolong`, :350-367).  The port's earlier restriction, torch's
// `index_add_`, adds through float atomics on the card, in an order that
// changes from run to run: here each coarse row sums its own members in
// ascending row order from an aggregate table (members grouped by
// aggregate, CSR-style; built once per level on the host) and is written
// once, so the result is the same on every run.
//
// Bound: device-memory bandwidth.  Restriction reads r and the aggregate
// table once (n * 8 + (nc + 1) * 4 bytes) and writes nc floats; the
// prolongation reads x and agg once, ec (nc floats, gathered) and writes out:
// n * 12 + nc * 4 bytes.  One add per fine row.
//
// Design: one thread per coarse row (restriction; its members' reads of r are
// gathers, neighbouring in the fine rows an aggregate takes) or per fine row
// (prolongation), grid-stride grids of 256-thread blocks (amg_level.cuh
// `pgm_restrict_row`, `pgm_prolong_row`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "amg_level.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const int* __restrict__ starts, const int* __restrict__ members,
                    const float* __restrict__ r, float* __restrict__ rc, int64_t nc) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < nc;
       c += step)
    rc[c] = ogl::pgm_restrict_row(starts, members, r, c);
}

__global__ void __launch_bounds__(kThreads)
    prolong_kernel(const float* __restrict__ x, const float* __restrict__ ec,
                   const int* __restrict__ agg, float* __restrict__ out, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = ogl::pgm_prolong_row(x, ec, agg, i);
}

bool bad(int64_t rows, int64_t blocks) { return rows < 0 || blocks < 1 || blocks > INT32_MAX; }

}  // namespace

// starts (nc + 1,) and members (n,) int32: aggregate c's fine rows are
// members[starts[c] .. starts[c+1]), ascending; r (n,), rc (nc,) float32.
// Launches `blocks` blocks of 256 threads on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int ogl_pgm_restrict(const int* starts, const int* members, const float* r,
                                float* rc, int64_t nc, int64_t blocks, void* stream) {
  if (bad(nc, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return 0;
  restrict_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(starts, members, r, rc, nc);
  return static_cast<int>(cudaGetLastError());
}

// x, out (n,) float32 (out a buffer of its own), ec (nc,) float32, agg (n,)
// int32 with every entry in [0, nc).  As ogl_pgm_restrict.
extern "C" int ogl_pgm_prolong_add(const float* x, const float* ec, const int* agg, float* out,
                                   int64_t n, int64_t blocks, void* stream) {
  if (bad(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  prolong_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, ec, agg, out, n);
  return static_cast<int>(cudaGetLastError());
}
