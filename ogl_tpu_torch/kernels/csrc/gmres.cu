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
// Design (Arnoldi): one cooperative launch of one CTA per SM over the body
// in gmres_arnoldi.cuh (a slice of the rows per SM, the basis rows by bulk
// copies, a block's rows held in shared memory across the grid barrier
// where they fit, w's slice held for the whole step where it fits), with the
// plan of ogl_tpu_torch/kernels/gmres.py `arnoldi_plan`.
//
// Design (combine): the body of gmres_combine.cuh (a column group of 4
// entries per thread, its rows' loads issued in pairs before the adds) over
// a grid of the co-resident CTAs, grid-stride; each product and sum rounded
// in k order, as the twin writes it, so kernel and twin give the same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmres_arnoldi.cuh"
#include "gmres_combine.cuh"
#include "loop.cuh"

namespace cg = cooperative_groups;

namespace {

template <bool BF16>
__global__ void __launch_bounds__(ogl::arnoldi::kThreads, 1)
    gmres_arnoldi_kernel(const typename ogl::arnoldi::Elem<BF16>::T* __restrict__ V, int64_t ld,
                         float* __restrict__ w,
                         typename ogl::arnoldi::Elem<BF16>::T* __restrict__ vnext,
                         float* __restrict__ h, float* __restrict__ partials, int64_t n, int j,
                         float tiny, ogl::arnoldi::Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  ogl::arnoldi::step<BF16>(V, ld, w, vnext, h, partials, n, j, tiny, plan, smem, grid);
}

template <bool BF16>
__global__ void __launch_bounds__(ogl::combine::kThreads)
    gmres_combine_kernel(const typename ogl::combine::Cols<BF16>::T* __restrict__ V, int64_t ld,
                         const float* __restrict__ y, int j, float* __restrict__ out,
                         int64_t n) {
  ogl::combine::combine_groups<BF16>(
      V, ld, y, j, out, n, static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<int64_t>(gridDim.x) * blockDim.x);
}

const void* combine_kernel(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(&gmres_combine_kernel<true>)
              : reinterpret_cast<const void*>(&gmres_combine_kernel<false>);
}

const void* arnoldi_kernel(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(&gmres_arnoldi_kernel<true>)
              : reinterpret_cast<const void*>(&gmres_arnoldi_kernel<false>);
}

// The rows the bulk copies and the quad loads need: every row starts
// 16-byte aligned (the row stride a multiple of 4 float32 or 8 bfloat16
// entries) and holds at least n rounded up to 8 entries (the last slice's
// copies run into that padding).
bool bad_rows(int bf16, const void* V, int64_t ld, int64_t n) {
  return ((ld * (bf16 ? 2 : 4)) & 15) != 0 || ld < ((n + 7) & ~int64_t{7}) ||
         ogl::misaligned(V, 16);
}

// Allow the Arnoldi kernel `smem` bytes of dynamic shared memory, above the
// 48 KB default (before its occupancy query and its launch).
int allow_smem(int bf16, int64_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      arnoldi_kernel(bf16), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// The co-resident CTAs of an Arnoldi launch (bf16: the basis type) with
// `threads` per CTA and `smem` bytes of dynamic shared memory on the current
// device (one per SM where the plan's shared memory leaves room for one).
extern "C" int ogl_gmres_arnoldi_grid(int bf16, int threads, int64_t smem, int64_t* blocks) {
  if (threads != ogl::arnoldi::kThreads || smem < ogl::arnoldi::kFixedBytes ||
      smem > ogl::arnoldi::kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(bf16, smem);
  if (err != 0) return err;
  return ogl::coop_grid(arnoldi_kernel(bf16), threads, blocks, static_cast<size_t>(smem));
}

// One cooperative launch of `blocks` CTAs (at most kMaxCtas) of 544 threads
// with `smem` bytes of dynamic shared memory on `stream`: the
// orthogonalisation of w (n,) against V's rows 0..j (row stride ld, at least
// n rounded up to 8, in the basis type), V[j+1] written at `vnext`, h[0..j+1]
// at `h`; partials holds 2 * 8 * blocks floats.  The plan
// (kernels/gmres.py arnoldi_plan): CTA c owns entries [c * slice, (c + 1) *
// slice), `resident` rows of each block held, `stages` steps of copies in
// flight, w's slice held (w_resident), L2 policies on the rows not held
// (hint); smem must be its size.  With bf16, w becomes v_{j+1} in float32.
// Returns the launch's error code (0 = launched).
extern "C" int ogl_gmres_arnoldi(int bf16, const void* V, int64_t ld, float* w, void* vnext,
                                 float* h, float* partials, int64_t n, int j, float tiny,
                                 int64_t slice, int resident, int stages, int w_resident, int hint,
                                 int64_t blocks, int64_t smem, void* stream) {
  using ogl::arnoldi::Plan;
  const int elem = bf16 ? 2 : 4;
  const int chunk = ogl::arnoldi::kPieceBytes / elem;
  if (n < 1 || j < 0 || ld < n || blocks < 1 || blocks > ogl::arnoldi::kMaxCtas || V == nullptr ||
      w == nullptr || vnext == nullptr || h == nullptr || partials == nullptr || slice < 8 ||
      (slice & 7) != 0 || slice > INT32_MAX / 2 || blocks * slice < n || resident < 0 ||
      resident > ogl::arnoldi::kRows || stages < 2 || stages > ogl::arnoldi::kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{slice, chunk, static_cast<int>((slice + chunk - 1) / chunk), resident, stages,
                  w_resident != 0, hint != 0};
  if (smem != ogl::arnoldi::smem_bytes(plan, elem) || smem > ogl::arnoldi::kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bad_rows(bf16, V, ld, n) || ogl::misaligned(w, 16) || ogl::misaligned(vnext, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int err = allow_smem(bf16, smem);
  if (err != 0) return err;
  void* args[] = {&V, &ld, &w, &vnext, &h, &partials, &n, &j, &tiny, const_cast<Plan*>(&plan)};
  return ogl::coop_launch(arnoldi_kernel(bf16), blocks, ogl::arnoldi::kThreads, args, stream,
                          static_cast<size_t>(smem));
}

// The co-resident CTAs of 256 threads of the combine kernel (bf16: the
// basis type) on the current device: the grid ogl_gmres_combine is sized to.
extern "C" int ogl_gmres_combine_grid(int bf16, int64_t* blocks) {
  return ogl::coop_grid(combine_kernel(bf16), ogl::combine::kThreads, blocks);
}

// Launches `blocks` blocks of 256 threads on `stream`: out (n,) = the sum of
// y[k] * V[k] over k < j, in k order.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int ogl_gmres_combine(int bf16, const void* V, int64_t ld, const float* y, int j,
                                 float* out, int64_t n, int64_t blocks, void* stream) {
  if (n < 1 || j < 1 || ld < n || blocks < 1 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bad_rows(bf16, V, ld, n) || ogl::misaligned(out, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (bf16)
    gmres_combine_kernel<true><<<grid, ogl::combine::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(V), ld, y, j, out, n);
  else
    gmres_combine_kernel<false><<<grid, ogl::combine::kThreads, 0, s>>>(
        static_cast<const float*>(V), ld, y, j, out, n);
  return static_cast<int>(cudaGetLastError());
}
