// The entry points of the AMG loop kernel and its Dia outer's variants
// (amg_loop.cuh: the kernel, its phases and their design).  The mixed
// variants are built from amg_loop_{gdia,ell,csr}_{cg,ir}.cu, one nvcc each,
// in parallel.
#include "amg_loop.cuh"

OGL_AMG_LOOP_KERNELS(loop_kernel_dia_cg, 0)
OGL_AMG_LOOP_KERNELS(loop_kernel_dia_ir, ogl::amg::kIr)

namespace {

using namespace ogl::amg;

const void* kernel_of(int variant) {
  if (variant < 0 || (variant & ~(kBf16 | kIr | kOuterBits)) != 0) return nullptr;
  const bool ir = (variant & kIr) != 0;
  switch (variant & kOuterBits) {
    case 0: return ir ? loop_kernel_dia_ir(variant) : loop_kernel_dia_cg(variant);
    case kOuterGdia: return ir ? loop_kernel_gdia_ir(variant) : loop_kernel_gdia_cg(variant);
    case kOuterEll: return ir ? loop_kernel_ell_ir(variant) : loop_kernel_ell_cg(variant);
    case kOuterCsr: return ir ? loop_kernel_csr_ir(variant) : loop_kernel_csr_cg(variant);
    default: return nullptr;
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (with its static
// shared memory, past the 48 KB every kernel may take unasked).
int allow_smem(const void* kernel, int64_t smem) {
  if (smem < 0 || smem > kStageBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaGetLastError();
  return static_cast<int>(err);
}

// The outer operator's checks: its format's pointers, sizes and alignment.
int check_outer(int outer, const Outer& o, int64_t n) {
  if (outer == 0) {
    if (o.nd < 0 || o.nd > ogl::kMaxDiags || (o.nd > 0 && o.offsets == nullptr) ||
        o.coef == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (outer == kOuterGdia) {
    if (o.nd < 1 || o.nd > ogl::kGdiaMaxPlanes || o.aux == nullptr || o.offsets == nullptr ||
        o.coef == nullptr || o.rows * ogl::kGdiaLanes < n)
      return static_cast<int>(cudaErrorInvalidValue);
    if (ogl::misaligned(o.coef, 16) || ogl::misaligned(o.aux, 4))
      return static_cast<int>(cudaErrorMisalignedAddress);
  } else if (o.coef == nullptr || o.aux == nullptr || o.offsets == nullptr ||
             (o.tail_ptr != nullptr && (o.tail_cols == nullptr || o.tail_vals == nullptr)) ||
             (outer == kOuterCsr && o.tail_ptr != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// The grid of a loop launch of `variant` (bit 0: bfloat16 smoother
// coefficients; bit 1: the Richardson loop, else CG; bits 2-4: the outer
// operator Gdia, Ell or Csr, none: Dia, whose hierarchy is all Dia) with
// `threads` per block and `smem`
// bytes of dynamic shared memory on the current device: the blocks that fit
// on it at once (occupancy x SMs).  Fails with cudaErrorNotSupported on a
// device without cooperative launch.
extern "C" int ogl_amg_loop_grid(int variant, int threads, int64_t smem, int64_t* blocks) {
  const void* kernel = kernel_of(variant);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  return ogl::coop_grid(kernel, threads, blocks, static_cast<size_t>(smem));
}

// One cooperative launch of `blocks` blocks of `threads` with `smem` bytes
// of dynamic shared memory on `stream`: the whole solve of `variant` from the
// set-up's x and r = b - A x (updated in place), ||r||_1 (absr) and the norm
// factor nf (0-d device scalars).  table: `levels` rows of 24 int64 words
// (kernels/amg_loop.py LevelTable), on the device; outer: 8 int64 words on
// the HOST, the fine operator of the variant's format (coef, aux, offsets,
// nd, rows, tail_ptr, tail_cols, tail_vals: Dia data, -, offsets, nd; Gdia
// vals, lidx, plane offsets, planes, block rows; Ell vals, cols,
// warp_slots, and a Hybrid's tail; Csr vals, cols, row_ptr), float32; z: a
// scratch vector apart from r; p (all zeros), pn and q: CG scratch vectors
// (null for IR); partials: 3 * blocks floats; record: 4 words.  vec != 0
// takes the float4 branches of K2n, of the Dia and Gdia K1 and IR residual,
// and lets level 0 take its row quads and staged windows where the table
// allows them (n % 4 == 0, the operator and every vector 16-byte aligned).
// smem: at least the table's staged levels need (LevelTable.smem).  A grid
// larger than the co-resident blocks is refused by the launch
// (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error code (0
// = launched).
extern "C" int ogl_amg_loop(int variant, const int64_t* table, int levels, const int64_t* outer,
                            float* x, float* r, float* z, float* p, float* pn, float* q,
                            const float* absr, const float* nf, float* partials, float* record,
                            int64_t n, int vec, float relax, int sweeps, float tol,
                            float rel_tol, int min_iter, int max_iter, int frequency,
                            int threads, int64_t blocks, int64_t smem, void* stream) {
  const void* kernel = kernel_of(variant);
  const bool cg_loop = (variant & kIr) == 0;
  if (kernel == nullptr || table == nullptr || outer == nullptr || levels < 2 ||
      levels > kMaxLevels || n < 1 || sweeps < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 || max_iter < 0 ||
      frequency < 1 || max_iter > INT32_MAX - frequency || x == nullptr || r == nullptr ||
      z == nullptr || (cg_loop && (p == nullptr || pn == nullptr || q == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Outer o{};
  o.coef = reinterpret_cast<const float*>(outer[0]);
  o.aux = reinterpret_cast<const void*>(outer[1]);
  o.offsets = reinterpret_cast<const int*>(outer[2]);
  o.nd = static_cast<int>(outer[3]);
  o.rows = outer[4];
  o.tail_ptr = reinterpret_cast<const int*>(outer[5]);
  o.tail_cols = reinterpret_cast<const int*>(outer[6]);
  o.tail_vals = reinterpret_cast<const float*>(outer[7]);
  int err = check_outer(variant & kOuterBits, o, n);
  if (err != 0) return err;
  if (vec && ((n & 3) != 0 || ogl::misaligned(o.coef, 16) || ogl::misaligned(x, 16) ||
              ogl::misaligned(r, 16) || ogl::misaligned(z, 16) ||
              (cg_loop && (ogl::misaligned(pn, 16) || ogl::misaligned(q, 16) ||
                           ogl::misaligned(p, 16)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  err = allow_smem(kernel, smem);
  if (err != 0) return err;
  Vectors v{x, r, z, p, pn, q};
  Scalars s{absr, nf, partials, record};
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  void* args[] = {&table, &levels, &o, &v, &s, &n, &vec, &relax, &sweeps, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream, static_cast<size_t>(smem));
}
