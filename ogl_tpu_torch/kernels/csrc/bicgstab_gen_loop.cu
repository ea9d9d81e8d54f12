// The general-BiCGStab loop kernel's entry points and its identity and
// scalar-Jacobi variants; the kernel itself, its phases and its design are in
// bicgstab_gen_loop.cuh, its block-Jacobi variants in bicgstab_bj_loop.cu.
#include "bicgstab_gen_loop.cuh"

namespace {

const void* loop_kernel(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<0>);
    case 1: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<1>);
    case 2: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<2>);
    case 3: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<3>);
    case 4: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<4>);
    case 5: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<5>);
    case 8: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<8>);
    case 9: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<9>);
    case 16: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<16>);
    case 17: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<17>);
    case 32: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<32>);
    case 33: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<33>);
    default: return ogl::bicgstab_bj_loop_kernel(variant);
  }
}

// The dynamic shared memory of `variant`'s launch: the Xell ring, set on the
// kernel once (before its first occupancy query or launch), or none.
int ring_of(int variant, size_t* smem) {
  *smem = 0;
  if ((variant & kXell) == 0) return 0;
  static const cudaError_t err[3] = {ogl::allow_ring(loop_kernel(kXell)),
                                     ogl::allow_ring(loop_kernel(kXell | kJacobi)),
                                     ogl::allow_ring(loop_kernel(kXell | kBlockJacobi))};
  *smem = ogl::kRingBytes;
  return static_cast<int>(err[(variant & kBlockJacobi) ? 2 : (variant & kJacobi)]);
}

// The checks and the launch every entry point shares.
int launch(int variant, const Matrix& m, const ogl::XellOperands& xm, const Gather& gm,
           const int* offsets, const float* invd, int bs,
           const float* rhat, const Vectors& vs, const Scalars& sc, int64_t n, float tol,
           float rel_tol, int min_iter, int max_iter, int frequency, int vec, int threads,
           int64_t blocks, void* stream) {
  const void* kernel = loop_kernel(variant);
  const bool jacobi = (variant & kJacobi) != 0;
  const bool bj = (variant & kBlockJacobi) != 0;
  const bool dia = (variant & (kGdia | kXell | kEll | kCsr | kSell)) == 0;
  if (kernel == nullptr || n < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1 || blocks > INT32_MAX || min_iter < 0 || max_iter < 0 ||
      frequency < 1 || max_iter > INT32_MAX - frequency || (jacobi && invd == nullptr) ||
      rhat == nullptr ||
      (bj && (invd == nullptr || vs.y == nullptr || vs.z == nullptr ||
              bs < ogl::bj::kMinBlock || bs > ogl::bj::kMaxBlock || threads < bs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* vectors[] = {vs.x, vs.r, vs.p, vs.pn, vs.v, vs.vn, vs.s, vs.t, rhat};
  bool bad = false;
  for (const void* a : vectors) bad = bad || ogl::misaligned(a, 16);
  bad = bad || (jacobi && ogl::misaligned(invd, 16)) ||
        (bj && (ogl::misaligned(vs.y, 16) || ogl::misaligned(vs.z, 16)));
  if (vec && (bad || (dia && ((n & 3) != 0 || ogl::misaligned(m.coef, 16)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  size_t smem = 0;
  const int ring = ring_of(variant, &smem);
  if (ring != 0) return ring;
  ogl::Criterion c{tol, rel_tol, min_iter, max_iter, frequency};
  const float* inv = (jacobi || bj) ? invd : nullptr;
  Matrix mm = m;
  ogl::XellOperands xx = xm;
  Gather gg = gm;
  Vectors vv = vs;
  Scalars ss = sc;
  void* args[] = {&mm, &xx, &gg, &offsets, &inv, &bs, &rhat, &vv, &ss, &n, &vec, &c};
  return ogl::coop_launch(kernel, blocks, threads, args, stream, smem);
}

}  // namespace

// The grid of a loop launch of `variant` (bit 0: Jacobi, bit 1: Gdia, bit
// 2: Xell, bit 3: Ell, bit 4: Csr, bit 5: Sell, bit 6: block Jacobi) with `threads` per block
// (512 for Xell, the band body's) on the current device: the blocks that fit
// on it at once (occupancy x SMs, with the Xell ring).  Fails with
// cudaErrorNotSupported on a device without cooperative launch.
extern "C" int ogl_bicgstab_gen_loop_grid(int variant, int threads, int64_t* blocks) {
  const void* kernel = loop_kernel(variant);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      ((variant & kXell) && threads != ogl::kBandThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const int ring = ring_of(variant, &smem);
  if (ring != 0) return ring;
  return ogl::coop_grid(kernel, threads, blocks, smem);
}

// One cooperative launch of `blocks` blocks of `threads` on `stream`: the
// whole general BiCGStab loop of `variant`.  Dia: coef = data (nd, n), lidx
// null, offsets the nd diagonal offsets, rows ignored.  Gdia: coef = vals
// (nd, rows, 128), 16-byte aligned, lidx the int8 lanes of the same shape,
// 4-byte aligned, offsets the nd plane block-row offsets.  invd the Jacobi
// inverse diagonal (variants with bit 0), or the transposed block inverses
// (nb, bs, bs) of bs rows each (bit 6; bs from 2 to 32; else ignored); rhat
// the shadow residual; x and r (r = b - A x0) are updated in place; p and v
// are scratch vectors of zeros, pn, vn, s and t scratch vectors, y and z
// too with bit 6 (else ignored); rho (= rhat.r), absr
// (||r||_1) and nf are 0-d device scalars; partials holds 5 * blocks floats; record receives 4
// words.  vec != 0 takes the row-quad branches: every vector (and, for Dia,
// data, with n % 4 == 0) 16-byte aligned.  A grid larger than the
// co-resident blocks is refused by the launch
// (cudaErrorCooperativeLaunchTooLarge).  Returns the launch's error code (0
// = launched).
extern "C" int ogl_bicgstab_gen_loop(int variant, const float* coef, const int8_t* lidx,
                                     const int* offsets, int nd, int64_t rows,
                                     const float* invd, int bs, const float* rhat, float* x,
                                     float* r, float* p, float* pn, float* v, float* vn,
                                     float* s, float* t, float* y, float* z, const float* rho,
                                     const float* absr, const float* nf, float* partials,
                                     float* record, int64_t n,
                                     float tol, float rel_tol, int min_iter, int max_iter,
                                     int frequency, int vec, int threads, int64_t blocks,
                                     void* stream) {
  const bool gdia = (variant & kGdia) != 0;
  if ((variant & (kXell | kEll | kCsr | kSell)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gdia ? (nd < 1 || nd > ogl::kGdiaMaxPlanes || lidx == nullptr || rows * 128 < n)
           : (nd < 0 || nd > ogl::kMaxDiags))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gdia && (ogl::misaligned(coef, 16) || ogl::misaligned(lidx, 4)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(variant, Matrix{coef, lidx, nd, rows}, ogl::XellOperands{}, Gather{},
                offsets, invd, bs, rhat, Vectors{x, r, p, pn, v, vn, s, t, y, z},
                Scalars{rho, absr, nf, partials, record}, n, tol, rel_tol, min_iter, max_iter,
                frequency, vec, threads, blocks, stream);
}

// The same on an Xell matrix (`variant` with bit 2; threads = 512): vals,
// ll, bbT (nt, K, 128, 128), vals and ll 16-byte aligned, bbT 4-byte
// aligned, and the spill's row CSR (sp_ptr NULL without spill) in place of
// the Dia or Gdia operands; vec != 0 needs every vector 16-byte aligned
// (not n % 4 == 0).
extern "C" int ogl_bicgstab_gen_loop_xell(int variant, const float* vals, const int8_t* ll,
                                          const int16_t* bbT, int n_slots, int c_left,
                                          const int* sp_ptr, const int* sp_cols,
                                          const int* sp_gidx, const float* sp_vals,
                                          const float* invd, int bs, const float* rhat, float* x,
                                          float* r, float* p, float* pn, float* v, float* vn,
                                          float* s, float* t, float* y, float* z,
                                          const float* rho, const float* absr, const float* nf,
                                          float* partials,
                                          float* record, int64_t n, float tol, float rel_tol,
                                          int min_iter, int max_iter, int frequency, int vec,
                                          int threads, int64_t blocks, void* stream) {
  if ((variant & ~kPreconditioners) != kXell || threads != ogl::kBandThreads || n_slots < 1 ||
      c_left < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ogl::misaligned(vals, 16) || ogl::misaligned(ll, 16) || ogl::misaligned(bbT, 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const ogl::XellOperands xm{vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals};
  return launch(variant, Matrix{nullptr, nullptr, 0, 0}, xm, Gather{}, nullptr, invd, bs,
                rhat, Vectors{x, r, p, pn, v, vn, s, t, y, z},
                Scalars{rho, absr, nf, partials, record}, n, tol, rel_tol, min_iter, max_iter,
                frequency, vec, threads, blocks, stream);
}

// The same on an Ell matrix (`variant` with bit 3): cols and vals (K, n),
// warp_slots (ceil(n / 32),), each at most K, and, for a Hybrid matrix with
// a tail, tail_ptr (n + 1,), tail_cols and tail_vals (tail_ptr null: no
// tail) in place of the Dia or Gdia operands; vec != 0 needs every vector
// 16-byte aligned (not n % 4 == 0: the update takes the last rows one by
// one).
extern "C" int ogl_bicgstab_gen_loop_ell(int variant, const int* cols, const float* vals,
                                         const int* warp_slots, const int* tail_ptr,
                                         const int* tail_cols, const float* tail_vals,
                                         const float* invd, int bs, const float* rhat, float* x,
                                         float* r, float* p, float* pn, float* v, float* vn,
                                         float* s, float* t, float* y, float* z,
                                         const float* rho, const float* absr, const float* nf,
                                         float* partials,
                                         float* record, int64_t n, float tol, float rel_tol,
                                         int min_iter, int max_iter, int frequency, int vec,
                                         int threads, int64_t blocks, void* stream) {
  if ((variant & ~kPreconditioners) != kEll || cols == nullptr || vals == nullptr ||
      warp_slots == nullptr ||
      (tail_ptr != nullptr && (tail_cols == nullptr || tail_vals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.ell = ogl::EllOperands{cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals};
  return launch(variant, Matrix{nullptr, nullptr, 0, 0}, ogl::XellOperands{}, gm, nullptr,
                invd, bs, rhat, Vectors{x, r, p, pn, v, vn, s, t, y, z},
                Scalars{rho, absr, nf, partials, record}, n, tol, rel_tol, min_iter, max_iter,
                frequency, vec, threads, blocks, stream);
}

// The same on a Csr matrix, or a device Coo (`variant` with bit 4): row_ptr
// (n + 1,), cols and vals (nnz,) in place of the Dia or Gdia operands; vec
// as for Ell.
extern "C" int ogl_bicgstab_gen_loop_csr(int variant, const int* row_ptr, const int* cols,
                                         const float* vals, const float* invd, int bs,
                                         const float* rhat, float* x, float* r, float* p,
                                         float* pn, float* v, float* vn, float* s, float* t,
                                         float* y, float* z, const float* rho,
                                         const float* absr, const float* nf, float* partials,
                                         float* record, int64_t n, float tol,
                                         float rel_tol, int min_iter, int max_iter,
                                         int frequency, int vec, int threads, int64_t blocks,
                                         void* stream) {
  if ((variant & ~kPreconditioners) != kCsr || row_ptr == nullptr || cols == nullptr ||
      vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.csr = ogl::CsrOperands{row_ptr, cols, vals};
  return launch(variant, Matrix{nullptr, nullptr, 0, 0}, ogl::XellOperands{}, gm, nullptr,
                invd, bs, rhat, Vectors{x, r, p, pn, v, vn, s, t, y, z},
                Scalars{rho, absr, nf, partials, record}, n, tol, rel_tol, min_iter, max_iter,
                frequency, vec, threads, blocks, stream);
}

// The same on a Sell matrix (`variant` with bit 5): the bucket table (nb,
// 3) int64, slice_buckets and slice_widths (slots / C,), slot_rows (slots,)
// (every row once, pad slots n), cols and vals (stored,); vec as for Ell.
extern "C" int ogl_bicgstab_gen_loop_sell(
    int variant, const long long* table, int nb, const unsigned char* slice_buckets,
    const int* slice_widths, const int* slot_rows, const int* cols, const float* vals,
    int64_t slots, int slice_height, const float* invd, int bs, const float* rhat, float* x,
    float* r, float* p, float* pn, float* v, float* vn, float* s, float* t, float* y, float* z,
    const float* rho, const float* absr, const float* nf, float* partials, float* record,
    int64_t n, float tol, float rel_tol, int min_iter, int max_iter, int frequency, int vec,
    int threads, int64_t blocks, void* stream) {
  if ((variant & ~kPreconditioners) != kSell || nb < 1 || nb > ogl::kSellMaxBuckets ||
      slice_height < 1 || slots < n || slots % slice_height != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Gather gm{};
  gm.sell = ogl::SellOperands{table, nb, slice_buckets, slice_widths, slot_rows, cols, vals,
                              slots, slice_height};
  return launch(variant, Matrix{nullptr, nullptr, 0, 0}, ogl::XellOperands{}, gm, nullptr,
                invd, bs, rhat, Vectors{x, r, p, pn, v, vn, s, t, y, z},
                Scalars{rho, absr, nf, partials, record}, n, tol, rel_tol, min_iter, max_iter,
                frequency, vec, threads, blocks, stream);
}
