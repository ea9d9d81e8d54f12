// The block-Jacobi variants of the general-BiCGStab loop kernel
// (bicgstab_gen_loop.cuh, bit kBlockJacobi), one per format: compiled apart
// from the other twelve so that the two halves build in parallel; their
// checks and launches are bicgstab_gen_loop.cu's.
#include "bicgstab_gen_loop.cuh"

const void* ogl::bicgstab_bj_loop_kernel(int variant) {
  switch (variant) {
    case kBlockJacobi: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<64>);
    case kBlockJacobi | kGdia:
      return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<66>);
    case kBlockJacobi | kXell:
      return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<68>);
    case kBlockJacobi | kEll: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<72>);
    case kBlockJacobi | kCsr: return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<80>);
    case kBlockJacobi | kSell:
      return reinterpret_cast<const void*>(bicgstab_gen_loop_kernel<96>);
    default: return nullptr;
  }
}
