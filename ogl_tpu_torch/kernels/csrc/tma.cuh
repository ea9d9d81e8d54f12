// Hopper's bulk copies (the Tensor Memory Accelerator's 1-D form) and the
// shared-memory barriers they complete on, as PTX for sm_90a.
//
// One thread issues a copy of a contiguous run of bytes from device memory
// into shared memory; the hardware moves it and counts its bytes off the
// barrier's transaction count, so many kilobytes are in flight per SM at no
// register cost.  A barrier's phase completes when its one arrival
// (arrive_expect_tx, which also sets the bytes to expect) and all those bytes
// have come; waiters poll it by phase parity (0 for its first use, then 1,
// 0, ...).  Addresses and sizes of a copy are multiples of 16 bytes.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier expecting one arrival per phase.  fence_init() after
// the last init, then a __syncthreads, before any thread uses them.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread, once no thread waits on the barrier any more (before the
// memory is used for anything else or initialised again).
__device__ __forceinline__ void bar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The arrival of the barrier's phase, expecting `bytes` of copies on it (0:
// the phase completes at once).  Issued before the copies.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival (a barrier initialised for several, no bytes expected).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Every thread that reads the copied bytes: until the phase of `parity` has
// completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The issuing thread's cross-proxy fence before its bulk copies overwrite
// shared memory that plain loads and stores last read or wrote.
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// L2 policies for a copy's lines: kept before other lines (a first read
// whose bytes are read again soon), or dropped first (their last read).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// `bytes` from device memory at `src` into this CTA's shared memory at `dst`,
// completing on `bar`.
__device__ __forceinline__ void copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same with an L2 policy for the lines it reads.
__device__ __forceinline__ void copy_hint(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

}  // namespace tma
}  // namespace ogl
