// The memory operations of the ILU family's triangular kernels that plain
// C++ does not name, as PTX for sm_90a:
//   * kernel 2 (tri_levels.cuh): a row's ready word read and written at
//     device scope (relaxed: a 64-bit word holds the row's value and its
//     epoch, so one single-copy-atomic load brings both); the global timer
//     that bounds a wait;
//   * kernel 1 (tri_sweep.cuh): the proxy fence before bulk copies overwrite
//     shared memory that plain loads and stores used.
// tests/cuda_emu/tri_sync.cuh stands in for this header on the CPU.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ogl {
namespace tri {

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Nanoseconds of the device's global timer.
__device__ __forceinline__ uint64_t clock_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Before a bulk copy lands in shared memory that the generic proxy (plain
// loads and stores) touched: orders those accesses before the copy's writes.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tri
}  // namespace ogl
