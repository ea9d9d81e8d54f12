// csrc/tri_sync.cuh on the CPU: the device-scope loads and stores of the
// ready words as std::atomic_ref operations (acquire and release, which only
// order more than relaxed ones), the global timer as the steady clock, and the
// proxy fence as nothing (the bulk copies of tma.cuh's stand-in are plain
// copies under a lock).
#pragma once
#include <stdint.h>

#include <atomic>
#include <chrono>

namespace ogl {
namespace tri {

inline uint64_t load_relaxed(const uint64_t* p) {
  return std::atomic_ref<uint64_t>(*const_cast<uint64_t*>(p)).load(std::memory_order_acquire);
}

inline void store_relaxed(uint64_t* p, uint64_t v) {
  std::atomic_ref<uint64_t>(*p).store(v, std::memory_order_release);
}

inline uint64_t clock_ns() {
  return static_cast<uint64_t>(std::chrono::duration_cast<std::chrono::nanoseconds>(
                                   std::chrono::steady_clock::now().time_since_epoch())
                                   .count());
}

inline void proxy_fence() {}

}  // namespace tri
}  // namespace ogl
