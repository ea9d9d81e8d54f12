// The bulk copies and mbarriers of csrc/tma.cuh on the CPU.  A background
// engine lands each queued copy at a random later time (a copy issued into a
// slot that a thread still reads shows as a wrong result), then counts its
// bytes off the barrier; a barrier's phase completes when its arrivals and
// bytes are in.  Shared addresses are offsets from the calling CTA's shared
// memory (emu_smem_base).  Misuse aborts: a copy that is not 16-byte aligned
// or reads outside the allowed source range, an arrival too many, an
// initialisation or invalidation of a barrier in use.
#pragma once
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <thread>

extern thread_local unsigned char* emu_smem_base;

namespace ogl {
namespace tma {

struct Bar {
  uint32_t count, pending;
  int64_t tx;
  uint64_t completed;
};
struct Copy {
  void* dst;
  const void* src;
  uint32_t bytes;
  uint64_t* bar;
};

struct Engine {
  std::mutex mu;
  std::condition_variable cv;
  std::map<uint64_t*, Bar> bars;
  std::deque<Copy> queue;
  std::mt19937 rng{7};
  bool stop = false;
  const unsigned char* src_lo = nullptr;  // copies read [src_lo, src_hi)
  const unsigned char* src_hi = nullptr;
  uint64_t copies = 0, bytes = 0;

  void complete_if(uint64_t* p) {
    Bar& b = bars.at(p);
    if (b.pending == 0 && b.tx == 0) {
      ++b.completed;
      b.pending = b.count;
      cv.notify_all();
    }
  }
  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return stop || !queue.empty(); });
      if (queue.empty()) return;
      const size_t k = std::uniform_int_distribution<size_t>(0, queue.size() - 1)(rng);
      const Copy c = queue[k];
      queue.erase(queue.begin() + k);
      lk.unlock();
      std::this_thread::yield();
      memcpy(c.dst, c.src, c.bytes);
      lk.lock();
      Bar& b = bars.at(c.bar);
      b.tx -= c.bytes;
      ++copies;
      bytes += c.bytes;
      complete_if(c.bar);
    }
  }
};
extern Engine* engine;

[[noreturn]] inline void fail(const char* what) {
  fprintf(stderr, "tma emulation: %s\n", what);
  abort();
}

inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - emu_smem_base);
}
inline void bar_init(uint64_t* bar, uint32_t arrivals) {
  std::lock_guard<std::mutex> g(engine->mu);
  if (engine->bars.count(bar)) fail("init of a barrier in use");
  engine->bars[bar] = Bar{arrivals, arrivals, 0, 0};
}
inline void fence_init() {}
inline void bar_inval(uint64_t* bar) {
  std::lock_guard<std::mutex> g(engine->mu);
  const Bar& b = engine->bars.at(bar);
  if (b.tx != 0 || b.pending != b.count) fail("invalidation of a busy barrier");
  engine->bars.erase(bar);
}
inline void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(engine->mu);
  Bar& b = engine->bars.at(bar);
  if (b.pending == 0) fail("an arrival too many");
  b.tx += bytes;
  --b.pending;
  engine->complete_if(bar);
}
inline void arrive(uint64_t* bar) { arrive_expect_tx(bar, 0); }
inline void wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(engine->mu);
  engine->cv.wait(lk, [&] { return (engine->bars.at(bar).completed & 1) != parity; });
}
// the engine lands every copy after its issue, so the cross-proxy fence
// orders nothing more here
inline void fence_proxy_shared() {}
inline uint64_t evict_last_policy() { return 1; }
inline uint64_t evict_first_policy() { return 2; }
inline void copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if ((reinterpret_cast<uintptr_t>(dst) & 15) || (reinterpret_cast<uintptr_t>(src) & 15) ||
      (bytes & 15) || bytes == 0)
    fail("a copy not 16-byte aligned");
  if (s < engine->src_lo || s + bytes > engine->src_hi) fail("a copy outside the live rows");
  std::lock_guard<std::mutex> g(engine->mu);
  engine->queue.push_back({dst, src, bytes, bar});
  engine->cv.notify_all();
}
inline void copy_hint(void* dst, const void* src, uint32_t bytes, uint64_t* bar, uint64_t) {
  copy(dst, src, bytes, bar);
}

}  // namespace tma
}  // namespace ogl
