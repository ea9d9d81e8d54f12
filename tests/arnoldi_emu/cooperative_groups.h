// grid.sync() of the CPU stand-in (cuda_runtime.h): a barrier over every
// thread of every CTA.
#pragma once
#include <barrier>

extern std::barrier<>* grid_barrier;

namespace cooperative_groups {
struct grid_group {
  void sync() { grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
