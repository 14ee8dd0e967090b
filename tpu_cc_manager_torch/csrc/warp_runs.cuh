// Warp-level run reductions shared by the planner's row passes (K1 in
// fleet_tick.cu, K3 in fleet_plan.cu).
//
// Lanes group by runs: the lanes from one whose key differs from its left
// neighbour's (a run head) up to the next head. Rows come in order, so the
// lanes that share a slice or a pool sit next to each other; equal keys
// apart from each other still give the exact result, as separate runs that
// each write. Every lane of the warp must call these together.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace warp_runs {

constexpr unsigned kFull = 0xffffffffu;

// The run heads of `key` across the warp, one bit per lane.
__device__ __forceinline__ unsigned run_heads(int key) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  return __ballot_sync(kFull, lane == 0 || prev != key);
}

struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Or {
  __device__ unsigned operator()(unsigned a, unsigned b) const {
    return a | b;
  }
};
struct Add {
  __device__ unsigned operator()(unsigned a, unsigned b) const {
    return a + b;
  }
};

// `v` reduced over this lane's run, valid on the run's head: a segmented
// tree of full-warp shuffles, whose cost does not grow with the number of
// runs (a reduction over each run's own lane mask is issued once per run).
// Nothing to do when every lane is its own run.
template <typename T, typename Op>
__device__ __forceinline__ T run_reduce(T v, unsigned heads, Op op) {
  if (heads == kFull) return v;
  const int lane = threadIdx.x & 31;
  const unsigned above = heads & ~(kFull >> (31 - lane));
  const int end = above ? __ffs(above) - 1 : 32;  // next head, exclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_down_sync(kFull, v, d);
    if (lane + d < end) v = op(v, o);
  }
  return v;
}

// True where this lane heads its run and has something to write.
__device__ __forceinline__ bool writes(int key, unsigned heads) {
  return key >= 0 && ((heads >> (threadIdx.x & 31)) & 1u);
}

}  // namespace warp_runs
