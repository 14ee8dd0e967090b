// Kernel K3 of the planner: the legacy fleet plan, one CTA per shard.
//
// Replaces tpu_cc_manager/plan.py::fleet_plan / fleet_plan_jit
// (plan.py:689-730), with its slice math _slice_outputs (:664-686) and
// _seg_minmax (:655-661): over three int32[n] columns (desired, observed,
// slice ids) it writes the needs_flip and failed masks, the observed- and
// desired-mode histograms, and per slice slot slice_coherent and
// slice_half_flipped. Under __graft_entry__.py's shard_map dry run
// (:103-116) the same function runs once per shard; here a batch of
// shards is one launch with one CTA per shard (gridDim.x = shards).
//
// What bounds it on an H100: launch overhead. At the shapes its callers
// give it (256 rows and 16 slots for entry(), 8 rows and 2 slots per
// shard in the dry run) it moves about 3.6 KB, a nanosecond of the card's
// memory rate. The design removes everything around the launch: the CTA
// reads its shard's three columns in place (no [8, n] block, no PyTorch op
// before the launch), keeps every slot and both histograms in shared
// memory (no global scratch, no init or epilogue launch), and a batch of
// shards takes one launch whose parameter struct carries each shard's
// column pointers and row count by value (no copy of pointers to the
// card).
//
// One CTA: initialise the slots (d_min/o_min INT_MAX, d_max/o_max INT_MIN,
// at_min 1, at_max 0) and the histograms, then a block-stride pass over
// the rows, one row per thread per step: each row's masks are stored,
// its mode and desired codes add into per-thread registers, and what it
// adds to its slot (desired and observed min/max, two at-target bits) is
// reduced over each run of lanes that holds one slot (warp_runs.cuh)
// before the run's head issues shared atomics. Then the histograms are
// summed per warp, and after a barrier the CTA writes its counts and both
// slot verdicts. A slot no row touches keeps its initial values, so it
// comes out neither coherent nor half-flipped, as in the reference.
//
// Index rules are JAX's: a negative code or slice id counts once from
// the end, and one still out of range is dropped from the histograms and
// the slot min/max.
//
// Limits (kernels/fleet_tick.py::_plan_route checks them before
// launching): 6 int32 per slot and 12 more in shared memory, at most
// 232,448 bytes a CTA on an H100, so num_slices <= 9,683 (above 48 KiB the
// launch opts in); at most 64 shards a launch; rows per shard up to the
// measured crossover past which K1's multi-CTA route (fleet_tick.cu) is
// faster (PERF.md).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "warp_runs.cuh"

namespace {

constexpr int kModes = 6;     // plan.N_MODES
constexpr int kUnknown = 0;   // plan.MODE_CODES["unknown"]
constexpr int kFailed = 5;    // plan.MODE_CODES["failed"]
constexpr int kMaxShards = 64;
constexpr int kMaxThreads = 1024;
constexpr int kTableFields = 5;  // desired, observed, slice_ids, offset, n

using warp_runs::kFull;
using warp_runs::Max;
using warp_runs::Min;
using warp_runs::Or;
using warp_runs::run_heads;
using warp_runs::run_reduce;
using warp_runs::writes;

struct PlanShard {
  const int32_t* desired;
  const int32_t* observed;
  const int32_t* slice_ids;
  int64_t mask_offset;  // the shard's first column in the batch's masks
  int n;
};

// By value, in the kernel's parameter space: 64 * 40 bytes
struct PlanBatch {
  PlanShard shard[kMaxShards];
};

__device__ __forceinline__ int wrap_index(int i, int size) {
  return i < 0 ? i + size : i;
}

// masks (bytes) [2, mask_stride]: needs_flip, failed; shard b's rows at
//   columns [mask_offset, mask_offset + n)
// mode_counts, desired_counts (int32) [shards, 6]: row b is shard b's
// slice_out (bytes) [shards, 2, num_slices]: coherent, half_flipped
__global__ void __launch_bounds__(kMaxThreads)
fleet_plan_kernel(const PlanBatch batch, int num_slices, int64_t mask_stride,
                  uint8_t* __restrict__ masks,
                  int32_t* __restrict__ mode_counts,
                  int32_t* __restrict__ desired_counts,
                  uint8_t* __restrict__ slice_out) {
  extern __shared__ int32_t sh[];
  const int s = num_slices;
  int32_t* d_min = sh;
  int32_t* d_max = sh + s;
  int32_t* o_min = sh + 2 * s;
  int32_t* o_max = sh + 3 * s;
  int32_t* at_min = sh + 4 * s;
  int32_t* at_max = sh + 5 * s;
  int32_t* hist = sh + 6 * s;  // mode counts, then desired counts

  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    d_min[i] = INT_MAX;
    d_max[i] = INT_MIN;
    o_min[i] = INT_MAX;
    o_max[i] = INT_MIN;
    at_min[i] = 1;
    at_max[i] = 0;
  }
  if (threadIdx.x < 2 * kModes) hist[threadIdx.x] = 0;
  __syncthreads();

  const PlanShard sd = batch.shard[blockIdx.x];
  uint8_t* flips = masks + sd.mask_offset;
  uint8_t* fails = flips + mask_stride;
  // int32 sums wrap as the reference's do; unsigned keeps that defined
  uint32_t mode_cnt[kModes] = {0, 0, 0, 0, 0, 0};
  uint32_t desired_cnt[kModes] = {0, 0, 0, 0, 0, 0};

  // every warp runs every step, so all 32 lanes reach the votes and
  // shuffles; a lane past the last row adds nothing
  for (int base = 0; base < sd.n; base += blockDim.x) {
    const int row = base + threadIdx.x;
    const bool here = row < sd.n;
    int32_t desired = 0, observed = 0, slice = 0;
    if (here) {
      desired = __ldg(sd.desired + row);
      observed = __ldg(sd.observed + row);
      slice = __ldg(sd.slice_ids + row);
      const bool known = desired != kUnknown;
      flips[row] = desired != observed && known;
      fails[row] = observed == kFailed;
      const int om = wrap_index(observed, kModes);
      const int dm = wrap_index(desired, kModes);
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        mode_cnt[m] += om == m ? 1u : 0u;
        desired_cnt[m] += dm == m ? 1u : 0u;
      }
    }
    const int sw = wrap_index(slice, s);
    const int key = here && sw >= 0 && sw < s ? sw : -1;
    if (!__any_sync(kFull, key >= 0)) continue;
    const bool at_target = observed == desired && desired != kUnknown;
    const unsigned heads = run_heads(key);
    const int dn = run_reduce(desired, heads, Min());
    const int dx = run_reduce(desired, heads, Max());
    const int on = run_reduce(observed, heads, Min());
    const int ox = run_reduce(observed, heads, Max());
    const unsigned at = run_reduce(at_target ? 1u : 2u, heads, Or());
    if (writes(key, heads)) {
      atomicMin(&d_min[key], dn);
      atomicMax(&d_max[key], dx);
      atomicMin(&o_min[key], on);
      atomicMax(&o_max[key], ox);
      // at-target is 0 or 1 and its slots start at 1 / 0: only the value
      // that moves one of them needs an atomic
      if (at & 2u) atomicMin(&at_min[key], 0);
      if (at & 1u) atomicMax(&at_max[key], 1);
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const uint32_t om = __reduce_add_sync(kFull, mode_cnt[m]);
    const uint32_t dm = __reduce_add_sync(kFull, desired_cnt[m]);
    if (lane == 0) {
      if (om != 0u) atomicAdd(&hist[m], (int32_t)om);
      if (dm != 0u) atomicAdd(&hist[kModes + m], (int32_t)dm);
    }
  }
  __syncthreads();

  const int64_t b = blockIdx.x;
  if (threadIdx.x < kModes) {
    mode_counts[b * kModes + threadIdx.x] = hist[threadIdx.x];
  } else if (threadIdx.x < 2 * kModes) {
    desired_counts[b * kModes + threadIdx.x - kModes] = hist[threadIdx.x];
  }
  uint8_t* coherent = slice_out + b * 2 * s;
  uint8_t* half_flipped = coherent + s;
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const bool desired_agree = d_min[i] == d_max[i];
    coherent[i] = desired_agree && o_min[i] == o_max[i];
    half_flipped[i] = desired_agree && at_min[i] == 0 && at_max[i] == 1;
  }
}

}  // namespace

// Launches K3 on `stream` over `shards` shards, one CTA each. `table` is
// host memory, kTableFields int64 per shard: the device addresses of its
// desired, observed and slice_ids columns, its first column in `masks`
// and its row count. `mask_stride` is the total row count (the width of
// `masks`). Returns 0, or the CUDA error code of the launch (a launch
// refused for its shared memory never runs).
extern "C" int tcc_fleet_plan(const int64_t* table, int shards, int num_slices,
                              long long mask_stride, void* masks,
                              void* mode_counts, void* desired_counts,
                              void* slice_out, void* stream) {
  if (shards < 1 || shards > kMaxShards || num_slices < 1)
    return (int)cudaErrorInvalidValue;
  PlanBatch batch = {};
  int max_n = 0;
  for (int b = 0; b < shards; ++b) {
    const int64_t* row = table + (int64_t)kTableFields * b;
    PlanShard& sd = batch.shard[b];
    sd.desired = reinterpret_cast<const int32_t*>(row[0]);
    sd.observed = reinterpret_cast<const int32_t*>(row[1]);
    sd.slice_ids = reinterpret_cast<const int32_t*>(row[2]);
    sd.mask_offset = row[3];
    sd.n = (int)row[4];
    if (sd.n > max_n) max_n = sd.n;
  }
  // one row per thread per step, whole warps, up to 1,024 threads
  int threads = (max_n + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = sizeof(int32_t) * (6 * (size_t)num_slices + 2 * kModes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fleet_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fleet_plan_kernel<<<shards, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      batch, num_slices, (int64_t)mask_stride, static_cast<uint8_t*>(masks),
      static_cast<int32_t*>(mode_counts),
      static_cast<int32_t*>(desired_counts), static_cast<uint8_t*>(slice_out));
  return (int)cudaGetLastError();
}
