// Kernel K1 of the planner: one fleet tick over the [8, n] column block.
//
// Replaces tpu_cc_manager/plan.py::fleet_tick (plan.py:790-884) with its
// slice math, _slice_outputs (:664-686) and _seg_minmax (:655-661), which
// the JAX package runs as a jitted shard_map XLA program. K3
// (plan.py::fleet_plan, :689-725) has its own one-CTA kernel
// (fleet_plan.cu); past that kernel's limits it takes this one, with
// valid = 1 on every row, one pool and num_slots = num_slices.
//
// What bounds it on an H100: bytes. A row reads its 8 int32 columns (32 B)
// and writes 7 mask bytes; its arithmetic is a few dozen integer compares
// and adds, far under the card's integer rate. At nb = 1,048,576 the
// inputs are 32 MiB and the outputs 9 MiB, about 13 us at 3.35 TB/s. The
// slot arrays ([6, num_slots] int32, 24 MiB at that size) are scratch this
// design adds on top: written by the init, hit by atomics, read back by
// the epilogue. Measured times, the bound and the per-launch split per
// shape: PERF.md.
//
// On a mesh of S shards (plan.py's sharded tick) each shard runs the
// partial entry, tcc_fleet_tick_partial: tick_init and tick_rows over its
// own rows, with the global slot and pool widths, writing its mask columns
// and its raw counts and slot min/max into one row of the partial buffers.
// No epilogue runs; K4 (csrc/mesh_combine.cu) combines the S rows and runs
// it. Slice and pool ids stay global, as in the reference's shard
// (plan.py:811-815, :995), so S partials combine to the unsharded result.
//
// Design: three launches on the caller's stream.
//   tick_init      slot arrays to the identities of min/max (INT_MAX /
//                  INT_MIN; 1 / 0 for at-target) and counters to 0.
//   tick_rows      each thread takes 4 consecutive rows: one 16-byte load
//                  per column and one 4-byte store per mask row when the
//                  row count is a multiple of 4 and the block is 16-byte
//                  aligned, else the same rows one by one (a ragged row
//                  count, a block at an offset). What the rows add to the
//                  slots, pools and pool x mode bins is aggregated before any
//                  atomic: a thread folds its rows that share a key, then
//                  the lanes of a warp that hold one key in a run reduce
//                  it with warp shuffles, and the run's first lane writes
//                  (atomicMin/Max on the slot arrays in global memory,
//                  atomicAdd on the CTA's pool counters in shared memory).
//                  The two mode histograms add up in registers and are
//                  summed per warp. Each CTA flushes its counters with one
//                  global atomicAdd per non-zero bin; the grid is as many
//                  CTAs as are resident at once, striding over the rows.
//   tick_epilogue  slice_coherent / slice_half_flipped per slot, and
//                  pool_skew / pool_divergent per pool.
// Integer atomics commute, so the result is exact whatever order the
// CTAs run in.
//
// Why aggregate, and by runs rather than a match of equal keys: with one
// set of atomics per row, most of the time went to contended atomics
// (every padding row on slot nb - 1, 16 rows on each slice's slot, 32
// lanes on one pool's shared counter). Rows come
// in slice order, so the lanes that share a key sit side by side; a run
// costs one shuffle and one vote to find, and its segmented reduction the
// same few shuffles however many runs a warp holds, where a reduction per
// matched group is issued once per group. Equal keys that are not side
// by side stay exact, as separate runs that each write.
//
// Index rules are JAX's, because the reference is held to them: a negative
// index counts once from the end; a scatter (histograms, slot min/max)
// then drops an index still out of range; the gather pool_target[pool]
// clamps it. Padding rows (valid = 0) are not masked out of the slot
// min/max, exactly as in the reference.
//
// Shared memory per CTA: (12 + 10 * pb) int32. Above 48 KiB the launch
// opts in to more; a CTA may have at most 232,448 bytes on an H100, so
// pb <= 5,809 (kernels/fleet_tick.py checks this before launching).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "warp_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 6;            // plan.N_MODES
constexpr int kUnknown = 0;          // plan.MODE_CODES["unknown"]
constexpr int kFailed = 5;           // plan.MODE_CODES["failed"]
constexpr int kDoctorUnreported = 0; // plan.DOCTOR_UNREPORTED
constexpr int kDoctorFailing = 2;    // plan.DOCTOR_FAILING
constexpr int kHead = 2 * kModes;    // mode + desired histograms
constexpr int kCols = 8;             // plan.COLS_ORDER
constexpr int kMasks = 7;
constexpr int kRowsPerThread = 4;    // one int4 per column

// agg (int32), in this order:
//   mode_counts[6] desired_counts[6] pool_nodes[pb] pool_converged[pb]
//   pool_failed[pb] pool_eligible[pb] pool_hist[pb][6] pool_skew[pb]
//   pool_divergent[pb]
// The first kHead + 10 * pb entries are the ones the rows add into.
// slots (int32) [6, num_slots]: d_min d_max o_min o_max at_min at_max
// masks (bytes) [7, n]: needs_flip failed flipping doctor_failing
//   doctor_unreported stale_evidence eligible
// slice_out (bytes) [2, num_slots]: slice_coherent slice_half_flipped

__device__ __forceinline__ int wrap_index(int i, int size) {
  return i < 0 ? i + size : i;
}

__device__ __forceinline__ bool in_range(int i, int size) {
  return i >= 0 && i < size;
}

__global__ void tick_init(int32_t* __restrict__ agg, int agg_len,
                          int32_t* __restrict__ slots, int num_slots) {
  const int64_t s = num_slots;
  const int64_t work = s > agg_len ? s : agg_len;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < s) {
      slots[i] = INT_MAX;
      slots[s + i] = INT_MIN;
      slots[2 * s + i] = INT_MAX;
      slots[3 * s + i] = INT_MIN;
      slots[4 * s + i] = 1;
      slots[5 * s + i] = 0;
    }
    if (i < agg_len) agg[i] = 0;
  }
}

using warp_runs::Add;
using warp_runs::kFull;
using warp_runs::Max;
using warp_runs::Min;
using warp_runs::Or;
using warp_runs::run_heads;
using warp_runs::run_reduce;
using warp_runs::writes;

// What a run of rows adds to one slot: desired and observed min/max, and
// the at-target bits (1: some row at target, 2: some row not).
struct SlotItem {
  int key;  // wrapped slot id, or -1 for nothing to add
  int d_min, d_max, o_min, o_max;
  unsigned at;
  __device__ void merge(const SlotItem& o) {
    d_min = min(d_min, o.d_min);
    d_max = max(d_max, o.d_max);
    o_min = min(o_min, o.o_min);
    o_max = max(o_max, o.o_max);
    at |= o.at;
  }
};

// What rows add to one pool's counters: the sum of valid, and the
// converged, failed and eligible rows packed 8 bits apart (a warp adds at
// most 32 * kRowsPerThread = 128 into each field).
struct PoolItem {
  int key;  // wrapped pool id, or -1
  unsigned nodes, flags;
  __device__ void merge(const PoolItem& o) {
    nodes += o.nodes;
    flags += o.flags;
  }
};

// What rows add to one (pool, observed mode) bin of the pool histogram.
struct HistItem {
  int key;  // pool * kModes + mode, or -1
  unsigned count;
  __device__ void merge(const HistItem& o) { count += o.count; }
};

// Folds each of a thread's items into the first of its items with the
// same key; the folded ones get key -1.
template <typename Item>
__device__ __forceinline__ void fold(Item (&it)[kRowsPerThread]) {
#pragma unroll
  for (int j = 1; j < kRowsPerThread; ++j) {
    bool done = it[j].key < 0;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      if (!done && it[k].key == it[j].key) {
        it[k].merge(it[j]);
        it[j].key = -1;
        done = true;
      }
    }
  }
}

// One item per lane into the slot arrays: each run of lanes on one slot
// reduces across the warp and its head issues the atomics.
__device__ __forceinline__ void flush_slot(SlotItem it, int32_t* slots,
                                           int64_t s) {
  const unsigned heads = run_heads(it.key);
  it.d_min = run_reduce(it.d_min, heads, Min());
  it.d_max = run_reduce(it.d_max, heads, Max());
  it.o_min = run_reduce(it.o_min, heads, Min());
  it.o_max = run_reduce(it.o_max, heads, Max());
  it.at = run_reduce(it.at, heads, Or());
  if (!writes(it.key, heads)) return;
  int32_t* p = slots + it.key;
  atomicMin(p, it.d_min);
  atomicMax(p + s, it.d_max);
  atomicMin(p + 2 * s, it.o_min);
  atomicMax(p + 3 * s, it.o_max);
  // at-target is 0 or 1 and its slots start at 1 / 0: only the value
  // that moves one of them needs an atomic
  if (it.at & 2u) atomicMin(p + 4 * s, 0);
  if (it.at & 1u) atomicMax(p + 5 * s, 1);
}

// One item per lane into the CTA's pool counters (shared memory).
__device__ __forceinline__ void flush_pool(PoolItem it, int32_t* s_nodes,
                                           int pb) {
  const unsigned heads = run_heads(it.key);
  it.nodes = run_reduce(it.nodes, heads, Add());
  it.flags = run_reduce(it.flags, heads, Add());
  if (!writes(it.key, heads)) return;
  const unsigned conv = it.flags & 0xffu;
  const unsigned failed = (it.flags >> 8) & 0xffu;
  const unsigned elig = it.flags >> 16;
  if (it.nodes != 0u) atomicAdd(&s_nodes[it.key], (int32_t)it.nodes);
  if (conv != 0u) atomicAdd(&s_nodes[pb + it.key], (int32_t)conv);
  if (failed != 0u) atomicAdd(&s_nodes[2 * pb + it.key], (int32_t)failed);
  if (elig != 0u) atomicAdd(&s_nodes[3 * pb + it.key], (int32_t)elig);
}

// One item per lane into the CTA's pool x mode histogram.
__device__ __forceinline__ void flush_hist(HistItem it, int32_t* s_hist) {
  const unsigned heads = run_heads(it.key);
  it.count = run_reduce(it.count, heads, Add());
  if (!writes(it.key, heads) || it.count == 0u) return;
  atomicAdd(&s_hist[it.key], (int32_t)it.count);
}

__global__ void __launch_bounds__(kThreads)
tick_rows(const int32_t* __restrict__ cols, int n,
          const int32_t* __restrict__ pool_target, int pb, int num_slots,
          int now_s, int stale_s, uint8_t* __restrict__ masks,
          int32_t* __restrict__ agg, int32_t* __restrict__ slots) {
  extern __shared__ int32_t sh[];
  const int sh_len = kHead + 10 * pb;
  for (int j = threadIdx.x; j < sh_len; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  int32_t* s_nodes = sh + kHead;  // then converged, failed, eligible
  int32_t* s_hist = s_nodes + 4 * pb;

  const int64_t rows = n;
  const int64_t quads = (rows + kRowsPerThread - 1) / kRowsPerThread;
  // the vector path: one 16-byte load per column and one 4-byte store per
  // mask row for each thread's 4 rows; else the same work row by row
  const bool vec = rows % kRowsPerThread == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(masks) % 4 == 0;
  const int lane = threadIdx.x & 31;

  // int32 sums wrap as the reference's do; unsigned keeps that defined
  uint32_t mode_cnt[kModes] = {0, 0, 0, 0, 0, 0};
  uint32_t desired_cnt[kModes] = {0, 0, 0, 0, 0, 0};

  // the loop runs per warp, so every lane reaches the warp-wide votes;
  // a lane past the last quad adds nothing
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < quads; base += stride) {
    const int64_t q = base + lane;
    const int64_t row0 = q * kRowsPerThread;
    int32_t v[kCols][kRowsPerThread] = {};
    int live = 0;
    if (vec) {
      if (q < quads) {
        live = kRowsPerThread;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int4 x =
              __ldcs(reinterpret_cast<const int4*>(cols + c * rows) + q);
          v[c][0] = x.x;
          v[c][1] = x.y;
          v[c][2] = x.z;
          v[c][3] = x.w;
        }
      }
    } else if (q < quads) {
      const int64_t left = rows - row0;
      live = left < kRowsPerThread ? (int)left : kRowsPerThread;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (j < live) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            v[c][j] = __ldcs(cols + c * rows + row0 + j);
        }
      }
    }

    uint32_t mk[kMasks] = {0, 0, 0, 0, 0, 0, 0};
    SlotItem si[kRowsPerThread];
    PoolItem pi[kRowsPerThread];
    HistItem hi[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      // a row past the end reads as zeros (valid 0) and has no keys
      const bool here = j < live;
      const int32_t desired = v[0][j];
      const int32_t observed = v[1][j];
      const int32_t slice = v[2][j];
      const int32_t pool = v[3][j];
      const int32_t taint = v[4][j];
      const int32_t doctor = v[5][j];
      const int32_t ev_ts = v[6][j];
      const int32_t valid = v[7][j];

      const bool is_valid = valid > 0;
      const bool known = desired != kUnknown && is_valid;
      const bool failed = observed == kFailed && is_valid;
      const bool flipping = taint > 0 && is_valid;
      const bool doctor_failing = doctor == kDoctorFailing && is_valid;
      const int32_t age = (int32_t)((uint32_t)now_s - (uint32_t)ev_ts);
      const bool stale = ev_ts >= 0 && age > stale_s && is_valid;

      const int pw = wrap_index(pool, pb);
      const int32_t target =
          __ldg(pool_target + (pw < 0 ? 0 : (pw >= pb ? pb - 1 : pw)));
      const bool converged = observed == target && desired == target && known;
      const bool eligible =
          !converged && is_valid && !flipping && !doctor_failing;
      const bool at_target = observed == desired && known;

      const int sh8 = 8 * j;
      mk[0] |= (uint32_t)(desired != observed && known) << sh8;
      mk[1] |= (uint32_t)failed << sh8;
      mk[2] |= (uint32_t)flipping << sh8;
      mk[3] |= (uint32_t)doctor_failing << sh8;
      mk[4] |= (uint32_t)(doctor == kDoctorUnreported && is_valid) << sh8;
      mk[5] |= (uint32_t)stale << sh8;
      mk[6] |= (uint32_t)eligible << sh8;

      const int om = wrap_index(observed, kModes);
      const int dm = wrap_index(desired, kModes);
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        mode_cnt[m] += om == m ? (uint32_t)valid : 0u;
        desired_cnt[m] += dm == m ? (uint32_t)valid : 0u;
      }

      const int sw = wrap_index(slice, num_slots);
      si[j].key = here && in_range(sw, num_slots) ? sw : -1;
      si[j].d_min = si[j].d_max = desired;
      si[j].o_min = si[j].o_max = observed;
      si[j].at = at_target ? 1u : 2u;

      // a row with valid 0 (padding) adds nothing to its pool: every flag
      // needs valid > 0
      pi[j].key = here && valid != 0 && in_range(pw, pb) ? pw : -1;
      pi[j].nodes = (uint32_t)valid;
      pi[j].flags = (uint32_t)converged | (uint32_t)failed << 8 |
                    (uint32_t)eligible << 16;

      hi[j].key = here && valid != 0 && in_range(pw, pb) && in_range(om, kModes)
                      ? pw * kModes + om
                      : -1;
      hi[j].count = (uint32_t)valid;
    }

    if (live > 0) {
      if (vec) {
#pragma unroll
        for (int k = 0; k < kMasks; ++k)
          __stcs(reinterpret_cast<unsigned int*>(masks + k * rows) + q, mk[k]);
      } else {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          if (j < live) {
#pragma unroll
            for (int k = 0; k < kMasks; ++k)
              masks[k * rows + row0 + j] = (uint8_t)(mk[k] >> (8 * j));
          }
        }
      }
    }

    fold(si);
    fold(pi);
    fold(hi);
    // one round per item position; a position no lane holds is skipped
    // (after the fold most threads hold one slot and one pool item)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (__any_sync(kFull, si[r].key >= 0))
        flush_slot(si[r], slots, num_slots);
      if (__any_sync(kFull, pi[r].key >= 0)) flush_pool(pi[r], s_nodes, pb);
      if (__any_sync(kFull, hi[r].key >= 0)) flush_hist(hi[r], s_hist);
    }
  }

  // the mode histograms: a warp sum each, one shared atomic per warp
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const uint32_t om = __reduce_add_sync(kFull, mode_cnt[m]);
    const uint32_t dm = __reduce_add_sync(kFull, desired_cnt[m]);
    if (lane == 0) {
      if (om != 0u) atomicAdd(&sh[m], (int32_t)om);
      if (dm != 0u) atomicAdd(&sh[kModes + m], (int32_t)dm);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < sh_len; j += blockDim.x) {
    if (sh[j] != 0) atomicAdd(&agg[j], sh[j]);
  }
}

__global__ void tick_epilogue(int32_t* __restrict__ agg, int pb,
                              const int32_t* __restrict__ slots,
                              int num_slots, uint8_t* __restrict__ slice_out) {
  const int64_t s = num_slots;
  const int64_t work = s > pb ? s : pb;
  const int32_t* nodes = agg + kHead;
  const int32_t* conv = nodes + pb;
  const int32_t* hist = nodes + 4 * pb;
  int32_t* skew = agg + kHead + 10 * pb;
  int32_t* divergent = skew + pb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < s) {
      const bool desired_agree = slots[i] == slots[s + i];
      slice_out[i] = desired_agree && slots[2 * s + i] == slots[3 * s + i];
      slice_out[s + i] =
          desired_agree && slots[4 * s + i] == 0 && slots[5 * s + i] == 1;
    }
    if (i < pb) {
      int32_t top = hist[i * kModes];
      for (int m = 1; m < kModes; ++m) {
        const int32_t h = hist[i * kModes + m];
        top = h > top ? h : top;
      }
      skew[i] = (int32_t)((uint32_t)nodes[i] - (uint32_t)top);
      divergent[i] = (int32_t)((uint32_t)nodes[i] - (uint32_t)conv[i]);
    }
  }
}

int blocks_for(int64_t work, int cap) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < cap ? blocks : cap);
}

// tick_init, then tick_rows when there are rows: the part of K1 that the
// full tick and a shard's partial share. `agg_len` entries of `agg` start
// at 0: kHead + 12 * pb for the full tick, kHead + 10 * pb for a partial.
// tick_rows gets one thread per 4 rows, at most as many CTAs as are
// resident on the card at once: each CTA flushes its shared counters
// with global atomics, so fewer CTAs mean fewer of those.
int launch_init_rows(const void* cols, int n, const void* pool_target, int pb,
                     int num_slots, int now_s, int stale_s, void* masks,
                     int32_t* agg, int agg_len, int32_t* slots,
                     cudaStream_t st, int sms) {
  const int64_t init_work = num_slots > agg_len ? num_slots : agg_len;
  tick_init<<<blocks_for(init_work, 8 * sms), kThreads, 0, st>>>(
      agg, agg_len, slots, num_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const size_t smem = sizeof(int32_t) * (kHead + 10 * (size_t)pb);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(tick_rows,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tick_rows,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t quads = ((int64_t)n + kRowsPerThread - 1) / kRowsPerThread;
    tick_rows<<<blocks_for(quads, (per_sm > 0 ? per_sm : 1) * sms), kThreads,
                smem, st>>>(static_cast<const int32_t*>(cols), n,
                            static_cast<const int32_t*>(pool_target), pb,
                            num_slots, now_s, stale_s,
                            static_cast<uint8_t*>(masks), agg, slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int multiprocessors(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

}  // namespace

// Launches K1 on `stream`. Returns 0, or the first CUDA error code
// (a refused launch never runs, so each launch is checked at once).
extern "C" int tcc_fleet_tick(const void* cols, int n, const void* pool_target,
                              int pb, int num_slots, int now_s, int stale_s,
                              void* masks, void* agg, void* slots,
                              void* slice_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  int rc = multiprocessors(&sms);
  if (rc != 0) return rc;
  int32_t* agg_i = static_cast<int32_t*>(agg);
  int32_t* slots_i = static_cast<int32_t*>(slots);
  rc = launch_init_rows(cols, n, pool_target, pb, num_slots, now_s, stale_s,
                        masks, agg_i, kHead + 12 * pb, slots_i, st, sms);
  if (rc != 0) return rc;
  const int64_t epi_work = num_slots > pb ? num_slots : pb;
  tick_epilogue<<<blocks_for(epi_work, 8 * sms), kThreads, 0, st>>>(
      agg_i, pb, slots_i, num_slots, static_cast<uint8_t*>(slice_out));
  return (int)cudaGetLastError();
}

// Launches K1's partial form on `stream`: one shard's rows, no epilogue.
// `counts` is int32[kHead + 10 * pb] (the summed head of `agg`), `slots`
// int32[6, num_slots]; both are the shard's row of the mesh's partial
// buffers. Returns 0 or the first CUDA error code.
extern "C" int tcc_fleet_tick_partial(const void* cols, int n,
                                      const void* pool_target, int pb,
                                      int num_slots, int now_s, int stale_s,
                                      void* masks, void* counts, void* slots,
                                      void* stream) {
  int sms = 0;
  int rc = multiprocessors(&sms);
  if (rc != 0) return rc;
  return launch_init_rows(cols, n, pool_target, pb, num_slots, now_s, stale_s,
                          masks, static_cast<int32_t*>(counts),
                          kHead + 10 * pb, static_cast<int32_t*>(slots),
                          static_cast<cudaStream_t>(stream), sms);
}
