// Kernel K1 of the planner: one fleet tick over the [8, n] column block.
//
// Replaces tpu_cc_manager/plan.py::fleet_tick (plan.py:790-884) with its
// slice math, _slice_outputs (:664-686) and _seg_minmax (:655-661), which
// the JAX package runs as a jitted shard_map XLA program. The same launch
// serves plan.py::fleet_plan (:689-725): valid = 1 on every row, one pool,
// and num_slots = num_slices.
//
// What bounds it on an H100: bytes. A row reads its 8 int32 columns (32 B)
// and writes 7 mask bytes; its arithmetic is a few dozen integer compares
// and adds, far under the card's integer rate. At nb = 1,048,576 the
// inputs are 32 MiB and the outputs 9 MiB, about 13 us at 3.35 TB/s. The
// slot arrays ([6, num_slots] int32, 24 MiB at that size) are scratch this
// design adds on top: written by the init, hit by atomics, read back by
// the epilogue. Measured times and the bound per shape: PERF.md.
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
//   tick_rows      grid-stride over rows. The seven masks are written as
//                  bytes. The two mode histograms add up in registers, the
//                  pool counters and the pool x mode histogram in shared
//                  memory; each CTA flushes them with one global atomicAdd
//                  per non-zero bin. Each row does atomicMin/atomicMax on
//                  the slot arrays at its slice id.
//   tick_epilogue  slice_coherent / slice_half_flipped per slot, and
//                  pool_skew / pool_divergent per pool.
// Integer atomics commute, so the result is exact whatever order the
// CTAs run in.
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

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 6;            // plan.N_MODES
constexpr int kUnknown = 0;          // plan.MODE_CODES["unknown"]
constexpr int kFailed = 5;           // plan.MODE_CODES["failed"]
constexpr int kDoctorUnreported = 0; // plan.DOCTOR_UNREPORTED
constexpr int kDoctorFailing = 2;    // plan.DOCTOR_FAILING
constexpr int kHead = 2 * kModes;    // mode + desired histograms

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

__global__ void __launch_bounds__(kThreads)
tick_rows(const int32_t* __restrict__ cols, int n,
          const int32_t* __restrict__ pool_target, int pb, int num_slots,
          int now_s, int stale_s, uint8_t* __restrict__ masks,
          int32_t* __restrict__ agg, int32_t* __restrict__ slots) {
  extern __shared__ int32_t sh[];
  const int sh_len = kHead + 10 * pb;
  for (int j = threadIdx.x; j < sh_len; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  int32_t* s_nodes = sh + kHead;
  int32_t* s_conv = s_nodes + pb;
  int32_t* s_failed = s_conv + pb;
  int32_t* s_elig = s_failed + pb;
  int32_t* s_hist = s_elig + pb;

  const int64_t rows = n;
  const int64_t s = num_slots;
  int32_t* d_min = slots;
  int32_t* d_max = slots + s;
  int32_t* o_min = slots + 2 * s;
  int32_t* o_max = slots + 3 * s;
  int32_t* at_min = slots + 4 * s;
  int32_t* at_max = slots + 5 * s;

  // int32 sums wrap as the reference's do; unsigned keeps that defined
  uint32_t mode_cnt[kModes] = {0, 0, 0, 0, 0, 0};
  uint32_t desired_cnt[kModes] = {0, 0, 0, 0, 0, 0};

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows; i += stride) {
    const int32_t desired = cols[i];
    const int32_t observed = cols[rows + i];
    const int32_t slice = cols[2 * rows + i];
    const int32_t pool = cols[3 * rows + i];
    const int32_t taint = cols[4 * rows + i];
    const int32_t doctor = cols[5 * rows + i];
    const int32_t ev_ts = cols[6 * rows + i];
    const int32_t valid = cols[7 * rows + i];

    const bool is_valid = valid > 0;
    const bool known = desired != kUnknown && is_valid;
    const bool failed = observed == kFailed && is_valid;
    const bool flipping = taint > 0 && is_valid;
    const bool doctor_failing = doctor == kDoctorFailing && is_valid;
    const int32_t age = (int32_t)((uint32_t)now_s - (uint32_t)ev_ts);
    const bool stale = ev_ts >= 0 && age > stale_s && is_valid;

    const int pw = wrap_index(pool, pb);
    const int32_t target = pool_target[pw < 0 ? 0 : (pw >= pb ? pb - 1 : pw)];
    const bool converged = observed == target && desired == target && known;
    const bool eligible =
        !converged && is_valid && !flipping && !doctor_failing;

    masks[i] = desired != observed && known;
    masks[rows + i] = failed;
    masks[2 * rows + i] = flipping;
    masks[3 * rows + i] = doctor_failing;
    masks[4 * rows + i] = doctor == kDoctorUnreported && is_valid;
    masks[5 * rows + i] = stale;
    masks[6 * rows + i] = eligible;

    const int om = wrap_index(observed, kModes);
    const int dm = wrap_index(desired, kModes);
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      mode_cnt[m] += om == m ? (uint32_t)valid : 0u;
      desired_cnt[m] += dm == m ? (uint32_t)valid : 0u;
    }

    if (in_range(pw, pb)) {
      if (valid != 0) atomicAdd(&s_nodes[pw], valid);
      if (converged) atomicAdd(&s_conv[pw], 1);
      if (failed) atomicAdd(&s_failed[pw], 1);
      if (eligible) atomicAdd(&s_elig[pw], 1);
      if (valid != 0 && in_range(om, kModes))
        atomicAdd(&s_hist[pw * kModes + om], valid);
    }

    const int sw = wrap_index(slice, num_slots);
    if (in_range(sw, num_slots)) {
      atomicMin(&d_min[sw], desired);
      atomicMax(&d_max[sw], desired);
      atomicMin(&o_min[sw], observed);
      atomicMax(&o_max[sw], observed);
      // at-target is 0 or 1 and its slots start at 1 / 0: only the
      // value that moves one of them needs an atomic
      if (observed == desired && known) {
        atomicMax(&at_max[sw], 1);
      } else {
        atomicMin(&at_min[sw], 0);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    if (mode_cnt[m] != 0u) atomicAdd(&sh[m], (int32_t)mode_cnt[m]);
    if (desired_cnt[m] != 0u)
      atomicAdd(&sh[kModes + m], (int32_t)desired_cnt[m]);
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
    tick_rows<<<blocks_for(n, 8 * sms), kThreads, smem, st>>>(
        static_cast<const int32_t*>(cols), n,
        static_cast<const int32_t*>(pool_target), pb, num_slots, now_s,
        stale_s, static_cast<uint8_t*>(masks), agg, slots);
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
