// Kernel K4 of the planner: the mesh combine of a sharded tick.
//
// Replaces the collectives of tpu_cc_manager/plan.py's sharded tick: the
// psum of the seven per-pool and per-mode aggregates in fleet_tick
// (plan.py:864-871) and the pmin/pmax of the six slot arrays in
// _slice_outputs (:677-683), with the epilogue that follows them (pool_skew,
// pool_divergent, :879-880; slice_coherent, slice_half_flipped, :684-685).
// The counts-only form replaces the psum of mode_counts in
// __graft_entry__.py::fleet_step (:114).
//
// The reference runs its mesh under one controller: one process drives
// every device, and XLA reduces the shards' partials. Here one process
// drives every shard too: each shard runs K1's partial form
// (csrc/fleet_tick.cu, tcc_fleet_tick_partial) into its row of two
// buffers on the root card, and this kernel reduces the rows.
//
// Inputs (int32):
//   counts [S, kHead + 10 * pb]  K1's summed head: mode_counts[6]
//                                desired_counts[6] pool_nodes[pb]
//                                pool_converged[pb] pool_failed[pb]
//                                pool_eligible[pb] pool_hist[pb][6]
//   slots  [S, 6, num_slots]     d_min d_max o_min o_max at_min at_max
// Outputs: agg int32[kHead + 12 * pb] (the sums, then pool_skew[pb] and
// pool_divergent[pb]) and slice_out bytes [2, num_slots]
// (slice_coherent, slice_half_flipped): what K1's epilogue writes.
//
// A slot that no row of a shard touched holds that shard's identities
// (INT_MAX / INT_MIN, 1 / 0 for at-target), which min and max pass
// through; the reduction starts from shard 0's value, so it is the
// reduction of the inputs and nothing else, as jax.lax.pmin/pmax is.
// Sums wrap as int32, as psum does.
//
// What bounds it on an H100: bytes. At S = 8, num_slots = 1,048,576 and
// pb = 8 it reads S * (6 * num_slots + 12 + 10 * pb) int32, about 201 MB,
// and writes 2 bytes per slot, about 2 MB: some 0.06 ms at 3.35 TB/s. Its
// arithmetic is 6 * S compares per slot.
//
// Design: two launches on the caller's stream.
//   combine_counts  grid-stride over the m count entries; each thread sums
//                   its entry's S values (neighbouring threads read
//                   neighbouring entries).
//   combine_slots   grid-stride over the slots; each thread reads its
//                   slot's 6 * S values, coalesced across the warp, and
//                   writes two bytes. Threads i < pb also run the pool
//                   epilogue on the sums combine_counts wrote before it.
// The counts-only form (tcc_mesh_sum) is combine_counts alone.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 6;          // plan.N_MODES
constexpr int kHead = 2 * kModes;  // mode + desired histograms

__global__ void combine_counts(const int32_t* __restrict__ partials,
                               int shards, int m,
                               int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    // int32 sums wrap as the reference's do; unsigned keeps that defined
    uint32_t acc = 0u;
    for (int s = 0; s < shards; ++s) {
      acc += (uint32_t)partials[(int64_t)s * m + i];
    }
    out[i] = (int32_t)acc;
  }
}

__global__ void combine_slots(const int32_t* __restrict__ slots, int shards,
                              int num_slots, int32_t* __restrict__ agg,
                              int pb, uint8_t* __restrict__ slice_out) {
  const int64_t ns = num_slots;
  const int64_t work = ns > pb ? ns : pb;
  const int64_t per_shard = 6 * ns;
  const int32_t* nodes = agg + kHead;
  const int32_t* conv = nodes + pb;
  const int32_t* hist = nodes + 4 * pb;
  int32_t* skew = agg + kHead + 10 * pb;
  int32_t* divergent = skew + pb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < work;
       i += stride) {
    if (i < ns) {
      int32_t d_mn = slots[i];
      int32_t d_mx = slots[ns + i];
      int32_t o_mn = slots[2 * ns + i];
      int32_t o_mx = slots[3 * ns + i];
      int32_t at_mn = slots[4 * ns + i];
      int32_t at_mx = slots[5 * ns + i];
      for (int s = 1; s < shards; ++s) {
        const int32_t* p = slots + s * per_shard;
        d_mn = min(d_mn, p[i]);
        d_mx = max(d_mx, p[ns + i]);
        o_mn = min(o_mn, p[2 * ns + i]);
        o_mx = max(o_mx, p[3 * ns + i]);
        at_mn = min(at_mn, p[4 * ns + i]);
        at_mx = max(at_mx, p[5 * ns + i]);
      }
      const bool desired_agree = d_mn == d_mx;
      slice_out[i] = desired_agree && o_mn == o_mx;
      slice_out[ns + i] = desired_agree && at_mn == 0 && at_mx == 1;
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

int multiprocessors(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

}  // namespace

// Launches K4 on `stream`: counts [shards, kHead + 10 * pb] and slots
// [shards, 6, num_slots] in, agg [kHead + 12 * pb] and slice_out
// [2, num_slots] out. Returns 0, or the first CUDA error code.
extern "C" int tcc_mesh_combine(const void* counts, const void* slots,
                                int shards, int pb, int num_slots, void* agg,
                                void* slice_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  int rc = multiprocessors(&sms);
  if (rc != 0) return rc;
  const int m = kHead + 10 * pb;
  int32_t* agg_i = static_cast<int32_t*>(agg);
  combine_counts<<<blocks_for(m, 8 * sms), kThreads, 0, st>>>(
      static_cast<const int32_t*>(counts), shards, m, agg_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t work = num_slots > pb ? num_slots : pb;
  combine_slots<<<blocks_for(work, 8 * sms), kThreads, 0, st>>>(
      static_cast<const int32_t*>(slots), shards, num_slots, agg_i, pb,
      static_cast<uint8_t*>(slice_out));
  return (int)cudaGetLastError();
}

// Launches K4's counts-only form on `stream`: out[i] = the int32 sum over
// s of partials[s, i], for partials [shards, m]. Returns 0 or the CUDA
// error code of the launch.
extern "C" int tcc_mesh_sum(const void* partials, int shards, int m,
                            void* out, void* stream) {
  int sms = 0;
  int rc = multiprocessors(&sms);
  if (rc != 0) return rc;
  combine_counts<<<blocks_for(m, 8 * sms), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(partials), shards, m,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
