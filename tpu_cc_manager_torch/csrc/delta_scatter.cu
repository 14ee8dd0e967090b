// Kernel K2 of the planner: the incremental tick's delta scatter.
//
// Replaces tpu_cc_manager/plan.py::_scatter_fn's scatter (plan.py:1075-1094),
// a jitted shard_map program whose donated inputs (donate_argnums, :1102)
// let XLA write the updated rows into the resident column blocks in place.
// Here each shard's block is one persistent [8, rows] int32 tensor and this
// kernel writes into it directly: for each of the kb delta slots j whose
// global index g = idx[j] lies in [row0, end), the owner shard is
// (g - row0) / rows and block[owner][c, (g - row0) % rows] = vals[c, j]
// for each of the 8 columns c. An index outside [row0, end) -- the padding
// index nb above all, negatives, anything past the end -- changes nothing,
// as in the reference, where no shard owns it; so does an index whose
// owner is not in this launch's table (a shard on another card). Indices
// are unique, so no two threads write one element.
//
// One launch serves every shard on one card: the table of block pointers,
// indexed by shard number with a null for a shard elsewhere, travels by
// value in the kernel's parameters (64 entries; the planner's mesh has at
// most 64 shards). The unsharded block is the table of one (row0 0, end
// nb). Each live index has exactly one owner, so the reference's clip of
// a foreign index onto a shard's last row (plan.py:1083-1093), which loses
// that row's real update whenever the delta block carries padding, cannot
// happen.
//
// What bounds it on an H100: launch overhead. It must read every index
// once (4 bytes per slot) and, for a live slot, 8 values, and write 8 (64
// bytes): about 0.7 MB at kb = 16,384 with 10,000 live rows for the whole
// mesh, which the card moves in well under a microsecond; the launch
// itself costs a few. Measured times: PERF.md.
//
// Design: one thread per delta slot. A warp reads 32 consecutive indices
// and, for each column, 32 consecutive values, all in one round trip.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 128 CTAs at kb 16,384: one per SM
constexpr int kCols = 8;
constexpr int kMaxShards = 64;

// By value, in the kernel's parameter space: block[i] is shard i's
// [8, rows] block, or null when shard i is not on this card
struct ShardBlocks {
  int32_t* block[kMaxShards];
};

__global__ void delta_scatter_kernel(const ShardBlocks blocks, int shards,
                                     int rows, int64_t row0, int64_t end,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ vals,
                                     int kb) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kb) return;
  // the slot's values load beside its index, not after it: the index and
  // the 8 values are one round trip to memory instead of two in series
  // (a padding slot's 32 bytes are read for nothing)
  const int64_t g = __ldg(idx + j);
  int32_t v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = __ldg(vals + c * (int64_t)kb + j);
  if (g < row0 || g >= end) return;
  const int64_t rel = g - row0;
  const int64_t owner = rel / rows;
  if (owner >= shards) return;
  int32_t* block = blocks.block[owner];
  if (block == nullptr) return;
  const int64_t local = rel - owner * rows;
#pragma unroll
  for (int c = 0; c < kCols; ++c) block[c * (int64_t)rows + local] = v[c];
}

}  // namespace

// Launches K2 on `stream`. `blocks` is host memory holding `shards` device
// addresses (1 <= shards <= 64), shard i's [8, rows] block or null; shard
// i holds the global rows [row0 + i * rows, row0 + (i + 1) * rows), and
// only indices in [row0, end) are taken. Returns 0 or the CUDA error code
// of the launch.
extern "C" int tcc_delta_scatter(void* const* blocks, int shards, int rows,
                                 long long row0, long long end,
                                 const void* idx, const void* vals, int kb,
                                 void* stream) {
  if (shards < 1 || shards > kMaxShards || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (kb <= 0) return (int)cudaSuccess;
  ShardBlocks table = {};
  for (int i = 0; i < shards; ++i)
    table.block[i] = static_cast<int32_t*>(blocks[i]);
  const int grid = (kb + kThreads - 1) / kThreads;
  delta_scatter_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, shards, rows, (int64_t)row0, (int64_t)end,
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(vals), kb);
  return (int)cudaGetLastError();
}
