// Kernel K2 of the planner: the incremental tick's delta scatter.
//
// Replaces tpu_cc_manager/plan.py::_scatter_fn's scatter (plan.py:1075-1094),
// a jitted shard_map program whose donated inputs (donate_argnums, :1102)
// let XLA write the updated rows into the resident column block in place.
// Here the block is one persistent [8, nb] int32 tensor and this kernel
// writes into it directly: block[c, idx[j]] = vals[c, j] for each of the
// 8 columns c and kb delta slots j. An index outside [0, nb) -- the
// padding index nb above all -- changes nothing, as in the reference,
// where no shard owns it. Indices are unique, so no two threads write one
// element.
//
// On a mesh (plan.py's sharded session) each shard's block holds the
// global rows [row0, row0 + rows) and the launch writes only those:
// block[c, idx[j] - row0] = vals[c, j], every other index dropped. The
// reference instead clips a foreign index onto the shard's last row and
// writes that row's old value back there (plan.py:1083-1093), which loses
// the real update of that row whenever the delta block carries padding;
// dropping the index keeps it.
//
// What bounds it on an H100: launch overhead. It reads every index (4
// bytes per slot) and, for a live slot only, reads 8 values and writes 8
// (64 bytes): about 0.7 MB at kb = 16,384 with 10,000 live rows, which the
// card moves in well under a microsecond; the launch itself costs a few.
// Measured times: PERF.md.
//
// Design: one thread per (column, delta slot), column-major so that a
// warp reads 32 consecutive indices and values.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;

__global__ void delta_scatter_kernel(int32_t* __restrict__ block, int rows,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ vals,
                                     int kb, int row0) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)kCols * kb) return;
  const int64_t c = t / kb;
  const int64_t j = t - c * kb;
  const int64_t row = (int64_t)idx[j] - row0;
  if (row >= 0 && row < rows) block[c * rows + row] = vals[c * kb + j];
}

}  // namespace

// Launches K2 on `stream` for a block of `rows` rows holding the global
// rows [row0, row0 + rows). Returns 0 or the CUDA error code of the launch.
extern "C" int tcc_delta_scatter(void* block, int rows, const void* idx,
                                 const void* vals, int kb, int row0,
                                 void* stream) {
  if (kb <= 0) return (int)cudaSuccess;
  const int64_t work = (int64_t)kCols * kb;
  const int blocks = (int)((work + kThreads - 1) / kThreads);
  delta_scatter_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(block), rows, static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(vals), kb, row0);
  return (int)cudaGetLastError();
}
