// Kernel K5 of the device backend: the on-device readiness probe.
//
// Replaces tpu_cc_manager/device/jaxdev.py::probe_device (jaxdev.py:260-279),
// which puts float32 1.0 on one TPU chip, adds 1.0 there with a jitted XLA
// program and blocks until it reads back 2.0: the proof that the runtime
// answers after a reset. Here the same add runs as this kernel on one CUDA
// device, on PyTorch's current stream for that device; the wrapper
// (kernels/probe.py) allocates the output and the backend reads it back.
// y[i] = x[i] + 1.0f for every element, out of place, as JAX computes it.
//
// What bounds it on an H100: launch overhead. The probe moves 8 bytes (one
// float read, one written), which the card's memory rate covers in a few
// picoseconds; the launch and the host's read-back cost microseconds.
// Measured times: PERF.md.
//
// Design: one thread per element, so the probe's one-element tensor is one
// block of one thread. A vector (the checks in chip_smoke.py) takes blocks
// of 256 threads, neighbouring threads on neighbouring floats.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void probe_add_one_kernel(const float* __restrict__ x,
                                     float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

// Launches K5 over n floats on `stream`. Returns 0 or the CUDA error code
// of the launch.
extern "C" int tcc_probe_add_one(const void* x, void* y, int64_t n,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = n < kThreads ? (int)n : kThreads;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_add_one_kernel<<<(unsigned int)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}
