// Host helpers of the kernel library: error text for the Python wrappers,
// and the card's own memory rate for the kernels' byte bounds.

#include <cuda_runtime.h>

extern "C" const char* tcc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Peak device-memory rate in bytes per second from the memory clock and
// bus width the CUDA runtime reports (double data rate), or -1 on error.
extern "C" double tcc_memory_bytes_per_s(int device) {
  int khz = 0;
  int bits = 0;
  if (cudaDeviceGetAttribute(&khz, cudaDevAttrMemoryClockRate, device) !=
      cudaSuccess)
    return -1.0;
  if (cudaDeviceGetAttribute(&bits, cudaDevAttrGlobalMemoryBusWidth,
                             device) != cudaSuccess)
    return -1.0;
  return 2.0 * 1000.0 * khz * (bits / 8.0);
}
