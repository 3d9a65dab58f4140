// Host side of the kernels whose CTAs walk work items (kernels I and J):
// how many CTAs the current device holds at once.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace wft {

// The answer for the last device and shared-memory size asked, kept by the
// caller per kernel instance (a launch function's static).
struct ResidentCache {
  int device = -1;
  size_t shared_bytes = 0;
  long long ctas = 0;
};

// *ctas = the CTAs of `threads` threads and `shared_bytes` of dynamic
// shared memory of `kernel` that the current device holds at once, after
// raising the kernel's shared-memory limit past the 48 KB default where it
// needs it.  Asks the runtime only when the device or the size changed.
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads,
                                 size_t shared_bytes, ResidentCache& cache,
                                 long long* ctas) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cache.device || shared_bytes != cache.shared_bytes) {
    if (shared_bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared_bytes));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, shared_bytes);
    if (err != cudaSuccess) return err;
    cache.device = device;
    cache.shared_bytes = shared_bytes;
    cache.ctas = static_cast<long long>(sms) * per_sm;
  }
  *ctas = cache.ctas;
  return cudaSuccess;
}

}  // namespace wft
