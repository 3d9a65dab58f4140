// Kernel N: the in-place copy of (rows, n) uint8 rows, the roofline
// harness's yardstick for the FIR's dataflow (one byte read and one byte
// written a sample).
//
// Replaces bench_roofline.py::_pallas_copy_fn (:46; body :54, pallas_call
// :62): an aliased (input_output_aliases={0: 0}) copy of (br, 8192) VMEM
// blocks, one a grid step.  The TPU's block rows are a VMEM blocking and
// have no counterpart here.
//
// What bounds it on an H100: bytes alone, 2 a sample at 3.35 TB/s.  The
// design makes one pass: each CTA copies a contiguous 16 KB chunk, 1,024
// 16-byte vectors, its 256 threads loading four each (neighbouring threads
// on neighbouring vectors, streaming loads, ld.global.cs) before storing
// them; CTA 0 also takes the head up to the first 16-byte boundary and the
// tail, a byte a thread, so any width and any start address work.  A
// persistent grid-stride loop (8 CTAs an SM) ran slower than this form and
// than `copy_` on an H100 (PERF.md).  The copy must not vanish: a store of
// a value just loaded from the same address is a no-op a compiler may
// delete, so source and destination are two parameters without
// __restrict__ that are equal only at run time, and the loads and stores
// are the streaming intrinsics.

#include <cstdint>

#include <cuda_runtime.h>

#include "wft_copy.cuh"

namespace {

__global__ void __launch_bounds__(wft::kCopyThreads)
copy_rows_kernel(const uint8_t* src, uint8_t* dst, wft::CopySplit split) {
  wft::copy_thread(src, dst, split, blockIdx.x, static_cast<int>(threadIdx.x));
}

}  // namespace

// src and dst: device pointers of nbytes each, equal (in place) or apart,
// with the same address mod 16.
extern "C" int wft_copy_rows(const void* src, void* dst, long long nbytes,
                             void* stream) {
  if (nbytes < 0 || ((reinterpret_cast<uintptr_t>(src) ^
                      reinterpret_cast<uintptr_t>(dst)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbytes == 0) return static_cast<int>(cudaSuccess);
  const wft::CopySplit split =
      wft::copy_split(reinterpret_cast<uintptr_t>(dst), nbytes);
  const long long blocks = wft::copy_blocks(split);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  copy_rows_kernel<<<static_cast<unsigned>(blocks), wft::kCopyThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), split);
  return static_cast<int>(cudaGetLastError());
}
