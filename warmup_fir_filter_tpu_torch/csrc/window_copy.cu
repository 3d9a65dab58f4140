// Kernel D: overlapping sub-row windows of a (C, T) uint8 stream block.
//
// Replaces warmup_fir_filter_tpu/kernels/window_copy.py::_window_kernel
// (:47; entry window_rows_pallas :84, gate window_rows_supported :40).
// Output row r*C + c (window-major, as on the TPU) holds columns
// [r*sub - 128, r*sub + sub + 128) of the virtual stream
// carry_ext || x || zeros, where carry_ext is the (C, 128) tile that
// precedes x[:, 0] (its last taps - 1 columns are the stream's delay line).
//
// What bounds it on an H100: it is a pure copy, (sub + 256) / sub bytes
// written and about one byte read per input byte, so device memory is the
// roof.  sub and T are multiples of 128, so every 16-byte output chunk comes
// from one aligned 16-byte chunk of the carry tile or of x, or is zero: one
// thread moves one chunk with a 16-byte load and a 16-byte store, and
// neighbouring threads touch neighbouring chunks.  The TPU kernel's window
// groups per program (g_windows) have no counterpart: a CTA covers 256
// chunks of one output row.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ carry_ext,
                   uint8_t* __restrict__ out, long long channels,
                   long long total, long long sub, long long out_rows,
                   long long row_chunks) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= row_chunks) return;
  for (long long row = blockIdx.y; row < out_rows; row += gridDim.y) {
    const uint8_t* src =
        wft::window_chunk_source(x, carry_ext, channels, total, sub, row, k);
    const uint4 v = src ? *reinterpret_cast<const uint4*>(src)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(out + (row * row_chunks + k) * 16) = v;
  }
}

}  // namespace

// x (channels, total), carry_ext (channels, 128) and out
// (total / sub * channels, sub + 256): device pointers, 16-byte aligned.
extern "C" int wft_window_rows(const void* x, const void* carry_ext, void* out,
                               long long channels, long long total,
                               long long sub, void* stream) {
  if (channels < 1 || sub < 128 || sub % 128 != 0 || total < sub ||
      total % sub != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(carry_ext) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long out_rows = total / sub * channels;
  const long long row_chunks = (sub + 256) / 16;
  const long long col_blocks = (row_chunks + kThreads - 1) / kThreads;
  if (col_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_blocks),
                  static_cast<unsigned>(out_rows < kMaxGridY ? out_rows : kMaxGridY));
  window_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(carry_ext),
      static_cast<uint8_t*>(out), channels, total, sub, out_rows, row_chunks);
  return static_cast<int>(cudaGetLastError());
}
