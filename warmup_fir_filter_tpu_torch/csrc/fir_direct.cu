// Kernel B: bit-exact same-mode Q-format FIR over (B, N) uint8 rows in
// direct form, for any number of taps.
//
// Replaces warmup_fir_filter_tpu/kernels/fir_pallas.py::_fir_fixed_kernel
// (:62): widen to 32 bits, L shifted multiply-adds that wrap mod 2^32, then
// the wrap / round / saturate epilogue (ops/fir1d.py:68-87).  The TPU
// version reads a host-padded row block; here a CTA computes kTile output
// columns of kRows rows and masks the same-mode halo itself (zeros outside
// the row), so the host pads nothing.
//
// The taps stay in device memory and are staged kChunk at a time into
// shared memory together with the matching input window (kTile + kChunk - 1
// samples a row), so any tap count runs in fixed shared memory; __constant__
// memory would cap the filter at 16,384 int32 taps.
//
// What bounds it on an H100: 2 bytes of device memory per sample against
// L integer MACs per sample, each a shared-memory load of the sample, a
// broadcast load of the tap and a multiply-add.  Up to a few taps the memory
// side is the roof; beyond that the integer and load pipes are.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fixed.cuh"

namespace {

constexpr int kTile = 256;   // output columns per CTA, one per thread
constexpr int kRows = 4;     // rows per CTA
constexpr int kChunk = 256;  // taps staged per pass

__global__ void __launch_bounds__(kTile)
fir_direct_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  long long rows, long long n, long long col_tiles,
                  const int32_t* __restrict__ taps, int num_taps,
                  int frac_bits, int acc_bits) {
  __shared__ uint8_t xs[kRows][kTile + kChunk - 1];
  __shared__ uint32_t hs[kChunk];

  const long long tile = static_cast<long long>(blockIdx.x) % col_tiles;
  const long long row0 = (static_cast<long long>(blockIdx.x) / col_tiles) * kRows;
  const long long col0 = tile * kTile;
  const int center = num_taps / 2;
  const int t = threadIdx.x;

  uint32_t acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < num_taps; k0 += kChunk) {
    const int kc = min(kChunk, num_taps - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int j = t; j < kc; j += kTile) {
      hs[j] = static_cast<uint32_t>(taps[k0 + j]);
    }
    // Output col0 + c reads x[col0 + c + center - k]; for k in
    // [k0, k0 + kc) that spans kTile + kc - 1 samples from `base`.
    const long long base = col0 + center - (k0 + kc - 1);
    const int width = kTile + kc - 1;
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + r;
      for (int j = t; j < width; j += kTile) {
        const long long m = base + j;
        xs[r][j] = (row < rows && m >= 0 && m < n) ? x[row * n + m] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // Tap k0 + kk meets xs[r][t + kc - 1 - kk].
      const uint8_t* xw = &xs[r][t + kc - 1];
      uint32_t a = acc[r];
      for (int kk = 0; kk < kc; ++kk) {
        a += hs[kk] * static_cast<uint32_t>(xw[-kk]);  // wraps mod 2^32
      }
      acc[r] = a;
    }
  }

  const long long col = col0 + t;
  if (col >= n) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r;
    if (row < rows) {
      y[row * n + col] = wft::fixed_epilogue(acc[r], true, frac_bits, acc_bits);
    }
  }
}

}  // namespace

extern "C" int wft_fir_direct(const void* x, void* y, long long rows,
                              long long n, const void* taps, int num_taps,
                              int frac_bits, int acc_bits, void* stream) {
  if (rows < 1 || n < 1 || num_taps < 1 || frac_bits < 1 || frac_bits > 31 ||
      acc_bits < 1 || acc_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long col_tiles = (n + kTile - 1) / kTile;
  const long long blocks = col_tiles * ((rows + kRows - 1) / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fir_direct_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, n,
      col_tiles, static_cast<const int32_t*>(taps), num_taps, frac_bits,
      acc_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
