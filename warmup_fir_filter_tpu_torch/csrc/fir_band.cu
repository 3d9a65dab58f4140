// Kernel A: bit-exact same-mode Q-format FIR over (B, N) uint8 rows, for
// up to 257 taps, in the digit-plane encoding of the TPU band kernels.
//
// Replaces warmup_fir_filter_tpu/kernels/fir_mxu.py::_fir_mxu_fullrow_kernel
// (:248, rows up to 32,768 samples) and ::_fir_mxu_kernel (:371, wider rows,
// column-split with clamped halo tiles).  One kernel covers every width: a
// CTA computes one 128-column output tile of kRows rows, stages the tile's
// input window (the tile plus its `left` / `center` halo) in shared memory
// and masks the row edges and the ragged right edge itself, so the host
// pads nothing.
//
// Encoding kept from the TPU kernels (it is what int8 tensor cores will
// consume): samples are rebiased to x~ = x ^ 0x80 as int8; positions outside
// the row read u8 0, i.e. x~ = -128, whose share is cancelled by the
// 128 * sum(h) term of the bias; the coefficients are signed base-256 digit
// planes with a shift exponent each, and
//     acc = bias + sum_b (sum_k digit_b[k] * x~[n - k + center]) << exp_b
// wraps mod 2^32, then the wrap-or-fast epilogue of fir_mxu.py:295-307.
// The band matrices of the TPU formulation are Toeplitz, so this kernel
// reads only the (planes, taps) digits; the full band planes are needed once
// the products move onto mma.sync / wgmma s8*s8->s32 (a later change, with
// TMA staging).
//
// What bounds it on an H100: 2 bytes of device memory per sample (u8 in,
// u8 out) against about `taps` integer MACs per digit plane per sample.
// For the 3- and 5-tap banks the memory side is the roof; this simple
// version issues byte-wide loads and plain integer MACs from shared memory.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fixed.cuh"

namespace {

constexpr int kLane = 128;                 // output columns per CTA
constexpr int kRows = 8;                   // rows per CTA
constexpr int kMaxTaps = 2 * kLane + 1;    // tri-tile limit, fir_mxu.py:82
constexpr int kMaxPlanes = 5;              // base-256 digits of an int32
constexpr int kWindow = kLane + kMaxTaps - 1;

struct BandParams {
  int planes;
  int taps;
  int left;  // taps - 1 - taps / 2
  int exps[kMaxPlanes];
  uint32_t bias;  // 128 * sum(h) (+ 2^(frac_bits-1) when !needs_wrap), mod 2^32
  int needs_wrap;
  int frac_bits;
  int acc_bits;
};

__global__ void __launch_bounds__(kLane)
fir_band_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                long long rows, long long n, long long col_tiles,
                const int8_t* __restrict__ digits, BandParams p) {
  __shared__ int8_t xs[kRows][kWindow];
  __shared__ int8_t ds[kMaxPlanes][kMaxTaps];

  const long long tile = static_cast<long long>(blockIdx.x) % col_tiles;
  const long long row0 = (static_cast<long long>(blockIdx.x) / col_tiles) * kRows;
  const long long col0 = tile * kLane;
  const int width = kLane + p.taps - 1;
  const int i = threadIdx.x;

  for (int j = i; j < p.planes * p.taps; j += kLane) {
    ds[j / p.taps][j % p.taps] = digits[j];
  }
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r;
    for (int j = i; j < width; j += kLane) {
      const long long m = col0 - p.left + j;
      uint8_t v = 0;  // zero pad: rebiases to -128
      if (row < rows && m >= 0 && m < n) v = x[row * n + m];
      xs[r][j] = static_cast<int8_t>(v ^ 0x80u);
    }
  }
  __syncthreads();

  const long long col = col0 + i;
  if (col >= n) return;
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;
    // xs[r][i + taps - 1 - k] holds x~[col - k + center].
    const int8_t* xw = &xs[r][i + p.taps - 1];
    uint32_t acc = p.bias;
    // Constant plane indices keep p.exps out of local memory.
#pragma unroll
    for (int b = 0; b < kMaxPlanes; ++b) {
      if (b < p.planes) {
        const int8_t* d = ds[b];
        int32_t s = 0;  // |s| <= 257 * 128 * 128: no overflow
        for (int k = 0; k < p.taps; ++k) {
          s += static_cast<int32_t>(d[k]) * static_cast<int32_t>(xw[-k]);
        }
        const int e = p.exps[b];
        // A shift of 32 or more leaves nothing mod 2^32 (and is UB in C++).
        if (e < 32) acc += static_cast<uint32_t>(s) << e;
      }
    }
    y[row * n + col] =
        wft::fixed_epilogue(acc, p.needs_wrap != 0, p.frac_bits, p.acc_bits);
  }
}

}  // namespace

extern "C" int wft_fir_band(const void* x, void* y, long long rows,
                            long long n, const void* digits, int planes,
                            int taps, const void* exponents, uint32_t bias,
                            int needs_wrap, int frac_bits, int acc_bits,
                            void* stream) {
  if (rows < 1 || n < 1 || planes < 1 || planes > kMaxPlanes || taps < 1 ||
      taps > kMaxTaps || frac_bits < 1 || frac_bits > 31 || acc_bits < 1 ||
      acc_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BandParams p;
  p.planes = planes;
  p.taps = taps;
  p.left = taps - 1 - taps / 2;
  const int* exps = static_cast<const int*>(exponents);
  for (int b = 0; b < kMaxPlanes; ++b) p.exps[b] = b < planes ? exps[b] : 0;
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;

  const long long col_tiles = (n + kLane - 1) / kLane;
  const long long blocks = col_tiles * ((rows + kRows - 1) / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fir_band_kernel<<<static_cast<unsigned>(blocks), kLane, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, n,
      col_tiles, static_cast<const int8_t*>(digits), p);
  return static_cast<int>(cudaGetLastError());
}
