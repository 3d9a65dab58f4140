// Kernel A: bit-exact same-mode Q-format FIR over (B, N) uint8 rows, for
// up to 257 taps.
//
// Replaces warmup_fir_filter_tpu/kernels/fir_mxu.py::_fir_mxu_fullrow_kernel
// (:248, rows up to 32,768 samples) and ::_fir_mxu_kernel (:371, wider rows,
// column-split with clamped halo tiles).  Both routes cover every width and
// mask the row edges themselves, so the host pads nothing.
//
// What bounds it on an H100: 2 bytes of device memory per sample (u8 in,
// u8 out), 0.095 ms for 19,456 x 8,192 at 3.35 TB/s, against `taps`
// multiply-adds per sample.  Up to a few dozen taps the memory side is the
// roof.
//
// Short-tap route (taps <= wft::kShortMaxTaps, the 3- and 5-tap banks of
// the main path and every 5-tap stream block): wft_band.cuh.  The samples
// are one flat byte stream; a thread owns 16 consecutive outputs (one
// 128-bit load of its chunk, the halo from its neighbours' chunks through
// L1, one 128-bit store), a row edge is a mask, the taps are kernel
// parameters, and the digit planes collapse into a uint32 multiply-add of
// the raw samples by the int32 taps from `bias - 128 sum(h)`: the same
// accumulator mod 2^32.  Template instances for 1-8, 12, 16, 24 and 32
// taps (a filter runs zero-padded on the first that holds it) keep every
// index a constant.  Two chunks a thread are loaded before either is
// computed: 8 KB of a CTA's own chunks in flight per 256 threads.
//
// Digit-plane route (more taps), in the encoding of the TPU band kernels
// (it is what int8 tensor cores will consume), also in wft_band.cuh: a CTA
// computes one 128-column output tile of 8 rows from its input window
// staged in shared memory, rebiased to int8, one signed base-256 digit
// plane at a time, then the wrap-or-fast epilogue of fir_mxu.py:295-307.
// The band matrices of the TPU formulation are Toeplitz, so this route
// reads only the (planes, taps) digits; this simple form issues byte-wide
// loads and plain integer MACs from shared memory.

#include <array>
#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "wft_band.cuh"

namespace {

__global__ void __launch_bounds__(wft::kBandLane)
fir_band_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                long long rows, long long n, long long col_tiles,
                const int8_t* __restrict__ digits, wft::BandParams p) {
  __shared__ int8_t xs[wft::kBandRows][wft::kBandWindow];
  __shared__ int8_t ds[wft::kBandMaxPlanes][wft::kBandMaxTaps];
  const long long block = blockIdx.x;
  const long long row0 = (block / col_tiles) * wft::kBandRows;
  const long long col0 = (block % col_tiles) * wft::kBandLane;
  const int i = threadIdx.x;
  wft::band_stage_thread(x, rows, n, row0, col0, digits, p, xs, ds, i);
  __syncthreads();
  wft::band_planes_thread(xs, ds, p, y, rows, n, row0, col0, i);
}

template <int L>
__global__ void __launch_bounds__(wft::kShortThreads)
fir_band_short_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                      long long total, long long n, long long chunks,
                      wft::BandShort p) {
  wft::short_thread<L>(x, y, total, n, chunks, p, blockIdx.x,
                       static_cast<int>(threadIdx.x));
}

using ShortKernel = void (*)(const uint8_t*, uint8_t*, long long, long long,
                             long long, wft::BandShort);

template <int... Is>
std::array<ShortKernel, sizeof...(Is)> short_kernels(
    std::integer_sequence<int, Is...>) {
  return {&fir_band_short_kernel<wft::kShortInstances[Is]>...};
}

int launch_short(const uint8_t* x, uint8_t* y, long long rows, long long n,
                 int taps, const int32_t* h, uint32_t bias, int needs_wrap,
                 int frac_bits, int acc_bits, cudaStream_t stream) {
  static const std::array<ShortKernel, wft::kShortInstanceCount> kernels =
      short_kernels(
          std::make_integer_sequence<int, wft::kShortInstanceCount>{});
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int instance = wft::short_instance(taps);
  const wft::BandShort p = wft::band_short_params(
      taps, wft::kShortInstances[instance], h, bias, needs_wrap, frac_bits,
      acc_bits);
  const long long total = rows * n;
  const long long chunks = (total + wft::kShortChunk - 1) / wft::kShortChunk;
  const long long blocks =
      (chunks + wft::kShortCtaChunks - 1) / wft::kShortCtaChunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernels[instance]<<<static_cast<unsigned>(blocks), wft::kShortThreads, 0,
                      stream>>>(x, y, total, n, chunks, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (rows, n) u8 and digits (planes, taps) int8: device pointers;
// exponents (planes) int and h_fixed (taps) int32: host arrays.  The
// output must be 16-byte aligned.
extern "C" int wft_fir_band(const void* x, void* y, long long rows,
                            long long n, const void* digits, int planes,
                            int taps, const void* exponents, uint32_t bias,
                            int needs_wrap, int frac_bits, int acc_bits,
                            const void* h_fixed, void* stream) {
  if (rows < 1 || n < 1 || planes < 1 || planes > wft::kBandMaxPlanes ||
      taps < 1 || taps > wft::kBandMaxTaps || frac_bits < 1 ||
      frac_bits > 31 || acc_bits < 1 || acc_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps <= wft::kShortMaxTaps) {
    return launch_short(static_cast<const uint8_t*>(x),
                        static_cast<uint8_t*>(y), rows, n, taps,
                        static_cast<const int32_t*>(h_fixed), bias,
                        needs_wrap, frac_bits, acc_bits, s);
  }
  wft::BandParams p;
  p.planes = planes;
  p.taps = taps;
  p.left = taps - 1 - taps / 2;
  const int* exps = static_cast<const int*>(exponents);
  for (int b = 0; b < wft::kBandMaxPlanes; ++b) {
    p.exps[b] = b < planes ? exps[b] : 0;
  }
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  const long long col_tiles = (n + wft::kBandLane - 1) / wft::kBandLane;
  const long long blocks =
      col_tiles * ((rows + wft::kBandRows - 1) / wft::kBandRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fir_band_kernel<<<static_cast<unsigned>(blocks), wft::kBandLane, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, n,
      col_tiles, static_cast<const int8_t*>(digits), p);
  return static_cast<int>(cudaGetLastError());
}
