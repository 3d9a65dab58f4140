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
// Short-tap route (up to wft::kBandShortMaxTaps = 6 taps: the 3- and 5-tap
// banks of the main path and every 5-tap stream block): wft_band.cuh.  The
// samples
// are one flat byte stream; a thread owns 16 consecutive outputs (one
// 128-bit load of its chunk, the halo from its neighbours' chunks through
// L1, one 128-bit store), a row edge is a mask, the taps are kernel
// parameters, and the digit planes collapse into a uint32 multiply-add of
// the raw samples by the int32 taps from `bias - 128 sum(h)`: the same
// accumulator mod 2^32.  A template instance for each tap count keeps
// every index a constant.  Two chunks a thread are loaded before either is
// computed: 8 KB of a CTA's own chunks in flight per 256 threads.  It costs
// a multiply-add a tap and output; the digit-plane route costs about the
// same from 1 to 16 taps, so from 7 taps on it is the faster one.
//
// Digit-plane route (more taps, up to 257), in the encoding of the TPU band
// kernels: the kept signed base-256 digit planes of the taps, each with its
// shift exponent, and the start value 128 sum(h) (plus the rounding bias on
// the no-wrap path), then the wrap-or-fast epilogue of fir_mxu.py:295-307.
// As on the TPU's matrix unit, each plane multiplies the samples by its
// Toeplitz band, here on the int8 tensor cores (mma.sync m16n8k32,
// wft_band.cuh::planes_warp): 16 output columns of a sub-tile by 8
// sub-tiles of a 128-column tile, k over the band's taps + 15 in
// ceil((taps + 15) / 32) chunks (2 at 33 taps, 9 at 257).  The band is
// the A operand and the same for every tile: each lane builds its
// fragments once (up to two planes at a time held in registers; more
// planes reload theirs from shared memory an item), and the samples, the
// B operand, are the two words of one 8-byte shared load a chunk, taken
// as u8 (an s8 x u8 MMA), so they need no rebias: the start
// bias - 128 sum(h) accounts for it, as in the short-tap route.  Bound on
// an H100: the bytes, 0.095 ms at 19,456 x 8,192, up to 257 taps, where
// the band's padded products are about 184 G operations with two planes,
// 0.093 ms at the int8 peak.
//
// The first form of this route (a thread a column, byte loads and integer
// multiply-adds from shared memory: 2.78 ms at 33 taps and 19.95 ms at 257
// on an H100) was bound by issuing its shared-memory loads.  This one
// takes 0.18-0.29 ms there (PERF.md): the window and store pipeline alone
// about 0.14 ms, and the MMAs on top of it, mma.sync giving an m16n8k32
// about every 15 cycles on each SM sub-partition, well under the int8
// peak.  It works in items of 1,024 columns of one row a warp, four warps
// a CTA, a persistent grid: the prologue (digits, fragments) runs once a
// CTA, an item's window (1,024 + 32 chunks - 16 bytes, from the row's
// 16-byte boundary below it, so no row needs realigning) lands by cp.async
// three items ahead of the one the warp multiplies, and the outputs leave
// through a shared tile in 16-byte stores.

#include <array>
#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "wft_band.cuh"
#include "wft_resident.cuh"

namespace {

template <int CHUNKS>
__global__ void __launch_bounds__(wft::kPlanesThreads)
fir_band_planes_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                       long long rows, long long n,
                       const int8_t* __restrict__ digits, wft::PlanesParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const wft::PlanesLayout lay = wft::planes_layout(p.planes, p.taps, CHUNKS);
  const int i = static_cast<int>(threadIdx.x);
  wft::planes_setup_digits(smem, digits, p, lay, i);
  __syncthreads();
  wft::planes_setup_band(smem, p, lay, i);
  __syncthreads();
  const int warp = i >> 5;
  long long first = 0;
  long long count = 0;
  wft::planes_share(p.items,
                    static_cast<long long>(gridDim.x) * wft::kPlanesWarps,
                    static_cast<long long>(blockIdx.x) * wft::kPlanesWarps +
                        warp,
                    &first, &count);
  wft::planes_warp<CHUNKS>(x, y, rows, n, smem,
                           smem + lay.warps + warp * lay.warp_bytes, p, lay,
                           first, count);
}

using PlanesKernel = void (*)(const uint8_t*, uint8_t*, long long, long long,
                              const int8_t*, wft::PlanesParams);

template <int... Is>
std::array<PlanesKernel, sizeof...(Is)> planes_kernels(
    std::integer_sequence<int, Is...>) {
  return {&fir_band_planes_kernel<Is + 1>...};
}

int launch_planes(const uint8_t* x, uint8_t* y, long long rows, long long n,
                  const int8_t* digits, int planes, int taps,
                  const int* exps, uint32_t bias, int needs_wrap,
                  int frac_bits, int acc_bits, const int32_t* h,
                  cudaStream_t stream) {
  static const std::array<PlanesKernel, wft::kPlanesMaxChunks> kernels =
      planes_kernels(std::make_integer_sequence<int, wft::kPlanesMaxChunks>{});
  static std::array<wft::ResidentCache, wft::kPlanesMaxChunks> caches;
  const wft::PlanesParams p =
      wft::planes_params(rows, n, planes, taps, exps, bias, needs_wrap,
                         frac_bits, acc_bits, h);
  if (p.items < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PlanesKernel kernel = kernels[p.chunks - 1];
  const size_t shared_bytes = static_cast<size_t>(
      wft::planes_layout(planes, taps, p.chunks).total);
  long long resident = 0;
  const cudaError_t err = wft::resident_ctas(
      kernel, wft::kPlanesThreads, shared_bytes, caches[p.chunks - 1],
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long sets =
      (p.items + wft::kPlanesWarps - 1) / wft::kPlanesWarps;
  const long long ctas = sets < resident ? sets : resident;
  kernel<<<static_cast<unsigned>(ctas > 0 ? ctas : 1), wft::kPlanesThreads,
           shared_bytes, stream>>>(x, y, rows, n, digits, p);
  return static_cast<int>(cudaGetLastError());
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
  static const std::array<ShortKernel, wft::kBandShortInstances> kernels =
      short_kernels(
          std::make_integer_sequence<int, wft::kBandShortInstances>{});
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

bool bad_args(long long rows, long long n, int planes, int taps,
              int frac_bits, int acc_bits) {
  return rows < 1 || n < 1 || planes < 1 || planes > wft::kBandMaxPlanes ||
         taps < 1 || taps > wft::kBandMaxTaps || frac_bits < 1 ||
         frac_bits > 31 || acc_bits < 1 || acc_bits > 32;
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
  if (bad_args(rows, n, planes, taps, frac_bits, acc_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps <= wft::kBandShortMaxTaps) {
    return launch_short(static_cast<const uint8_t*>(x),
                        static_cast<uint8_t*>(y), rows, n, taps,
                        static_cast<const int32_t*>(h_fixed), bias,
                        needs_wrap, frac_bits, acc_bits, s);
  }
  return launch_planes(static_cast<const uint8_t*>(x),
                       static_cast<uint8_t*>(y), rows, n,
                       static_cast<const int8_t*>(digits), planes, taps,
                       static_cast<const int*>(exponents), bias, needs_wrap,
                       frac_bits, acc_bits,
                       static_cast<const int32_t*>(h_fixed), s);
}

// wft_fir_band's digit-plane route at any tap count, the short-tap route's
// too: probe_kernels.py times the two against each other at the crossover.
extern "C" int wft_fir_band_planes(const void* x, void* y, long long rows,
                                   long long n, const void* digits,
                                   int planes, int taps,
                                   const void* exponents, uint32_t bias,
                                   int needs_wrap, int frac_bits,
                                   int acc_bits, const void* h_fixed,
                                   void* stream) {
  if (bad_args(rows, n, planes, taps, frac_bits, acc_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_planes(static_cast<const uint8_t*>(x),
                       static_cast<uint8_t*>(y), rows, n,
                       static_cast<const int8_t*>(digits), planes, taps,
                       static_cast<const int*>(exponents), bias, needs_wrap,
                       frac_bits, acc_bits,
                       static_cast<const int32_t*>(h_fixed),
                       static_cast<cudaStream_t>(stream));
}
