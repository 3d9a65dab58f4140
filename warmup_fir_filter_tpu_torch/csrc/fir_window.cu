// Kernel C: bit-exact same-mode Q-format FIR over (B, N) uint8 rows for up
// to 4,096 taps, in the windowed digit-plane formulation of the TPU kernel.
//
// Replaces warmup_fir_filter_tpu/kernels/fir_mxu.py::_fir_mxu_window_kernel
// (:792; entry fir1d_fixed_rows_mxu_window :890, planes
// build_window_band_planes :691).  As there, each output column is
//     acc = bias + sum_b (sum_{k in [kmin_b, kmax_b]} digit_b[k] * x~[n-k+c]) << e_b
// over the kept signed base-256 digit planes, wrapping mod 2^32, then the
// shared epilogue (wft_fixed.cuh); each plane walks only its own nonzero tap
// range, which is K3's trimming (a long low-pass's high-byte plane covers
// its main lobe only).
//
// As on the TPU, the product is a matrix product with each plane's Toeplitz
// band on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32,
// wft_window.cuh::window_warp), without the band itself: M indexes
// 8-column sub-tiles of one row, so even the 16-row stream block fills an
// MMA, and the band's fragments come from four shifted copies of the
// plane's reversed digits in shared memory.  Positions outside a row read
// u8 0 (x~ = -128) exactly as the TPU's zero pad does, so the bias is the
// one constant 128 * sum(h) (plus the rounding bias on the no-wrap path) of
// kernel A, and neither K3's per-tile bias table (:754) nor its
// overlap-save segmentation of over-wide rows (:965) is needed: one kernel
// takes any width.
//
// What bounds it on an H100: the products, about (taps + 10) / 4096 m16n8k32
// MMAs per output and plane against 2 bytes of device memory, and the
// shared-memory words that feed them.  Each warp works alone on items of
// 512 columns of one row (4 m16 tiles): the A words of a chunk are two new
// loads a lane, the rest held in a ring of registers, and the two B words
// of a chunk serve the four tiles.  The window of the next item stages
// asynchronously (cp.async, 16-byte chunks at the row's own alignment)
// into the warp's second buffer while the current one multiplies; the
// plane's k range starts at the row's misalignment below a quad, so every
// A word is still an aligned load.
//
// Shared memory: the digit copies (about 16 bytes a tap and plane) and two
// windows (512 + taps + about 40 bytes) a warp; past 48 KB it is raised
// with cudaFuncSetAttribute.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_window.cuh"

namespace {

struct WindowParams {
  wft::WindowLayout lay;
  int left;       // taps - 1 - taps / 2
  uint32_t bias;  // 128 * sum(h) (+ 2^(frac_bits-1) when !needs_wrap), mod 2^32
  int needs_wrap;
  int frac_bits;
  int acc_bits;
  long long col_tiles;
  long long items;  // rows * col_tiles
};

// Byte offset of the warps' staging buffers, past the digit copies.
__host__ __device__ inline size_t buffers_at(const wft::WindowLayout& lay) {
  return (4 * static_cast<size_t>(lay.copy_words) + 15) / 16 * 16;
}

__global__ void __launch_bounds__(wft::kWindowThreads)
fir_window_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  long long n, const uint32_t* __restrict__ digits,
                  WindowParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  // In shared memory, so that a plane's fields are read by a runtime index
  // without a local-memory copy of the parameters.
  __shared__ wft::WindowLayout lay;
  if (threadIdx.x == 0) lay = p.lay;
  __syncthreads();
  uint32_t* ds = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < lay.copy_words; i += wft::kWindowThreads) {
    ds[i] = wft::window_copy_word(digits, lay, i);
  }
  __syncthreads();

  // Locals, not references to the parameters, which would copy them to
  // local memory.
  const long long col_tiles = p.col_tiles;
  const long long items = p.items;
  const int left = p.left;
  const int buf_bytes = lay.buf_bytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* bufs = smem + buffers_at(lay) + 2 * warp * buf_bytes;
  // Each warp walks a contiguous run of items, so the next item is the
  // next 512 columns of the row (or the next row) with no division.
  const long long warps = static_cast<long long>(gridDim.x) * wft::kWindowWarps;
  const long long w = static_cast<long long>(blockIdx.x) * wft::kWindowWarps + warp;
  const long long first = items / warps * w + (w < items % warps ? w : items % warps);
  const long long count = items / warps + (w < items % warps ? 1 : 0);
  long long r = first / col_tiles;
  long long col0 = first % col_tiles * wft::kWindowCols;
  long long next_r = r;
  long long next_col0 = col0;
  const auto advance = [&]() {
    next_col0 += wft::kWindowCols;
    if (next_col0 >= static_cast<long long>(col_tiles) * wft::kWindowCols) {
      next_col0 = 0;
      ++next_r;
    }
  };
  int off = 0;
  if (count > 0) off = wft::window_stage(bufs, x, n, r, col0, left, lay, lane);
  wft::async_commit();
  for (long long k = 0; k < count; ++k) {
    // The next item's window lands while this one multiplies.
    advance();
    int next_off = 0;
    if (k + 1 < count) {
      next_off = wft::window_stage(bufs + ((k + 1) & 1) * buf_bytes, x, n,
                                   next_r, next_col0, left, lay, lane);
    }
    wft::async_commit();
    wft::async_wait<1>();
    __syncwarp();
    wft::window_warp(bufs + (k & 1) * buf_bytes, off, ds, lay, p.bias,
                     p.needs_wrap != 0, p.frac_bits, p.acc_bits, y, r, n,
                     col0);
    __syncwarp();  // the buffer is read before it is staged again
    r = next_r;
    col0 = next_col0;
    off = next_off;
  }
}

}  // namespace

// plane_table: kPlaneFields host ints per plane (exponent, first quad,
// quads, first digit word); digits: digit_words device words of each
// plane's reversed digits in quads.
extern "C" int wft_fir_window(const void* x, void* y, long long rows,
                              long long n, const void* digits,
                              int digit_words, int planes, int taps,
                              const void* plane_table, uint32_t bias,
                              int needs_wrap, int frac_bits, int acc_bits,
                              void* stream) {
  if (rows < 1 || n < 1 || planes < 1 || planes > wft::kWindowMaxPlanes ||
      taps < 1 || taps > wft::kWindowMaxTaps || digit_words < 1 ||
      frac_bits < 1 || frac_bits > 31 || acc_bits < 1 || acc_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* table = static_cast<const int*>(plane_table);
  for (int b = 0; b < planes; ++b) {
    const int* plane = table + b * wft::kPlaneFields;
    // Every word a plane reads must lie inside its row and the digits.
    if (plane[wft::kPlaneQuad0] < 0 || plane[wft::kPlaneQuads] < 0 ||
        plane[wft::kPlaneQuad0] + plane[wft::kPlaneQuads] > (taps + 3) / 4 ||
        plane[wft::kPlaneOffset] < 0 ||
        plane[wft::kPlaneOffset] + plane[wft::kPlaneQuads] > digit_words) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  WindowParams p;
  p.lay = wft::window_layout(table, planes);
  p.left = taps - 1 - taps / 2;
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  p.col_tiles = (n + wft::kWindowCols - 1) / wft::kWindowCols;
  if (p.col_tiles > LLONG_MAX / rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.items = rows * p.col_tiles;
  const size_t shared_bytes =
      buffers_at(p.lay) +
      2 * wft::kWindowWarps * static_cast<size_t>(p.lay.buf_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      fir_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // A persistent grid: as many CTAs as are resident at once, each walking
  // its warps through the items.
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fir_window_kernel, wft::kWindowThreads, shared_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (p.items + wft::kWindowWarps - 1) / wft::kWindowWarps;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(ctas < resident ? ctas : resident);
  fir_window_kernel<<<grid, wft::kWindowThreads, shared_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), n,
      static_cast<const uint32_t*>(digits), p);
  return static_cast<int>(cudaGetLastError());
}
