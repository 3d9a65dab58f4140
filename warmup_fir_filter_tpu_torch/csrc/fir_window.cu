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
// What differs from the TPU kernel: a CTA computes one 512-column tile of
// 8 rows and stages its input window (the tile plus taps - 1 halo columns)
// in shared memory, reading u8 0 (x~ = -128) outside the row exactly as the
// TPU's zero pad does.  So the bias is the one constant 128 * sum(h) (plus
// the rounding bias on the no-wrap path) of kernel A, and neither K3's
// per-tile bias table (:754) nor its overlap-save segmentation of over-wide
// rows (:965) is needed: one kernel takes any width.
//
// What bounds it on an H100: about taps / 4 * planes integer dot-4 steps per
// output against 2 bytes of device memory, so from a few tens of taps on it
// is bound by instruction issue.  The design spends its instructions on the
// products: each thread owns 4 adjacent columns, so one 32-bit shared load
// and three byte permutes feed four dp4a (16 MACs) per row, and one digit
// word is shared by all 8 rows.  int8 tensor cores (mma.sync s8*s8->s32 on
// the explicit Toeplitz band) are the next step, as for kernel A.
//
// Shared memory: 8 rows * (512 + taps + 3) bytes of window plus the digit
// words, about 57 KB at 4,096 taps, so it is dynamic shared memory, raised
// past the 48 KB default with cudaFuncSetAttribute where needed.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_window.cuh"

namespace {

constexpr int kMaxGridY = 65535;
constexpr int kDefaultSharedBytes = 48 * 1024;

struct WindowParams {
  int planes;
  int left;       // taps - 1 - taps / 2
  int row_words;  // wft::window_row_words(taps)
  int digit_words;
  int table[wft::kWindowMaxPlanes * wft::kPlaneFields];
  uint32_t bias;  // 128 * sum(h) (+ 2^(frac_bits-1) when !needs_wrap), mod 2^32
  int needs_wrap;
  int frac_bits;
  int acc_bits;
};

__global__ void __launch_bounds__(wft::kWindowThreads)
fir_window_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  long long rows, long long n,
                  const uint32_t* __restrict__ digits, WindowParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ int table[wft::kWindowMaxPlanes * wft::kPlaneFields];
  uint32_t* ds = smem;
  uint32_t* xs = smem + p.digit_words;
  uint8_t* xb = reinterpret_cast<uint8_t*>(xs);
  const int t = threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * wft::kWindowCols;
  const int row_bytes = 4 * p.row_words;

  if (t == 0) {
    // Constant indices keep the parameter table out of local memory.
#pragma unroll
    for (int i = 0; i < wft::kWindowMaxPlanes * wft::kPlaneFields; ++i) {
      table[i] = p.table[i];
    }
  }
  for (int j = t; j < p.digit_words; j += wft::kWindowThreads) ds[j] = digits[j];

  for (long long group = blockIdx.y; group * wft::kWindowRows < rows;
       group += gridDim.y) {
    const long long row0 = group * wft::kWindowRows;
    __syncthreads();  // the previous group's window is consumed
    for (int r = 0; r < wft::kWindowRows; ++r) {
      for (int j = t; j < row_bytes; j += wft::kWindowThreads) {
        xb[r * row_bytes + j] =
            wft::window_byte(x, rows, n, row0 + r, col0 - p.left + j);
      }
    }
    __syncthreads();
    wft::window_thread(xs, p.row_words, t, ds, table, p.planes, p.bias,
                       p.needs_wrap != 0, p.frac_bits, p.acc_bits, y, row0,
                       rows, n, col0);
  }
}

}  // namespace

// plane_table: kPlaneFields host ints per plane (exponent, first quad,
// quads, first digit word); digits: digit_words device words.
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
  WindowParams p;
  p.planes = planes;
  p.left = taps - 1 - taps / 2;
  p.row_words = wft::window_row_words(taps);
  p.digit_words = digit_words;
  const int* table = static_cast<const int*>(plane_table);
  for (int i = 0; i < wft::kWindowMaxPlanes * wft::kPlaneFields; ++i) {
    p.table[i] = i < planes * wft::kPlaneFields ? table[i] : 0;
  }
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
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;

  const long long col_tiles = (n + wft::kWindowCols - 1) / wft::kWindowCols;
  const long long groups = (rows + wft::kWindowRows - 1) / wft::kWindowRows;
  if (col_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes =
      4 * (static_cast<size_t>(digit_words) +
           static_cast<size_t>(wft::kWindowRows) * p.row_words);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(groups < kMaxGridY ? groups : kMaxGridY));
  fir_window_kernel<<<grid, wft::kWindowThreads, shared_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, n,
      static_cast<const uint32_t*>(digits), p);
  return static_cast<int>(cudaGetLastError());
}
