// Kernel G: the 2-D FIR over an overlapped frame with bf16 taps and f32
// sums, output frame for input frame.
//
// Replaces warmup_fir_filter_tpu/kernels/fir2d_mxu.py::
// _fir2d_oframe_bf16_kernel (:1000; entry fir2d_frame_overlap_bf16 :1137).
// As there, each tap row's quantized taps ride as bf16 values (rounded to
// nearest even on the host), the samples as floats without rebias, each row
// gives one f32 sum per output, the rows are added in order and the float
// epilogue floor(acc * 2^-fb + 0.5), clipped to [0, 255], replaces the
// integer one; the boundary lanes and the masks are K7's
// (wft_fir2d.cuh::fir2d_lane).  Every product is exact in f32, so where
// bf16_2d_exact() holds (all sums below 2^24) the output is bit-exact
// against the golden; elsewhere the order of the sums, which differs from
// the TPU's matrix unit and from the plain version's matmul, may move an
// output by one.
//
// What differs from the TPU kernel, and what bounds it on an H100: as
// kernel E, a thread owns one lane of 16 rows and walks each row's Lc taps
// over a window staged in shared memory, one f32 multiply-add and one
// shared byte load per tap and output, bound by instruction issue; bf16
// tensor cores (wgmma on the band) are the next step.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fir2d.cuh"

namespace {

constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(wft::kLane)
fir2d_bf16_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  wft::Fir2dGeometry g, const float* __restrict__ w,
                  const int* __restrict__ table, int rows, float scale) {
  __shared__ uint8_t xs[wft::kFir2dWinRows * wft::kFir2dWinCols];
  const long long c = blockIdx.x;
  const int i = threadIdx.x;
  for (long long r0 = static_cast<long long>(blockIdx.y) * wft::kFir2dRows;
       r0 < g.hp; r0 += static_cast<long long>(gridDim.y) * wft::kFir2dRows) {
    if (wft::fir2d_cta_is_zero(g, c, r0)) {
      wft::fir2d_store_zero(g, y, c, r0, i);
      continue;
    }
    const wft::Fir2dLane s = wft::fir2d_lane(g, c, i);
    float acc[wft::kFir2dRows];
#pragma unroll
    for (int r = 0; r < wft::kFir2dRows; ++r) acc[r] = 0.0f;
    for (int p = 0; p < rows;) {
      const int k0 = table[p];
      __syncthreads();  // the previous chunk's window is consumed
      for (int u = 0; u < wft::kFir2dWinRows; ++u) {
        const uint8_t* row = wft::fir2d_window_row(x, g, c, r0, k0, u);
        for (int v = i; v < wft::kFir2dWinCols; v += wft::kLane) {
          xs[u * wft::kFir2dWinCols + v] = row ? row[v] : 0;
        }
      }
      __syncthreads();
      p = wft::fir2d_bf16_rows(xs, s, w, table, rows, p, k0, g.taps_c, acc);
    }
    wft::fir2d_bf16_store(g, s, acc, scale, y, c, r0, i);
  }
}

}  // namespace

// w: rows x taps_c f32 (bf16-exact) on the device; table: the tap row of
// each, int32 on the device, in tap-row order.
extern "C" int wft_fir2d_bf16(const void* x, void* y, long long hp,
                              long long wp, const void* w, const void* table,
                              int rows, int taps_r, int taps_c, int t0,
                              int core_h, int core_w, int frac_bits,
                              void* stream) {
  if (hp < 1 || wp < 2 * wft::kLane || wp % wft::kLane || taps_r < 1 ||
      taps_c < 2 || taps_c - 1 > wft::kFir2dMaxOverlap || rows < 0 || t0 < 1 ||
      core_h < 0 || core_w < 0 || frac_bits < 0 || frac_bits > 126 ||
      wp / wft::kLane > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wft::Fir2dGeometry g{hp, wp, t0, core_h, core_w, taps_r, taps_c, 1};
  const long long row_blocks = (hp + wft::kFir2dRows - 1) / wft::kFir2dRows;
  const dim3 grid(static_cast<unsigned>(wp / wft::kLane),
                  static_cast<unsigned>(row_blocks < kMaxGridY ? row_blocks
                                                               : kMaxGridY));
  fir2d_bf16_kernel<<<grid, wft::kLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), g,
      static_cast<const float*>(w), static_cast<const int*>(table), rows,
      ldexpf(1.0f, -frac_bits));
  return static_cast<int>(cudaGetLastError());
}
