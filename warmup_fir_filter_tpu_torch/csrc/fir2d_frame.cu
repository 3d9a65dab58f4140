// Kernels E and F: the bit-exact dense Lr x Lc fixed-point 2-D FIR over a
// padded frame, output frame for input frame.
//
// Kernel E replaces warmup_fir_filter_tpu/kernels/fir2d_mxu.py::
// _fir2d_fullrow_kernel (:173; entry fir2d_fixed_frame :415) on the plain
// frame, any Lr and Lc <= 257.  Kernel F replaces _fir2d_oframe_kernel
// (:571; entry fir2d_fixed_frame_overlap :864) on the overlapped frame,
// 1 < Lc <= 97.  As there, each output is
//     acc = bias + sum_p (sum_k digit_p[k] * x~[R + Lr/2 - kr_p][n + Lc/2 - k]) << e_p
// over the kept (tap-row x signed base-256 digit) planes, x~ = x ^ 0x80 as
// int8, wrapping mod 2^32, then the shared epilogue (wft_fixed.cuh); pad
// rows, pad tiles and the columns outside the image are written as 0, and
// on the overlapped frame the boundary lanes take the neighbour tiles'
// values as the TPU kernel patches them, so the output frame is the TPU
// kernel's byte for byte (wft_fir2d.cuh).
//
// What differs from the TPU kernels: no band matrices.  The TPU multiplies
// each 128-lane tile by a 128 x 128 int8 band per plane on its matrix unit;
// here a thread owns one lane of 16 rows and walks the plane's Lc digits
// over a window staged in shared memory (16 + 15 rows of the three tiles
// around its tile), so a tall filter streams through 16 tap rows at a time
// and any Lr fits.  The per-plane sums are exact in int32 (|s| < 2^23).
//
// What bounds it on an H100: about two instructions (a shared byte load and
// an integer multiply-add) per tap per plane per output, against 2 bytes of
// device memory per output, so it is bound by instruction issue from a few
// taps on.  int8 tensor cores (mma.sync s8*s8->s32 on the band) and
// dp4a over packed columns, as kernel C does, are the next steps.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fir2d.cuh"

namespace {

constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(wft::kLane)
fir2d_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
             wft::Fir2dGeometry g, const int8_t* __restrict__ digits,
             const int* __restrict__ table, int planes, uint32_t bias,
             int needs_wrap, int frac_bits, int acc_bits) {
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
    uint32_t acc[wft::kFir2dRows];
#pragma unroll
    for (int r = 0; r < wft::kFir2dRows; ++r) acc[r] = bias;
    for (int p = 0; p < planes;) {
      const int k0 = table[wft::kFir2dPlaneFields * p];
      __syncthreads();  // the previous chunk's window is consumed
      for (int u = 0; u < wft::kFir2dWinRows; ++u) {
        const uint8_t* row = wft::fir2d_window_row(x, g, c, r0, k0, u);
        for (int v = i; v < wft::kFir2dWinCols; v += wft::kLane) {
          xs[u * wft::kFir2dWinCols + v] = row ? row[v] : 0;
        }
      }
      __syncthreads();
      p = wft::fir2d_int_planes(xs, s, digits, table, planes, p, k0, g.taps_c,
                                acc);
    }
    wft::fir2d_int_store(g, s, acc, needs_wrap != 0, frac_bits, acc_bits, y,
                         c, r0, i);
  }
}

int launch(int overlap, const void* x, void* y, long long hp, long long wp,
           const void* digits, const void* table, int planes, int taps_r,
           int taps_c, int t0, int core_h, int core_w, uint32_t bias,
           int needs_wrap, int frac_bits, int acc_bits, void* stream) {
  const bool taps_ok =
      overlap ? taps_c > 1 && taps_c - 1 <= wft::kFir2dMaxOverlap
              : taps_c >= 1 && taps_c <= wft::kFir2dMaxTapsC;
  if (hp < 1 || wp < 2 * wft::kLane || wp % wft::kLane || !taps_ok ||
      taps_r < 1 || planes < 0 || t0 < 1 || core_h < 0 || core_w < 0 ||
      frac_bits < 1 || frac_bits > 31 || acc_bits < 1 || acc_bits > 32 ||
      wp / wft::kLane > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wft::Fir2dGeometry g{hp, wp, t0, core_h, core_w, taps_r, taps_c,
                             overlap};
  const long long row_blocks = (hp + wft::kFir2dRows - 1) / wft::kFir2dRows;
  const dim3 grid(static_cast<unsigned>(wp / wft::kLane),
                  static_cast<unsigned>(row_blocks < kMaxGridY ? row_blocks
                                                               : kMaxGridY));
  fir2d_kernel<<<grid, wft::kLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), g,
      static_cast<const int8_t*>(digits), static_cast<const int*>(table),
      planes, bias, needs_wrap, frac_bits, acc_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// digits: planes rows of taps_c int8 on the device; table: planes x (tap
// row, exponent) int32 on the device, in tap-row order.
extern "C" int wft_fir2d_frame(const void* x, void* y, long long hp,
                               long long wp, const void* digits,
                               const void* table, int planes, int taps_r,
                               int taps_c, int t0, int core_h, int core_w,
                               uint32_t bias, int needs_wrap, int frac_bits,
                               int acc_bits, void* stream) {
  return launch(0, x, y, hp, wp, digits, table, planes, taps_r, taps_c, t0,
                core_h, core_w, bias, needs_wrap, frac_bits, acc_bits, stream);
}

extern "C" int wft_fir2d_oframe(const void* x, void* y, long long hp,
                                long long wp, const void* digits,
                                const void* table, int planes, int taps_r,
                                int taps_c, int t0, int core_h, int core_w,
                                uint32_t bias, int needs_wrap, int frac_bits,
                                int acc_bits, void* stream) {
  return launch(1, x, y, hp, wp, digits, table, planes, taps_r, taps_c, t0,
                core_h, core_w, bias, needs_wrap, frac_bits, acc_bits, stream);
}
