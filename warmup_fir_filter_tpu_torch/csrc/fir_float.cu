// Kernel H: the float32 same-mode FIR over (B, N) rows of uint8 or f32
// samples, up to 257 taps, raw and unclamped (the ideal model contract).
//
// Replaces warmup_fir_filter_tpu/kernels/fir_float_mxu.py: the kernels
// _fir_f32_fullrow_kernel (:106), _fir_f32_wide_kernel (:198) and
// _fir_f32_wide_chunk_kernel (:328) behind fir1d_ideal_rows_mxu (:559).
// Those are three blockings of one function for the TPU's VMEM (whole
// rows, column superblocks with one-tile halo operands, and a chunked loop
// over them); one CUDA kernel covers every width.  The TPU kernels multiply
// 128-lane tiles by the tri-tile band matrices of the taps in bf16x3 or
// six-pass f32; the card has native f32 FMAs, so a thread walks the taps
// themselves (wft_chain.cuh), which is the "highest" contract and meets the
// stricter of the JAX package's bounds (>= 120 dB against the f64 golden).
//
// A CTA computes 1,024 consecutive outputs of one row: it stages the taps
// and the input window (the tile plus taps - 1 halo samples, zeros outside
// the row: the same-mode zero pad) in shared memory as f32, then each of
// 256 threads computes 4 outputs 256 apart, reading each tap once for its
// four FMAs.  Samples are read once from device memory and each output
// written once.
//
// What bounds it on an H100: the chain's 63 taps over 32 x 1.33 M rows are
// 2.7 G FMAs against 341 MB of device traffic, so 0.04 ms of f32 issue at
// the card's 67 TFLOP/s against 0.1 ms of memory at 3.35 TB/s: memory is
// the roof.  This simple form does 1.25 shared-memory loads per FMA, so it
// is bound by shared-memory bandwidth well above that roof; register tiling
// of adjacent outputs is the next step.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_chain.cuh"

namespace {

constexpr int kMaxTaps = 257;  // fir_mxu.py MAX_TAPS, the tri-tile band
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(wft::kChainThreads)
fir_float_kernel(const T* __restrict__ x, float* __restrict__ y,
                 long long rows, long long n, const float* __restrict__ h,
                 int taps) {
  __shared__ float h_s[kMaxTaps];
  __shared__ float w_s[wft::kChainTile + kMaxTaps - 1];
  const int t = threadIdx.x;
  const long long o0 = static_cast<long long>(blockIdx.x) * wft::kChainTile;
  const int width = wft::fir_float_window(taps);
  for (int k = t; k < taps; k += wft::kChainThreads) h_s[k] = h[k];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    __syncthreads();  // the previous row's window is consumed
    wft::stage_window(x + row * n, n, wft::fir_float_base(o0, taps), w_s,
                      width, t, wft::kChainThreads);
    __syncthreads();
    wft::fir_float_thread(w_s, h_s, taps, t, y + row * n, n, o0);
  }
}

}  // namespace

// x (rows, n) uint8 when x_is_u8 else f32; y (rows, n) f32; h (taps) f32:
// device pointers.
extern "C" int wft_fir_float(const void* x, void* y, long long rows,
                             long long n, const void* h, int taps,
                             int x_is_u8, void* stream) {
  if (rows < 1 || n < 1 || taps < 1 || taps > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n + wft::kChainTile - 1) / wft::kChainTile;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_u8) {
    fir_float_kernel<uint8_t><<<grid, wft::kChainThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(y), rows, n,
        static_cast<const float*>(h), taps);
  } else {
    fir_float_kernel<float><<<grid, wft::kChainThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, n,
        static_cast<const float*>(h), taps);
  }
  return static_cast<int>(cudaGetLastError());
}
