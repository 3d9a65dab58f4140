// Kernel J: the DSP chain in one pass -- polyphase P/Q resample, same-mode
// channelizer FIR, FM discriminator -- over (C, T) I and Q rows into
// (C, ceil(T P/Q)) f32 messages.  The TPU kernel takes the planes stacked as
// (2C, T) rows; here they are two pointers, which spares the stacking copy.
//
// Replaces warmup_fir_filter_tpu/kernels/chain_fused.py::_chain_fused_kernel
// (:133; entry chain_forward_fused :416, gate chain_fused_supported :394).
// As there, the resampled and channelized intermediates never reach device
// memory: the input is read once and the messages written once.  A CTA
// computes 1,024 messages of one channel, in four stages separated by
// barriers (wft_chain.cuh):
//   0  stage the I and Q input windows and the taps in shared memory,
//   1  resample the 1,024 + Lc samples the channelizer reads, both planes,
//      and zero those outside [lo, hi): the staged path zero-pads the
//      resampled stream, and the values computed just outside [0, out_len)
//      from the zero-padded input are not zero (chain_fused.py:246-265);
//      the time-sharded chain passes its global window as [lo, hi),
//   2  channelize 1,025 samples a plane: one to the left of the tile, since
//      each message needs the previous channelized sample (:281-307),
//   3  the discriminator, atan2(cross, dot) / (2 pi k_f), 0 at output 0
//      (:319-323).
// The TPU kernel computes atan2 with a polynomial (atan2_poly, :95-130)
// because Mosaic has none; here it is CUDA's atan2f, which gives numpy's
// atan2(0, 0) = 0 and atan2(-0.0, -1) = -pi.  "bf16x3" and "highest" are
// both plain f32 FMAs; "bf16" reads bf16 I/Q, takes bf16 taps and rounds
// each resampled sample to bf16 before the channelizer, with f32 sums
// (:270-272, :443, :470-479).
//
// What bounds it on an H100: the flagship (2/3, 63 + 63 taps) over
// 2 x 16 x 2 M samples reads 256 MB and writes 85 MB for about 4.1 G FMAs
// (32 resample and 63 channelizer taps per sample of each plane), so f32
// issue (0.12 ms at 67 TFLOP/s) and memory (0.1 ms at 3.35 TB/s) bound it
// about equally.  This simple form is bound by shared-memory bandwidth,
// about 1.25 loads per FMA, and recomputes Lc / 1,024 of the resampled
// samples at the tile seams; tensor cores for the two band stages are the
// next step.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_chain.cuh"

namespace {

constexpr int kMaxGridY = 65535;
constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;

// Shared floats: rs taps, channelizer taps, 2 input windows, 2 resampled
// runs, 2 channelized runs.
size_t chain_shared_floats(const wft::ChainPlan& c) {
  return static_cast<size_t>(c.rs.up) * c.rs.tap_stride + c.ch_taps +
         2 * static_cast<size_t>(wft::chain_in_window(c)) +
         2 * static_cast<size_t>(wft::chain_rs_count(c)) +
         2 * static_cast<size_t>(wft::kChainTile + 1);
}

template <typename T>
__global__ void __launch_bounds__(wft::kChainThreads)
chain_fused_kernel(const T* __restrict__ x_re, const T* __restrict__ x_im,
                   float* __restrict__ y,
                   long long channels, long long n, long long out_len,
                   const float* __restrict__ rs_taps,
                   const float* __restrict__ ch_taps, wft::ChainPlan c) {
  extern __shared__ float smem[];
  const int rs_tap_floats = c.rs.up * c.rs.tap_stride;
  const int in_w = wft::chain_in_window(c);
  const int rs_n = wft::chain_rs_count(c);
  float* rs_taps_s = smem;
  float* ch_taps_s = rs_taps_s + rs_tap_floats;
  float* xs = ch_taps_s + c.ch_taps;   // [2][in_w]
  float* rs = xs + 2 * in_w;           // [2][rs_n]
  float* ch = rs + 2 * rs_n;           // [2][kChainTile + 1]
  const int t = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * wft::kChainTile;
  for (int k = t; k < rs_tap_floats; k += wft::kChainThreads) {
    rs_taps_s[k] = rs_taps[k];
  }
  for (int k = t; k < c.ch_taps; k += wft::kChainThreads) {
    ch_taps_s[k] = ch_taps[k];
  }
  const long long in0 = wft::chain_in_base(m0, c);
  for (long long ch_row = blockIdx.y; ch_row < channels; ch_row += gridDim.y) {
    __syncthreads();  // the previous channel's windows are consumed
    for (int plane = 0; plane < 2; ++plane) {
      wft::stage_window((plane ? x_im : x_re) + ch_row * n, n, in0,
                        xs + plane * in_w, in_w, t, wft::kChainThreads);
    }
    __syncthreads();
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_resample_thread(xs + plane * in_w, rs_taps_s, c, t,
                                 rs + plane * rs_n, m0);
    }
    __syncthreads();
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_channelize_thread(rs + plane * rs_n, ch_taps_s, c, t,
                                   ch + plane * (wft::kChainTile + 1));
    }
    __syncthreads();
    wft::chain_demod_thread(ch, ch + wft::kChainTile + 1, c, t,
                            y + ch_row * out_len, out_len, m0);
  }
}

}  // namespace

// x_re, x_im (channels, n) f32, or bf16 bits when bf16; y (channels,
// out_len) f32; rs_taps (up, tap_stride) f32; ch_taps (ch_len) f32: device
// pointers.  [lo, hi) is the valid window of the resampled stream.
extern "C" int wft_chain_fused(const void* x_re, const void* x_im, void* y,
                               long long channels,
                               long long n, long long out_len,
                               const void* rs_taps, int up, int down,
                               int center, int len, int tap_stride,
                               const void* ch_taps, int ch_len, long long lo,
                               long long hi, float inv_gain, int bf16,
                               void* stream) {
  if (channels < 1 || n < 1 || out_len < 1 || up < 1 || down < 1 ||
      wft::kChainThreads % up != 0 || center < 0 || len < 1 ||
      tap_stride < len || ch_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wft::ChainPlan c;
  c.rs = wft::PolyPlan{up, down, center, len, tap_stride};
  c.ch_taps = ch_len;
  c.lo = lo;
  c.hi = hi;
  c.inv_gain = inv_gain;
  c.bf16 = bf16 != 0;
  const size_t shared_bytes = 4 * chain_shared_floats(c);
  const long long tiles = (out_len + wft::kChainTile - 1) / wft::kChainTile;
  if (tiles > INT_MAX || shared_bytes > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(channels < kMaxGridY ? channels
                                                             : kMaxGridY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c.bf16) {
    if (shared_bytes > kDefaultSharedBytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          chain_fused_kernel<uint16_t>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chain_fused_kernel<uint16_t><<<grid, wft::kChainThreads, shared_bytes, s>>>(
        static_cast<const uint16_t*>(x_re), static_cast<const uint16_t*>(x_im),
        static_cast<float*>(y), channels, n,
        out_len, static_cast<const float*>(rs_taps),
        static_cast<const float*>(ch_taps), c);
  } else {
    if (shared_bytes > kDefaultSharedBytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          chain_fused_kernel<float>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chain_fused_kernel<float><<<grid, wft::kChainThreads, shared_bytes, s>>>(
        static_cast<const float*>(x_re), static_cast<const float*>(x_im),
        static_cast<float*>(y), channels, n,
        out_len, static_cast<const float*>(rs_taps),
        static_cast<const float*>(ch_taps), c);
  }
  return static_cast<int>(cudaGetLastError());
}
