// Kernel M: same-mode FIR by 512-point overlap-save straight off a raw
// (C, tx) stream of uint8 or f32 samples, to f32 or uint8 (round half up,
// saturate): out[q] = same_mode_fir(x, h)[q + off] for q < out_len, zero
// pad outside the stream, for 1 <= L <= 257.
//
// Replaces warmup_fir_filter_tpu/kernels/fft_pallas.py::
// _osfilt_stream_kernel (:622), launched by _osfilt_stream (:745) behind
// fir_overlap_save_stream (:767); gate stream_kernel_supported (:600).  As
// there, no framing, padding or slicing pass touches device memory: a CTA
// reads the windows it needs off the stream, zero outside [0, tx), and
// writes only the valid outputs.  The TPU kernel places its windows on
// lane tiles of 128 (a hop of 256 or 384, the alignment shift d folded
// into the spectrum, _stream_geometry :582); that alignment means nothing
// on this card, so the windows here advance by all their 512 - L + 1 valid
// outputs (450 at 63 taps against the TPU geometry's 256: 0.57x the
// transforms at config 4) and the spectrum is h's own
// (kernels/fft.py::stream_plan; wft_fft_rows.cuh, kernel M).  The function
// is the same: the plain version keeps the TPU geometry, and the kernel
// matches it to f32 rounding.
//
// The design (wft_fft_rows.cuh, the filter): two consecutive windows of a
// channel to a complex transform (real and imaginary parts), 32 threads a
// transform holding 16 points each in registers, Stockham passes 16 16 2,
// the product with the natural-order spectrum in registers between the
// forward and the inverse: four exchanges through shared memory a
// transform pair.  A CTA of 128 threads takes 8 consecutive windows of one
// channel; loads x[a + t + 32 q] and the masked stores are coalesced
// across a warp, and the 62-sample overlaps of neighbouring windows meet
// in L1.
//
// What bounds it on an H100, config 4 (16 x 10,000,000 f32 in and out,
// 63 taps): 1.28 GB read and written (0.38 ms at 3.35 TB/s), the roof.
// The operations count 5 n log2 n per complex transform and 6 n for its
// product with the spectrum; two real windows share one complex forward,
// product and inverse, so a window is 5 n log2 n + 3 n and the 355,568
// windows at hop 450 8.7 G operations (0.13 ms at 67 TFLOP/s; with u8 in
// and out, 0.32 GB, that is the roof).  The u8 form takes as long as the
// f32 one: the issue rate of the butterflies, exchanges and index
// arithmetic, at 12 warps an SM (139 registers a thread), holds the
// kernel, not its bytes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fft_rows.cuh"

namespace {

using Plan = wft::StreamRows;

__global__ void __launch_bounds__(Plan::threads)
osfilt_stream_kernel(const void* __restrict__ x, void* __restrict__ y,
                     long long tx, long long out_len,
                     long long ctas_per_channel, int hop, int start,
                     const wft::Cf* __restrict__ tw,
                     const wft::Cf* __restrict__ spec, int x_is_u8,
                     int out_u8) {
  extern __shared__ float smem[];
  const int t = static_cast<int>(threadIdx.x) % Plan::T;
  const int r = static_cast<int>(threadIdx.x) / Plan::T;
  const long long cta = blockIdx.x;
  const long long ch = cta / ctas_per_channel;
  const long long w =
      2 * ((cta - ch * ctas_per_channel) * Plan::rows + r);
  float* sre = smem + r * Plan::stride;
  float* sim = smem + (Plan::rows + r) * Plan::stride;
  wft::Cf v[Plan::P];
  wft::stream_load(x, x_is_u8 != 0, ch * tx, tx, w, hop, start, t, v);
  wft::filter_cta<wft::kStreamLog2>(v, tw, spec, sre, sim, t);
  wft::stream_store(v, y, out_u8 != 0, ch * out_len, out_len, w, hop, t);
}

}  // namespace

// x (channels, tx) uint8 when x_is_u8 else f32; y (channels, out_len) uint8
// when out_u8 else f32; twiddles (256) and spectrum (512, natural order,
// 1/512 folded in) complex f32: device pointers.  Window w starts at
// w * hop + start; hop = 512 - L + 1 in [256, 512] and start = off + L / 2
// - (L - 1) (kernels/fft.py::stream_plan).
extern "C" int wft_osfilt_stream(const void* x, void* y, long long channels,
                                 long long tx, long long out_len, int hop,
                                 int start, const void* twiddles,
                                 const void* spectrum, int x_is_u8,
                                 int out_u8, void* stream) {
  if (channels < 1 || tx < 1 || out_len < 1 || hop < 256 ||
      hop > Plan::n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_channel = wft::stream_ctas_per_channel(out_len, hop);
  if (per_channel > INT_MAX / channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  osfilt_stream_kernel<<<static_cast<unsigned>(per_channel * channels),
                         Plan::threads, Plan::shared_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      x, y, tx, out_len, per_channel, hop, start,
      static_cast<const wft::Cf*>(twiddles),
      static_cast<const wft::Cf*>(spectrum), x_is_u8, out_u8);
  return static_cast<int>(cudaGetLastError());
}
