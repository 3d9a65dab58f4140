// Kernel M: same-mode FIR by 512-point overlap-save straight off a raw
// (C, tx) stream of uint8 or f32 samples, to f32 or uint8 (round half up,
// saturate): out[q] = same_mode_fir(x, h)[q + off] for q < out_len, zero
// pad outside the stream, for 1 <= L <= 257 and the d-gate.
//
// Replaces warmup_fir_filter_tpu/kernels/fft_pallas.py::
// _osfilt_stream_kernel (:622), launched by _osfilt_stream (:745) behind
// fir_overlap_save_stream (:767); gate stream_kernel_supported (:600),
// geometry _stream_geometry (:582).  As there, no framing, padding or
// slicing pass touches device memory: a CTA reads the windows it needs off
// the stream, zero outside [0, tx), and writes only the valid outputs.  The
// window placement is the TPU kernel's (wft_fft.cuh, StreamPlan): hop 2 or
// 3 lane tiles, the alignment shift d folded into the spectrum, so the
// same (L, off) pairs run and the plain version matches the TPU kernel
// window for window.  A larger hop (512 - L + 1 valid outputs a window) is
// left for a later change.
//
// A CTA of 512 threads takes 16 consecutive windows of one channel, two to
// a complex FFT (real and imaginary parts), runs DIF forward, the product
// with the shifted spectrum in bit-reversed order, DIT inverse, and stores
// the last `hop` points of each window.  Consecutive windows overlap by
// 512 - hop samples, so the re-reads hit the L1 and L2 caches.
//
// What bounds it on an H100, config 4 (16 x 10,000,000 f32 in and out,
// 63 taps, hop 2): 1.28 GB read and written (0.38 ms at 3.35 TB/s), the
// roof.  The operations count 5 n log2 n per complex transform and 6 n for
// its product with the spectrum; two real windows share one complex
// forward, product and inverse, so a window is 5 n log2 n + 3 n and the
// 625,008 windows 15.4 G operations (0.23 ms at 67 TFLOP/s; with u8 in and
// out, 0.32 GB, that is the roof).  The kernel is bound by shared-memory
// traffic, a pass per two stages.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fft.cuh"

namespace {

constexpr int kMaxGridY = 65535;
constexpr int kDefaultSharedBytes = 48 * 1024;

template <typename T, typename U, int HOP>
__global__ void __launch_bounds__(wft::kFftThreads)
osfilt_stream_kernel(const T* __restrict__ x, U* __restrict__ y,
                     long long channels, long long tx, long long out_len,
                     int base, const wft::Cf* __restrict__ tw,
                     const wft::Cf* __restrict__ spec) {
  extern __shared__ wft::Cf smem[];
  constexpr int kLog = wft::kStreamLog2;
  const int count = wft::fft_per_cta(kLog);
  wft::Cf* buf = smem;
  wft::Cf* tw_s = buf + count * wft::fft_slots(wft::kStreamN);
  const int t = threadIdx.x;
  const long long w0 = 2LL * blockIdx.x * count;
  const wft::StreamPlan p{tx, out_len, HOP, base};
  wft::fft_stage_twiddles(tw, tw_s, kLog, t, wft::kFftThreads);
  for (long long ch = blockIdx.y; ch < channels; ch += gridDim.y) {
    __syncthreads();  // the twiddles are staged, the last channel stored
    wft::stream_load_thread(x + ch * tx, p, w0, buf, count, t,
                            wft::kFftThreads);
    for (int ph = 0; ph < wft::fft_filter_phases(kLog); ++ph) {
      __syncthreads();
      wft::fft_filter_phase(buf, kLog, ph, tw_s, spec, count, t,
                            wft::kFftThreads);
    }
    __syncthreads();
    wft::stream_store_thread(buf, p, w0, y + ch * out_len, count, t,
                             wft::kFftThreads);
  }
}

template <typename T, typename U, int HOP>
int launch(const void* x, void* y, long long channels, long long tx,
           long long out_len, int base, const void* tw, const void* spec,
           cudaStream_t stream) {
  const int count = wft::fft_per_cta(wft::kStreamLog2);
  const long long windows = (out_len + HOP - 1) / HOP;
  const long long ctas = (windows + 2LL * count - 1) / (2LL * count);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int shared_bytes = wft::fft_shared_bytes(wft::kStreamLog2);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        osfilt_stream_kernel<T, U, HOP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>(channels < kMaxGridY ? channels
                                                             : kMaxGridY));
  osfilt_stream_kernel<T, U, HOP><<<grid, wft::kFftThreads, shared_bytes,
                                    stream>>>(
      static_cast<const T*>(x), static_cast<U*>(y), channels, tx, out_len,
      base, static_cast<const wft::Cf*>(tw),
      static_cast<const wft::Cf*>(spec));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U>
int launch_hop(const void* x, void* y, long long channels, long long tx,
               long long out_len, int hop, int base, const void* tw,
               const void* spec, cudaStream_t stream) {
  if (hop == 256) {
    return launch<T, U, 256>(x, y, channels, tx, out_len, base, tw, spec,
                             stream);
  }
  return launch<T, U, 384>(x, y, channels, tx, out_len, base, tw, spec,
                           stream);
}

}  // namespace

// x (channels, tx) uint8 when x_is_u8 else f32; y (channels, out_len) uint8
// when out_u8 else f32; twiddles (256) and spectrum (512) complex f32:
// device pointers.  hop is 256 or 384 samples; base = 128 (m_shift - c0).
extern "C" int wft_osfilt_stream(const void* x, void* y, long long channels,
                                 long long tx, long long out_len, int hop,
                                 int base, const void* twiddles,
                                 const void* spectrum, int x_is_u8,
                                 int out_u8, void* stream) {
  if (channels < 1 || tx < 1 || out_len < 1 || (hop != 256 && hop != 384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_u8) {
    return out_u8 ? launch_hop<uint8_t, uint8_t>(x, y, channels, tx, out_len,
                                                 hop, base, twiddles,
                                                 spectrum, s)
                  : launch_hop<uint8_t, float>(x, y, channels, tx, out_len,
                                               hop, base, twiddles, spectrum,
                                               s);
  }
  return out_u8 ? launch_hop<float, uint8_t>(x, y, channels, tx, out_len, hop,
                                             base, twiddles, spectrum, s)
                : launch_hop<float, float>(x, y, channels, tx, out_len, hop,
                                           base, twiddles, spectrum, s);
}
