// Kernel L: the fused overlap-save filter over framed (batch, n) segments
// of uint8 or f32 samples, to f32 or to uint8 (round half up, saturate),
// n = 2^log_n, 2 <= n <= 16,384.
//
// Replaces warmup_fir_filter_tpu/kernels/fft_pallas.py::_osfilt_kernel
// (:519; N1 = 1 or N1 > 8) and _osfilt_kernel_v2 (:436; 1 < N1 <= 8),
// launched by _osfilt_natural (:969, :989) behind fir_overlap_save_pallas
// (:1041) and fir_overlap_save_quantized_pallas (:1094) when nfft is
// pinned or the filter is longer than 257 taps.  Both TPU bodies compute
// one function: real FFT, times the filter spectrum, inverse FFT, real
// part.  v2's fold of the twiddles and the spectrum into per-k1 matmul
// tables is a device of the TPU's matrix unit and is not carried.  The
// host frames the segments and discards the first L - 1 outputs of each,
// as there.
//
// A CTA of 512 threads takes 2 max(1, 4,096 / n) segments, two to a complex
// FFT (real and imaginary parts: the filter is real, so one transform
// filters both): DIF forward, the product with the spectrum in the DIF's
// bit-reversed order (1/n folded in), DIT inverse with conjugated
// twiddles, so no pass permutes the points (wft_fft.cuh).
//
// What bounds it on an H100: at config 4 with nfft = 2,048 pinned, 80,576
// segments of 2,048 f32 read and written are 1.32 GB (0.39 ms at
// 3.35 TB/s), the roof.  Counting 5 n log2 n per complex transform and
// 6 n for its product with the spectrum, with two real segments to one
// complex forward, product and inverse, a segment is 5 n log2 n + 3 n and
// the 80,576 segments 9.6 G operations (0.14 ms at 67 TFLOP/s).  The
// kernel is bound by shared-memory traffic, a pass per two stages.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fft.cuh"

namespace {

constexpr int kDefaultSharedBytes = 48 * 1024;

template <typename T, typename U>
__global__ void __launch_bounds__(wft::kFftThreads)
osfilt_kernel(const T* __restrict__ seg, U* __restrict__ y, long long batch,
              int log_n, const wft::Cf* __restrict__ tw,
              const wft::Cf* __restrict__ spec) {
  extern __shared__ wft::Cf smem[];
  const int count = wft::fft_per_cta(log_n);
  wft::Cf* buf = smem;
  wft::Cf* tw_s = buf + count * wft::fft_slots(1 << log_n);
  const int t = threadIdx.x;
  const long long s0 = 2LL * blockIdx.x * count;
  wft::fft_stage_twiddles(tw, tw_s, log_n, t, wft::kFftThreads);
  wft::osfilt_load_thread(seg, batch, log_n, s0, buf, count, t,
                          wft::kFftThreads);
  for (int ph = 0; ph < wft::fft_filter_phases(log_n); ++ph) {
    __syncthreads();
    wft::fft_filter_phase(buf, log_n, ph, tw_s, spec, count, t,
                          wft::kFftThreads);
  }
  __syncthreads();
  wft::osfilt_store_thread(buf, batch, log_n, s0, y, count, t,
                           wft::kFftThreads);
}

template <typename T, typename U>
int launch(const void* seg, void* y, long long batch, int log_n,
           const void* tw, const void* spec, cudaStream_t stream) {
  const int count = wft::fft_per_cta(log_n);
  const long long ctas = (batch + 2LL * count - 1) / (2LL * count);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int shared_bytes = wft::fft_shared_bytes(log_n);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        osfilt_kernel<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  osfilt_kernel<T, U><<<static_cast<unsigned>(ctas), wft::kFftThreads,
                        shared_bytes, stream>>>(
      static_cast<const T*>(seg), static_cast<U*>(y), batch, log_n,
      static_cast<const wft::Cf*>(tw), static_cast<const wft::Cf*>(spec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seg (batch, 2^log_n) uint8 when seg_is_u8 else f32; y the same shape,
// uint8 when out_u8 else f32; twiddles (2^log_n / 2) and spectrum (2^log_n)
// complex f32: device pointers.
extern "C" int wft_osfilt(const void* seg, void* y, long long batch,
                          int log_n, const void* twiddles,
                          const void* spectrum, int seg_is_u8, int out_u8,
                          void* stream) {
  if (batch < 1 || log_n < 1 || log_n > wft::kFftMaxLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg_is_u8) {
    return out_u8 ? launch<uint8_t, uint8_t>(seg, y, batch, log_n, twiddles,
                                             spectrum, s)
                  : launch<uint8_t, float>(seg, y, batch, log_n, twiddles,
                                           spectrum, s);
  }
  return out_u8 ? launch<float, uint8_t>(seg, y, batch, log_n, twiddles,
                                         spectrum, s)
                : launch<float, float>(seg, y, batch, log_n, twiddles,
                                       spectrum, s);
}
