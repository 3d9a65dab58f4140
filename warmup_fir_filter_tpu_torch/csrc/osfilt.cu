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
// The design (wft_fft_rows.cuh, the filter): two segments to a complex
// transform (real and imaginary parts: the filter is real, so one
// transform filters both), each transform on n / 16 threads holding 16
// points each in registers (all n below 16 points), Stockham passes of
// radix 16 there, the product with the natural-order spectrum in registers
// between the forward's last pass and the inverse's first, so a 2,048-point
// filter makes four exchanges through shared memory.  A CTA takes max(1,
// 128 / T) segment pairs; loads and stores are coalesced across a warp.
// One template instance a size (14); the sample types are a branch around
// the load and the store.
//
// What bounds it on an H100: at config 4 with nfft = 2,048 pinned, 80,576
// segments of 2,048 f32 read and written are 1.32 GB (0.39 ms at
// 3.35 TB/s), the roof.  Counting 5 n log2 n per complex transform and
// 6 n for its product with the spectrum, with two real segments to one
// complex forward, product and inverse, a segment is 5 n log2 n + 3 n and
// the 80,576 segments 9.6 G operations (0.14 ms at 67 TFLOP/s).  As for
// kernel M, the issue rate of the passes holds the kernel at about twice
// its bytes' time; at 16,384 points (1,024 threads, 64 registers) it
// spills.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fft_rows.cuh"

namespace {

constexpr int kDefaultSharedBytes = 48 * 1024;

template <int LOG_N>
__global__ void __launch_bounds__(wft::RowsPlan<LOG_N>::threads)
osfilt_kernel(const void* __restrict__ seg, void* __restrict__ y,
              long long batch, const wft::Cf* __restrict__ tw,
              const wft::Cf* __restrict__ spec, int seg_is_u8, int out_u8) {
  using Plan = wft::RowsPlan<LOG_N>;
  extern __shared__ float smem[];
  const int t = static_cast<int>(threadIdx.x) % Plan::T;
  const int r = static_cast<int>(threadIdx.x) / Plan::T;
  const long long s =
      2 * (static_cast<long long>(blockIdx.x) * Plan::rows + r);
  float* sre = smem + r * Plan::stride;
  float* sim = smem + (Plan::rows + r) * Plan::stride;
  wft::Cf v[Plan::P];
  wft::osfilt_load<LOG_N>(seg, seg_is_u8 != 0, batch, s, t, v);
  wft::filter_cta<LOG_N>(v, tw, spec, sre, sim, t);
  wft::osfilt_store<LOG_N>(v, y, out_u8 != 0, batch, s, t);
}

template <int LOG_N>
int launch(const void* seg, void* y, long long batch, const wft::Cf* tw,
           const wft::Cf* spec, int seg_is_u8, int out_u8,
           cudaStream_t stream) {
  using Plan = wft::RowsPlan<LOG_N>;
  const long long ctas = wft::osfilt_ctas(batch, Plan::rows);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int shared = static_cast<int>(Plan::shared_bytes);
  if (shared > kDefaultSharedBytes) {
    static const cudaError_t set = cudaFuncSetAttribute(
        osfilt_kernel<LOG_N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  osfilt_kernel<LOG_N><<<static_cast<unsigned>(ctas), Plan::threads, shared,
                         stream>>>(seg, y, batch, tw, spec, seg_is_u8,
                                   out_u8);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG_N>
int launch_size(int log_n, const void* seg, void* y, long long batch,
                const wft::Cf* tw, const wft::Cf* spec, int seg_is_u8,
                int out_u8, cudaStream_t stream) {
  if (log_n != LOG_N) {
    if constexpr (LOG_N < wft::kFftMaxLog2) {
      return launch_size<LOG_N + 1>(log_n, seg, y, batch, tw, spec, seg_is_u8,
                                    out_u8, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch<LOG_N>(seg, y, batch, tw, spec, seg_is_u8, out_u8, stream);
}

}  // namespace

// seg (batch, 2^log_n) uint8 when seg_is_u8 else f32; y the same shape,
// uint8 when out_u8 else f32; twiddles (2^log_n / 2) and spectrum (2^log_n,
// natural order, 1 / 2^log_n folded in) complex f32: device pointers.
extern "C" int wft_osfilt(const void* seg, void* y, long long batch,
                          int log_n, const void* twiddles,
                          const void* spectrum, int seg_is_u8, int out_u8,
                          void* stream) {
  if (batch < 1 || log_n < 1 || log_n > wft::kFftMaxLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_size<1>(log_n, seg, y, batch,
                        static_cast<const wft::Cf*>(twiddles),
                        static_cast<const wft::Cf*>(spectrum), seg_is_u8,
                        out_u8, static_cast<cudaStream_t>(stream));
}
