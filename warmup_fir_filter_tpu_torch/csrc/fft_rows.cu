// Kernel K: the batched row FFT and scaled inverse FFT over (rows, n) f32
// re/im planes, natural order in and out, n = 2^log_n, 2 <= n <= 16,384.
//
// Replaces warmup_fir_filter_tpu/kernels/fft_pallas.py::_fft_kernel (:406),
// _fft_kernel_real (:418) and _ifft_kernel (:424), launched by
// _fft_m_layout (:881) behind fft_rows_pallas (:895).  The TPU kernels run
// the 4-step N1 x 128 DFT as matmuls on m-layout planes, with the host
// (un)scrambling the spectrum; here a CTA transforms whole rows in shared
// memory with the radix-2^2 FFT of wft_fft.cuh, natural order in and out.
// A null imaginary plane replaces _fft_kernel_real, and the inverse flag
// (conjugated twiddles, 1/n on the store) replaces _ifft_kernel.
//
// A CTA of 512 threads takes max(1, 4,096 / n) rows: it stages the
// twiddles, loads its rows, runs ceil(log_n / 2) DIF steps with a barrier
// before each, and stores X[k] from point bit_reverse(k).  A 16,384-point
// row takes 132 KB of shared memory plus 64 KB of twiddles: dynamic shared
// memory, above the default 48 KB only after cudaFuncSetAttribute.
//
// What bounds it on an H100: 8,192 rows of 2,048 points read and write
// 268 MB (0.08 ms at 3.35 TB/s) for 5 n log2 n a row, 0.92 G operations
// (0.014 ms at 67 TFLOP/s): memory is the roof.  This simple form makes a pass over
// shared memory per two stages and reads the result out bit-reversed, so it
// is bound by shared-memory traffic above that roof; radix-8 in registers
// (fewer passes) is the next step.

#include <climits>

#include <cuda_runtime.h>

#include "wft_fft.cuh"

namespace {

constexpr int kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(wft::kFftThreads)
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                long long rows, int log_n, const wft::Cf* __restrict__ tw,
                int inverse) {
  extern __shared__ wft::Cf smem[];
  const int count = wft::fft_per_cta(log_n);
  wft::Cf* buf = smem;
  wft::Cf* tw_s = buf + count * wft::fft_slots(1 << log_n);
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * count;
  wft::fft_stage_twiddles(tw, tw_s, log_n, t, wft::kFftThreads);
  wft::fft_rows_load_thread(xr, xi, rows, log_n, r0, buf, count, t,
                            wft::kFftThreads);
  for (int s = 0; s < wft::fft_steps(log_n); ++s) {
    __syncthreads();
    wft::fft_dif_step(buf, log_n, s, tw_s, inverse != 0, count, t,
                      wft::kFftThreads);
  }
  __syncthreads();
  const float scale = inverse ? 1.0f / static_cast<float>(1 << log_n) : 1.0f;
  wft::fft_rows_store_thread(buf, rows, log_n, r0, scale, yr, yi, count, t,
                             wft::kFftThreads);
}

}  // namespace

// xr, xi (rows, 2^log_n) f32, xi null for a real input; yr, yi the same
// shape; twiddles (2^log_n / 2) complex f32: device pointers.
extern "C" int wft_fft_rows(const void* xr, const void* xi, void* yr,
                            void* yi, long long rows, int log_n,
                            const void* twiddles, int inverse, void* stream) {
  if (rows < 1 || log_n < 1 || log_n > wft::kFftMaxLog2 ||
      (inverse && xi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int count = wft::fft_per_cta(log_n);
  const long long ctas = (rows + count - 1) / count;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int shared_bytes = wft::fft_shared_bytes(log_n);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fft_rows_kernel<<<static_cast<unsigned>(ctas), wft::kFftThreads,
                    shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<float*>(yr), static_cast<float*>(yi), rows, log_n,
      static_cast<const wft::Cf*>(twiddles), inverse);
  return static_cast<int>(cudaGetLastError());
}
