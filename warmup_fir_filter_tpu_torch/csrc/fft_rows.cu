// Kernel K: the batched row FFT and scaled inverse FFT over (rows, n) f32
// re/im planes, natural order in and out, n = 2^log_n, 2 <= n <= 16,384.
//
// Replaces warmup_fir_filter_tpu/kernels/fft_pallas.py::_fft_kernel (:406),
// _fft_kernel_real (:418) and _ifft_kernel (:424), launched by
// _fft_m_layout (:881) behind fft_rows_pallas (:895).  The TPU kernels run
// the 4-step N1 x 128 DFT as matmuls on m-layout planes, with the host
// (un)scrambling the spectrum; here a CTA transforms whole rows with the
// Stockham passes of wft_fft_rows.cuh: each thread holds 16 points of a row
// in registers and runs a whole radix-16 (or the last pass's radix-2/4/8)
// DFT there, so 2,048 points take three passes and 16,384 four, with one
// exchange through shared memory between two passes and natural order at
// both ends.  A null imaginary plane replaces _fft_kernel_real, and the
// inverse instance (conjugated twiddles, 1/n on the store) replaces
// _ifft_kernel.  One template instance per size and direction keeps every
// index and radix a constant.
//
// What bounds it on an H100: 8,192 rows of 2,048 points read and write
// 268 MB (0.08 ms at 3.35 TB/s) for 5 n log2 n a row, 0.92 G operations
// (0.014 ms at 67 TFLOP/s): memory is the roof.  At n >= 1,024 a CTA
// takes one row with n / 16 threads, below that max(1, 128 / (n / 16))
// rows, so an SM holds several CTAs; a 16,384-point row is 1,024 threads
// whose registers hold the whole row, one CTA an SM.

#include <climits>

#include <cuda_runtime.h>

#include "wft_fft_rows.cuh"

namespace {

constexpr int kDefaultSharedBytes = 48 * 1024;

// Pass I and the ones after it, with the exchanges between them.
template <int LOG_N, bool INV, int I>
__device__ __forceinline__ void run_passes(wft::Cf* v, const wft::Cf* tw,
                                           float* sre, float* sim, int t) {
  if constexpr (I > 0) wft::rows_read<LOG_N>(v, sre, sim, t);
  wft::rows_pass<LOG_N, I, INV>(v, tw, t);
  if constexpr (I + 1 < wft::RowsPlan<LOG_N>::passes) {
    if constexpr (I > 0) __syncthreads();  // every read of pass I is done
    wft::rows_write<LOG_N, I>(v, sre, sim, t);
    __syncthreads();
    run_passes<LOG_N, INV, I + 1>(v, tw, sre, sim, t);
  }
}

template <int LOG_N, bool INV>
__global__ void __launch_bounds__(wft::RowsPlan<LOG_N>::threads)
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                long long rows, const wft::Cf* __restrict__ tw) {
  using Plan = wft::RowsPlan<LOG_N>;
  extern __shared__ float smem[];
  const int t = static_cast<int>(threadIdx.x) % Plan::T;
  const int r = static_cast<int>(threadIdx.x) / Plan::T;
  const long long row = static_cast<long long>(blockIdx.x) * Plan::rows + r;
  float* sre = smem + r * Plan::stride;
  float* sim = smem + (Plan::rows + r) * Plan::stride;
  wft::Cf v[Plan::P];
  wft::rows_load<LOG_N>(xr, xi, rows, row, t, v);
  run_passes<LOG_N, INV, 0>(v, tw, sre, sim, t);
  wft::rows_store<LOG_N>(v, rows, row, t,
                         INV ? 1.0f / static_cast<float>(Plan::n) : 1.0f, yr,
                         yi);
}

template <int LOG_N, bool INV>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           long long rows, const wft::Cf* tw, cudaStream_t stream) {
  using Plan = wft::RowsPlan<LOG_N>;
  const long long ctas = (rows + Plan::rows - 1) / Plan::rows;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int shared = static_cast<int>(Plan::shared_bytes);
  if (shared > kDefaultSharedBytes) {
    static const cudaError_t set = cudaFuncSetAttribute(
        fft_rows_kernel<LOG_N, INV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  fft_rows_kernel<LOG_N, INV><<<static_cast<unsigned>(ctas), Plan::threads,
                                shared, stream>>>(xr, xi, yr, yi, rows, tw);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG_N>
int launch_size(int log_n, bool inverse, const float* xr, const float* xi,
                float* yr, float* yi, long long rows, const wft::Cf* tw,
                cudaStream_t stream) {
  if (log_n != LOG_N) {
    if constexpr (LOG_N < wft::kFftMaxLog2) {
      return launch_size<LOG_N + 1>(log_n, inverse, xr, xi, yr, yi, rows, tw,
                                    stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return inverse ? launch<LOG_N, true>(xr, xi, yr, yi, rows, tw, stream)
                 : launch<LOG_N, false>(xr, xi, yr, yi, rows, tw, stream);
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
  return launch_size<1>(
      log_n, inverse != 0, static_cast<const float*>(xr),
      static_cast<const float*>(xi), static_cast<float*>(yr),
      static_cast<float*>(yi), rows, static_cast<const wft::Cf*>(twiddles),
      static_cast<cudaStream_t>(stream));
}
