// Kernel I: the float32 polyphase P/Q resampler over (C, T) rows.
//
// Replaces warmup_fir_filter_tpu/kernels/resample_mxu.py: the kernels
// _resample_f32_kernel (:96), _resample_f32_wide_kernel (:129) and
// _resample_f32_wide_chunk_kernel (:196) behind resample_poly_mxu (:387).
// There, output tile t (128 outputs, P | 128) is the product of the input
// window starting at t * ds + beta0 - (J - 1), ds = 128 Q / P, with the
// tile-independent band of build_resample_band (:55-93); the three bodies
// are blockings for the TPU's VMEM, and its windowed fallback for long
// branches (J >~ 100, :411-416) a VMEM limit.  Column i of that band holds
// the J taps of branch r_i, so here each output walks its J taps directly
// (wft_chain.cuh): any J, f32 FMAs (the "highest" contract), samples
// outside [0, T) read as zero, output length ceil(T P / Q) with its ragged
// tail.
//
// A CTA computes 1,024 consecutive outputs of one row: it stages the
// (P, J) branch taps and the input window they read (about 1,024 Q / P + J
// samples, zeros outside the row) in shared memory, then each of 256
// threads computes 4 outputs 256 apart, which share one branch (P | 256),
// so each tap is read once for four FMAs.  The tap rows are stored at an
// odd stride, so that threads on different branches read different banks.
//
// What bounds it on an H100: the chain's 2/3 x 63-tap stage over 32 x 2 M
// samples reads 256 MB and writes 171 MB for 1.4 G FMAs: memory is the
// roof (0.13 ms at 3.35 TB/s, against 0.04 ms of f32 issue).  As kernel H,
// this simple form is bound by shared-memory bandwidth above that roof.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_chain.cuh"

namespace {

constexpr int kMaxGridY = 65535;
constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;

__global__ void __launch_bounds__(wft::kChainThreads)
resample_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long rows, long long n, long long out_len,
                const float* __restrict__ taps, wft::PolyPlan p) {
  extern __shared__ float smem[];
  const int tap_floats = p.up * p.tap_stride;
  float* taps_s = smem;
  float* w_s = smem + tap_floats;
  const int t = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * wft::kChainTile;
  const int width = wft::resample_window(p);
  for (int k = t; k < tap_floats; k += wft::kChainThreads) taps_s[k] = taps[k];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    __syncthreads();  // the previous row's window is consumed
    wft::stage_window(x + row * n, n, wft::resample_base(m0, p), w_s, width,
                      t, wft::kChainThreads);
    __syncthreads();
    wft::resample_thread(w_s, taps_s, p, t, y + row * out_len, out_len, m0);
  }
}

}  // namespace

// x (rows, n) f32, y (rows, out_len) f32, taps (up, tap_stride) f32 with
// taps[r][j] = h[r + up * j] for j < len: device pointers.
extern "C" int wft_resample(const void* x, void* y, long long rows,
                            long long n, long long out_len, const void* taps,
                            int up, int down, int center, int len,
                            int tap_stride, void* stream) {
  if (rows < 1 || n < 1 || out_len < 1 || up < 1 || down < 1 ||
      wft::kChainThreads % up != 0 || center < 0 || len < 1 ||
      tap_stride < len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wft::PolyPlan p{up, down, center, len, tap_stride};
  const size_t shared_bytes =
      4 * (static_cast<size_t>(up) * tap_stride +
           static_cast<size_t>(wft::resample_window(p)));
  const long long tiles = (out_len + wft::kChainTile - 1) / wft::kChainTile;
  if (tiles > INT_MAX || shared_bytes > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  resample_kernel<<<grid, wft::kChainThreads, shared_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, n, out_len,
      static_cast<const float*>(taps), p);
  return static_cast<int>(cudaGetLastError());
}
