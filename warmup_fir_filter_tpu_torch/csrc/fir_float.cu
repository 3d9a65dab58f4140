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
// themselves (wft_chain.cuh), one fmaf a tap in ascending order from 0,
// which is the "highest" contract and meets the stricter of the JAX
// package's bounds (>= 120 dB against the f64 golden).
//
// What bounds it on an H100: the chain's 63 taps over 32 x 1,333,334 rows
// are 2.69 G FMAs against 341.3 MB of device traffic, so 0.080 ms of f32
// issue at the card's 67 TFLOP/s (an FMA two operations) against 0.102 ms
// of memory at 3.35 TB/s: memory is the roof, and the FMAs close behind
// it.  The first form staged one row's window per CTA synchronously and
// gave each thread four outputs 256 apart (poly_dot4): 1.25 shared-memory
// loads an FMA and 4-byte stores held it at 4x its bound.
//
// The design is kernel I's (resample.cu) at P = Q = 1: a work item is
// 2,304 consecutive outputs of one row; CTAs (as many as the card holds
// at once) stage the taps once in the tiled core's layout and walk their
// items, staging the next item's window by cp.async, from a 16-byte
// aligned sample of the row, while the current one multiplies.  Each
// thread computes nine consecutive outputs with group_dot<1>, a register
// window sliding one sample a tap: one shared load and a quarter of a
// float4 tap load for nine FMAs.  u8 rows land as bytes and are widened
// into the window once per item (cp.async cannot convert).  The outputs
// leave through the CTA's tile as 16-byte stores, aligned on both sides
// for any row address.  Every sum is poly_dot's, so the bytes are the
// first form's.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "wft_chain.cuh"
#include "wft_resident.cuh"

namespace {

constexpr int kMaxTaps = 257;  // fir_mxu.py MAX_TAPS, the tri-tile band

// CTA b of gridDim.x walks the items b, b + gridDim.x, ... of the (rows,
// tiles) grid, staging the next item's window while it computes this one's.
template <typename T>
__global__ void __launch_bounds__(wft::kChainThreads)
fir_float_kernel(const T* __restrict__ x, float* __restrict__ y,
                 long long rows, long long n, const float* __restrict__ h,
                 int taps, wft::FirFloatLayout l) {
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  extern __shared__ __align__(16) float smem[];
  float* window = smem + l.window_at;
  float* ys = smem + l.out_at;
  const auto staged = [&](int slot) {
    return kU8 ? reinterpret_cast<T*>(
                     reinterpret_cast<uint8_t*>(smem + l.raw_at) +
                     slot * l.stage)
               : reinterpret_cast<T*>(window + slot * l.stage);
  };
  const int t = threadIdx.x;
  const long long tiles =
      (n + wft::kResampleTile - 1) / wft::kResampleTile;
  wft::stage_taps(h, 1, taps, taps, l.taps, smem, t, wft::kChainThreads);
  wft::TileWalk item = wft::walk_start(blockIdx.x, tiles);
  long long x0 = wft::fir_float_stage(
      x + item.row * n, n, item.tile * wft::kResampleTile, taps, staged(0),
      l.stage, t, wft::kChainThreads);
  wft::async_commit();
  for (int k = 0; item.row < rows; ++k) {
    const wft::TileWalk next = wft::walk_next(item, gridDim.x, tiles);
    long long next_x0 = 0;
    if (next.row < rows) {
      next_x0 = wft::fir_float_stage(
          x + next.row * n, n, next.tile * wft::kResampleTile, taps,
          staged((k + 1) & 1), l.stage, t, wft::kChainThreads);
    }
    wft::async_commit();
    wft::async_wait<1>();
    __syncthreads();  // this item's window is staged, the last one's stored
    const float* w = window + (kU8 ? 0 : (k & 1) * l.stage);
    if constexpr (kU8) {
      wft::widen_u8(reinterpret_cast<const uint8_t*>(staged(k & 1)), window,
                    l.stage, t, wft::kChainThreads);
      __syncthreads();
    }
    const long long o0 = item.tile * wft::kResampleTile;
    float* dst = y + item.row * n + o0;
    wft::fir_float_thread(w, o0, x0, smem, taps, l.taps, t,
                          wft::fir_float_shift(dst), ys);
    __syncthreads();
    wft::fir_float_store(ys, dst,
                         static_cast<int>(n - o0 < wft::kResampleTile
                                              ? n - o0
                                              : wft::kResampleTile),
                         t, wft::kChainThreads);
    item = next;
    x0 = next_x0;
  }
}

template <typename T>
int launch(const T* x, float* y, long long rows, long long n, const float* h,
           int taps, cudaStream_t stream) {
  static wft::ResidentCache cache;
  const wft::FirFloatLayout l =
      wft::fir_float_layout(taps, std::is_same<T, uint8_t>::value);
  const size_t shared_bytes = 4 * static_cast<size_t>(l.total);
  long long resident = 0;
  const cudaError_t err = wft::resident_ctas(
      fir_float_kernel<T>, wft::kChainThreads, shared_bytes, cache,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + wft::kResampleTile - 1) / wft::kResampleTile;
  if (tiles > LLONG_MAX / rows) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = rows * tiles;
  const long long ctas = items < resident ? items : resident;
  fir_float_kernel<T><<<static_cast<unsigned>(ctas > 0 ? ctas : 1),
                        wft::kChainThreads, shared_bytes, stream>>>(
      x, y, rows, n, h, taps, l);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_u8) {
    return launch(static_cast<const uint8_t*>(x), static_cast<float*>(y),
                  rows, n, static_cast<const float*>(h), taps, s);
  }
  return launch(static_cast<const float*>(x), static_cast<float*>(y), rows,
                n, static_cast<const float*>(h), taps, s);
}
