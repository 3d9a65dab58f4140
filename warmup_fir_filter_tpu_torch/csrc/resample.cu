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
// What bounds it on an H100: the chain's 2/3 x 63-tap stage over 32 x 2 M
// samples reads 256 MB and writes 171 MB for 1.4 G FMAs: memory is the
// roof (0.13 ms at 3.35 TB/s, against 0.04 ms of f32 issue).  The first
// form gave each thread four outputs 256 apart and paid 1.25 shared loads
// an FMA, with 2-way bank conflicts on its window loads: shared-memory
// issue, not memory, bounded it (0.49 ms).
//
// The design: a work item is 2,304 consecutive outputs of one row.  A CTA
// of 256 threads stages the branch taps once in the tiled cores' layout,
// then walks its items (as many CTAs as the card holds at once), staging
// the next item's input window (about 2,304 Q / P + J samples, zeros
// outside the row) by cp.async while it computes the current one.  Each
// thread computes one group, 9 outputs of one branch P apart, whose
// anchors step by Q: a register window of Q * 8 + 1 samples slides down one
// sample a tap, so a tap costs one window load and a quarter of a float4
// tap load for 9 FMAs (wft_chain.cuh, group_dot), with 32-bit shifts for
// the anchors (P is a power of two).  The group's outputs are P apart, so
// they go through a tile in shared memory and leave as 16-byte stores
// where the output row is aligned.  On an H100 80GB HBM3 at 700 W it takes
// 0.18 ms at config 5, 1.4x the memory roof (PERF.md).
//
// Q up to 5 has a compiled core.  A shape with a larger Q (1/8), or whose
// tiled layout would not fit 227 KB (a branch of about 11,500 taps or more
// at 2/1), takes the compact route
// (wft_chain.cuh): the kernel's first form, 1,024 outputs a CTA, four a
// thread 256 apart through poly_dot4, from one window staged per row.  It
// needs the least shared memory of any route, so every shape the first
// form took still launches.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_chain.cuh"
#include "wft_resident.cuh"

namespace {

constexpr int kMaxGridY = 65535;

// The tiled route: CTA b of gridDim.x walks the items b, b + gridDim.x, ...
// of the (rows, tiles) grid, staging the next item's window while it
// computes this one's.
template <int Q>
__global__ void __launch_bounds__(wft::kChainThreads)
resample_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long rows, long long n, long long out_len,
                const float* __restrict__ taps, wft::PolyPlan p,
                wft::ResampleLayout l) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + l.out_at;
  const int t = threadIdx.x;
  const long long tiles =
      (out_len + wft::kResampleTile - 1) / wft::kResampleTile;
  wft::stage_taps(taps, p.up, p.tap_stride, p.len, l.taps, smem, t,
                  wft::kChainThreads);
  wft::TileWalk item = wft::walk_start(blockIdx.x, tiles);
  wft::resample_prefetch(x, n, p, item, smem + l.stage_at, l.stage, t,
                         wft::kChainThreads);
  wft::async_commit();
  for (int k = 0; item.row < rows; ++k) {
    const wft::TileWalk next = wft::walk_next(item, gridDim.x, tiles);
    if (next.row < rows) {
      wft::resample_prefetch(x, n, p, next,
                             smem + l.stage_at + ((k + 1) & 1) * l.stage,
                             l.stage, t, wft::kChainThreads);
    }
    wft::async_commit();
    wft::async_wait<1>();
    __syncthreads();  // this item's window is staged, the last one's stored
    const long long m0 = item.tile * wft::kResampleTile;
    const wft::PolyRun r = wft::poly_run(m0, p);
    float acc[wft::kTileR];
    wft::resample_thread<Q>(smem + l.stage_at + (k & 1) * l.stage,
                            wft::run_x0(r, p), smem, l, p, r, t, acc);
    wft::resample_put(acc, p, r, t, ys);
    __syncthreads();
    wft::store_run(ys, y + item.row * out_len + m0,
                   static_cast<int>(out_len - m0 < wft::kResampleTile
                                        ? out_len - m0
                                        : wft::kResampleTile),
                   t, wft::kChainThreads);
    item = next;
  }
}

// The compact route: CTA (tile, row) for rows blockIdx.y + k gridDim.y.
__global__ void __launch_bounds__(wft::kChainThreads)
resample_compact_kernel(const float* __restrict__ x, float* __restrict__ y,
                        long long rows, long long n, long long out_len,
                        const float* __restrict__ taps, wft::PolyPlan p) {
  extern __shared__ float smem[];
  const int tap_floats = p.up * p.tap_stride;
  float* w = smem + tap_floats;
  const int t = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * wft::kChainTile;
  const int width = static_cast<int>(wft::resample_compact_window(p));
  for (int k = t; k < tap_floats; k += wft::kChainThreads) smem[k] = taps[k];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    __syncthreads();  // the previous row's window is consumed
    wft::stage_window(x + row * n, n, wft::resample_compact_base(m0, p), w,
                      width, t, wft::kChainThreads);
    __syncthreads();
    wft::resample_compact_thread(w, smem, p, t, y + row * out_len, out_len,
                                 m0);
  }
}

template <int Q>
int launch(const float* x, float* y, long long rows, long long n,
           long long out_len, const float* taps, const wft::PolyPlan& p,
           size_t shared_bytes, cudaStream_t stream) {
  static wft::ResidentCache cache;
  long long resident = 0;
  if constexpr (Q > 0) {
    const cudaError_t err = wft::resident_ctas(
        resample_kernel<Q>, wft::kChainThreads, shared_bytes, cache,
        &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items =
        rows * ((out_len + wft::kResampleTile - 1) / wft::kResampleTile);
    const long long ctas = items < resident ? items : resident;
    resample_kernel<Q><<<static_cast<unsigned>(ctas > 0 ? ctas : 1),
                         wft::kChainThreads, shared_bytes, stream>>>(
        x, y, rows, n, out_len, taps, p, wft::resample_layout(p));
  } else {
    const long long tiles = (out_len + wft::kChainTile - 1) / wft::kChainTile;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = wft::resident_ctas(
        resample_compact_kernel, wft::kChainThreads, shared_bytes, cache,
        &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
    resample_compact_kernel<<<grid, wft::kChainThreads, shared_bytes,
                              stream>>>(x, y, rows, n, out_len, taps, p);
  }
  return static_cast<int>(cudaGetLastError());
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
  const wft::Route route = wft::resample_route(p);
  if (route.core < 0) return static_cast<int>(cudaErrorInvalidValue);
  return wft::with_core(route.core, [&](auto q) {
    return launch<decltype(q)::value>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, n,
        out_len, static_cast<const float*>(taps), p,
        static_cast<size_t>(route.shared_bytes),
        static_cast<cudaStream_t>(stream));
  });
}
