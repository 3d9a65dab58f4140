// Kernel J: the DSP chain in one pass -- polyphase P/Q resample, same-mode
// channelizer FIR, FM discriminator -- over (C, T) I and Q rows into
// (C, ceil(T P/Q)) f32 messages.  The TPU kernel takes the planes stacked as
// (2C, T) rows; here they are two pointers, which spares the stacking copy.
//
// Replaces warmup_fir_filter_tpu/kernels/chain_fused.py::_chain_fused_kernel
// (:133; entry chain_forward_fused :416, gate chain_fused_supported :394).
// As there, the resampled and channelized intermediates never reach device
// memory: the input is read once and the messages written once.  A CTA
// computes tile = 2,304 - Lc messages of one channel (2,241 at 63 taps), in
// four stages separated by barriers (wft_chain.cuh):
//   0  stage the I and Q input windows and the taps in shared memory,
//   1  resample the tile + Lc = 2,304 samples the channelizer reads, both
//      planes, and zero those outside [lo, hi): the staged path zero-pads the
//      resampled stream, and the values computed just outside [0, out_len)
//      from the zero-padded input are not zero (chain_fused.py:246-265);
//      the time-sharded chain passes its global window as [lo, hi),
//   2  channelize tile + 1 samples a plane: one to the left of the tile,
//      since each message needs the previous channelized sample (:281-307),
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
// about equally.  The first form gave each thread four outputs 256 apart:
// 1.25 shared loads an FMA, 2.25 wavefronts an FMA in stage 1 (its window
// loads 2-way conflicted), so shared-memory issue bounded it at about 8x
// its bound (0.96 ms), and it recomputed Lc / 1,024 of the resampled
// samples at the tile seams.
//
// The design: both band stages run on the tiled cores (wft_chain.cuh,
// group_dot).  A thread computes a group of 9 outputs of one tap row: in
// stage 1 outputs P apart of one branch, whose anchors step by Q, from a
// register window of Q * 8 + 1 input samples; in stage 2 nine consecutive
// channelized samples from a window of 9.  Each window slides down one
// sample a tap, so a tap is one window load and a quarter of a float4 tap
// load for 9 FMAs (about one LDS to five FFMA in the SASS at Q = 3, no
// spills); lanes'
// windows start 9 or 9 Q samples apart (odd at Q = 3), so their loads fall
// in distinct banks.  Index arithmetic is 32-bit shifts from each CTA's
// run (P is a power of two).  A tile is 2,304 resampled samples a plane,
// so Lc / tile of them are recomputed (2.8% at 63 taps).  As many CTAs as
// the card holds at once each walk work items (channel, tile), staging the
// next item's I/Q windows by cp.async (raw bf16 in "bf16" mode, widened
// once it lands) while they compute the current one; the channelized runs
// reuse the consumed windows and the messages the resampled runs, 75 KB a
// CTA at config 5.
//
// Q up to 5 has a compiled stage-1 core.  A shape with a larger Q (1/8),
// or whose tiled layout would not fit 227 KB (a branch of about 7,000 taps
// or more at 2/1), takes the compact route (wft_chain.cuh): the kernel's
// first form, 1,024 messages a CTA,
// four a thread 256 apart through poly_dot4 in stages 1 and 2, over windows
// staged once per channel.  It needs the least shared memory of any route,
// so every shape the first form took still launches.
//
// Where the time goes now (ablations on an H100 80GB HBM3 at 700 W,
// recorded in PERF.md): of 0.37 ms at config 5, stage 1 about 0.11 (its 9-output groups spend half their
// instructions around the FMAs of a 32-tap branch), stage 2 about 0.14,
// the discriminator about 0.07 (atan2f 0.02 of it), the staging and the
// barriers the rest: a card's issue slots, not its memory, bound it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_chain.cuh"
#include "wft_resident.cuh"

namespace {

constexpr int kMaxGridY = 65535;

// The tiled route: CTA b of gridDim.x walks the items (channel, tile) b,
// b + gridDim.x, ..., staging the next item's windows while it computes
// this one's.
template <typename T, int Q>
__global__ void __launch_bounds__(wft::kChainThreads)
chain_fused_kernel(const T* __restrict__ x_re, const T* __restrict__ x_im,
                   float* __restrict__ y,
                   long long channels, long long n, long long out_len,
                   const float* __restrict__ rs_taps,
                   const float* __restrict__ ch_taps, wft::ChainPlan c,
                   wft::ChainLayout l) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem + l.rs_at;  // [2][rs_plane]
  const int t = threadIdx.x;
  const long long tiles = (out_len + c.tile - 1) / c.tile;
  wft::stage_taps(rs_taps, c.rs.up, c.rs.tap_stride, c.rs.len, l.rs_taps,
                  smem, t, wft::kChainThreads);
  wft::stage_taps(ch_taps, 1, c.ch_taps, c.ch_taps, l.ch_taps,
                  smem + l.ch_taps_at, t, wft::kChainThreads);
  wft::TileWalk item = wft::walk_start(blockIdx.x, tiles);
  wft::chain_prefetch(x_re, x_im, n, c, l, item, 0, smem, t,
                      wft::kChainThreads);
  wft::async_commit();
  for (int k = 0; item.row < channels; ++k) {
    wft::async_wait<0>();
    __syncthreads();  // item k is staged; item k - 1 is done with its planes
    const wft::TileWalk next = wft::walk_next(item, gridDim.x, tiles);
    if (next.row < channels) {
      wft::chain_prefetch(x_re, x_im, n, c, l, next, k + 1, smem, t,
                          wft::kChainThreads);
    }
    wft::async_commit();
    if (c.bf16) {
      wft::chain_widen(smem, l, c, k, t, wft::kChainThreads);
      __syncthreads();
    }
    float* windows = wft::chain_windows(smem, l, c, k);
    const long long m0 = item.tile * c.tile;
    const wft::PolyRun r = wft::chain_run(m0, c);
    wft::chain_resample_thread<Q>(smem, windows, l, c, r, wft::run_x0(r, c.rs),
                                  t, wft::kChainThreads, rs, m0);
    __syncthreads();
    wft::chain_channelize_thread(smem, rs, l, c, t, wft::kChainThreads,
                                 windows);
    __syncthreads();
    wft::chain_demod_thread(windows, windows + l.plane, c, t,
                            wft::kChainThreads, rs, m0);
    __syncthreads();
    wft::store_run(rs, y + item.row * out_len + m0,
                   static_cast<int>(out_len - m0 < c.tile ? out_len - m0
                                                          : c.tile),
                   t, wft::kChainThreads);
    item = next;
  }
}

// The compact route: CTA (tile, channel) for channels blockIdx.y +
// k gridDim.y.
template <typename T>
__global__ void __launch_bounds__(wft::kChainThreads)
chain_compact_kernel(const T* __restrict__ x_re, const T* __restrict__ x_im,
                     float* __restrict__ y,
                     long long channels, long long n, long long out_len,
                     const float* __restrict__ rs_taps,
                     const float* __restrict__ ch_taps, wft::ChainPlan c) {
  extern __shared__ float smem[];
  const int rs_tap_floats = c.rs.up * c.rs.tap_stride;
  const int in_w = static_cast<int>(wft::chain_compact_window(c));
  float* rs_taps_s = smem;
  float* ch_taps_s = rs_taps_s + rs_tap_floats;
  float* xs = ch_taps_s + c.ch_taps;  // [2][in_w]
  float* rs = xs + 2 * in_w;          // [2][rs_count]
  float* ch = rs + 2 * c.rs_count;    // [2][kChainTile + 1]
  const int t = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * wft::kChainTile;
  for (int k = t; k < rs_tap_floats; k += wft::kChainThreads) {
    rs_taps_s[k] = rs_taps[k];
  }
  for (int k = t; k < c.ch_taps; k += wft::kChainThreads) {
    ch_taps_s[k] = ch_taps[k];
  }
  const long long in0 = wft::chain_compact_base(m0, c);
  for (long long row = blockIdx.y; row < channels; row += gridDim.y) {
    __syncthreads();  // the previous channel's windows are consumed
    for (int plane = 0; plane < 2; ++plane) {
      wft::stage_window((plane ? x_im : x_re) + row * n, n, in0,
                        xs + plane * in_w, in_w, t, wft::kChainThreads);
    }
    __syncthreads();
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_compact_resample(xs + plane * in_w, rs_taps_s, c, t,
                                  rs + plane * c.rs_count, m0);
    }
    __syncthreads();
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_compact_channelize(rs + plane * c.rs_count, ch_taps_s, c, t,
                                    ch + plane * (wft::kChainTile + 1));
    }
    __syncthreads();
    wft::chain_compact_demod(ch, ch + wft::kChainTile + 1, c, t,
                             y + row * out_len, out_len, m0);
  }
}

template <typename T, int Q>
int launch(const void* x_re, const void* x_im, void* y, long long channels,
           long long n, long long out_len, const void* rs_taps,
           const void* ch_taps, const wft::ChainPlan& c, size_t shared_bytes,
           cudaStream_t stream) {
  static wft::ResidentCache cache;
  long long resident = 0;
  const T* re = static_cast<const T*>(x_re);
  const T* im = static_cast<const T*>(x_im);
  float* yf = static_cast<float*>(y);
  const float* rs_t = static_cast<const float*>(rs_taps);
  const float* ch_t = static_cast<const float*>(ch_taps);
  if constexpr (Q > 0) {
    const cudaError_t err =
        wft::resident_ctas(chain_fused_kernel<T, Q>, wft::kChainThreads,
                           shared_bytes, cache, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = channels * ((out_len + c.tile - 1) / c.tile);
    const long long ctas = items < resident ? items : resident;
    chain_fused_kernel<T, Q><<<static_cast<unsigned>(ctas > 0 ? ctas : 1),
                               wft::kChainThreads, shared_bytes, stream>>>(
        re, im, yf, channels, n, out_len, rs_t, ch_t, c,
        wft::chain_layout(c));
  } else {
    const long long tiles = (out_len + wft::kChainTile - 1) / wft::kChainTile;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        wft::resident_ctas(chain_compact_kernel<T>, wft::kChainThreads,
                           shared_bytes, cache, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(channels < kMaxGridY ? channels
                                                               : kMaxGridY));
    chain_compact_kernel<T><<<grid, wft::kChainThreads, shared_bytes,
                              stream>>>(re, im, yf, channels, n, out_len,
                                        rs_t, ch_t, c);
  }
  return static_cast<int>(cudaGetLastError());
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
  const wft::Route route = wft::chain_route(c);
  if (route.core < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes = static_cast<size_t>(route.shared_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wft::with_core(route.core, [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return c.bf16 ? launch<uint16_t, Q>(x_re, x_im, y, channels, n, out_len,
                                        rs_taps, ch_taps, c, shared_bytes, s)
                  : launch<float, Q>(x_re, x_im, y, channels, n, out_len,
                                     rs_taps, ch_taps, c, shared_bytes, s);
  });
}
