// Per-thread cores of kernel H (fir_float.cu), kernel I (resample.cu) and
// kernel J (chain_fused.cu): the float FIR, the polyphase resampler and the
// fused resample -> channelize -> FM-discriminator chain.
//
// Like wft_window.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every CTA and thread of the three kernels in a host
// loop (the stages of a CTA one after another, where the kernels put a
// __syncthreads()) and hold the result against the plain PyTorch versions.
//
// All three are one computation: an output is a dot product of a short tap
// row with a reversed run of a shared-memory window,
//   acc = sum_j taps[j] * w[a - j]      (ascending j, one f32 FMA each),
// the same order as the float64 goldens.  The float FIR is the case P = Q = 1
// of the polyphase resampler.  All three run the tiled cores below (nine
// outputs of one tap row in a sliding register window); kernels I and J,
// where a shape has no tiled core or its tiled layout would not fit in
// shared memory, take the compact route (poly_dot4: four outputs 256 apart
// share each tap load).  Every route gives poly_dot's sums bit for bit.
// The TPU kernels' band matrices
// (fir_float_mxu.py::build_tile_band_planes_f32, resample_mxu.py::
// build_resample_band) hold exactly these taps at A[a - j, i]; the card has
// native f32 FMAs, so the kernels walk the J nonzeros of each band column
// instead of multiplying by the band.
#pragma once

#include <math.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "wft_band_mma.cuh"
#include "wft_fixed.cuh"

namespace wft {

// Kernels H, I and J run kChainThreads threads a CTA.  On the compact route
// a CTA computes kChainTile consecutive outputs of one row, thread t the
// outputs t + kChainThreads * u, u < 4.
constexpr int kChainThreads = 256;
constexpr int kChainPerThread = 4;
constexpr int kChainTile = kChainThreads * kChainPerThread;

// floor(a / b) for b > 0 and any a.
WFT_INLINE long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

WFT_INLINE float bits_to_f32(uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(b);
#else
  float f;
  std::memcpy(&f, &b, sizeof f);
  return f;
#endif
}

WFT_INLINE uint32_t f32_to_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(f);
#else
  uint32_t b;
  std::memcpy(&b, &f, sizeof b);
  return b;
#endif
}

// v rounded to the nearest bfloat16, ties to even (finite v), as float.
WFT_INLINE float round_bf16(float v) {
  uint32_t b = f32_to_bits(v);
  b += 0x7fffu + ((b >> 16) & 1u);
  return bits_to_f32(b & 0xffff0000u);
}

WFT_INLINE float sample_f32(const float* x, long long i) { return x[i]; }
WFT_INLINE float sample_f32(const uint8_t* x, long long i) {
  return static_cast<float>(x[i]);
}
// bfloat16 samples, as their 16 bits.
WFT_INLINE float sample_f32(const uint16_t* x, long long i) {
  return bits_to_f32(static_cast<uint32_t>(x[i]) << 16);
}

// w[i] = row[base + i] as f32 for i < width, zero where base + i lies
// outside [0, n): the contracts' zero pad.  Thread t of `threads` fills
// i = t, t + threads, ...
template <typename T>
WFT_INLINE void stage_window(const T* row, long long n, long long base,
                             float* w, int width, int t, int threads) {
  for (int i = t; i < width; i += threads) {
    const long long m = base + i;
    w[i] = (m >= 0 && m < n) ? sample_f32(row, m) : 0.0f;
  }
}

// sum_j taps[j] * w[a - j], ascending j.
WFT_INLINE float poly_dot(const float* w, int a, const float* taps, int len) {
  float acc = 0.0f;
  for (int j = 0; j < len; ++j) acc = fmaf(taps[j], w[a - j], acc);
  return acc;
}

// poly_dot for the four outputs a + u * stride (u < 4) that share one tap
// row: each tap is read once for four FMAs.  Each sum is bit-identical to
// poly_dot's.
WFT_INLINE void poly_dot4(const float* w, int a, int stride,
                          const float* taps, int len, float acc[4]) {
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) acc[u] = 0.0f;
  for (int j = 0; j < len; ++j) {
    const float h = taps[j];
    WFT_UNROLL
    for (int u = 0; u < kChainPerThread; ++u) {
      acc[u] = fmaf(h, w[a + u * stride - j], acc[u]);
    }
  }
}

// ----------------------------------------------------------- the tiled cores
// Kernels I and J: a thread computes kTileR outputs of one tap row whose
// anchors step by Q,
//   acc[u] = sum_j taps[j] * w[a + Q u - j]      (u < kTileR),
// holding the samples they read in a register window of Q (kTileR - 1) + 1
// floats that slides down one sample a tap.  A tap costs one window load and
// a quarter of a float4 tap load for kTileR FMAs (poly_dot4: 1.25 loads an
// FMA).  The tap loop is unrolled by the window's width, so that every
// register index is a compile-time constant: the sample a + d sits in slot
// d mod width, and tap j's load overwrites the slot of the sample that tap
// j - 1 read last.  Each sum is poly_dot's, FMA for FMA: ascending j, one
// fmaf each, from 0.
//
// kTileR is odd, so lanes whose windows start kTileR or Q kTileR samples
// apart read distinct banks (at worst 2-way where Q is even).  Q up to
// kMaxTiledDown has a compiled core; other shapes take the compact route.
constexpr int kTileR = 9;
constexpr int kMaxTiledDown = 5;

// A loop the compiler keeps rolled: copies, whose unrolled loads would only
// add code.
#if defined(__CUDACC__)
#define WFT_ROLLED _Pragma("unroll 1")
#else
#define WFT_ROLLED
#endif

// Taps a group of the core for Q (the window's width).
WFT_INLINE constexpr int tiled_width(int q) { return q * (kTileR - 1) + 1; }

WFT_INLINE void load4(const float* p, float v[4]) {
#if defined(__CUDA_ARCH__)
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
#else
  std::memcpy(v, p, 16);
#endif
}

WFT_INLINE void store4(float* p, const float v[4]) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  std::memcpy(p, v, 16);
#endif
}

// A shared tap table of tap rows for the core of Q = q: tap j of row r at
// r * row + (j / group) * stride + j % group, zeros elsewhere.  group is
// the core's window width, stride that rounded up to 4 floats, so a
// group's taps load as float4 at constant offsets; rows of different
// branches start in different banks.
struct TapLayout {
  int group;
  int stride;
  int row;
};

WFT_INLINE TapLayout tap_layout(int q, int len) {
  TapLayout l;
  l.group = tiled_width(q);
  l.stride = (l.group + 3) & ~3;
  l.row = (len + l.group - 1) / l.group * l.stride;
  if (l.row % 32 == 0) l.row += 4;
  return l;
}

// dst = the (rows, src_stride) taps src, len a row, in layout l.  Thread t
// of `threads` fills entries t, t + threads, ...
WFT_INLINE void stage_taps(const float* src, int rows, int src_stride,
                           int len, const TapLayout& l, float* dst, int t,
                           int threads) {
  for (int k = t; k < rows * l.row; k += threads) {
    const int r = k / l.row;
    const int g = (k - r * l.row) / l.stride;
    const int e = k - r * l.row - g * l.stride;
    const int j = g * l.group + e;
    dst[k] = (e < l.group && j < len) ? src[r * src_stride + j] : 0.0f;
  }
}

// One group of the tap loop: taps j0 .. j0 + count - 1 (count = the width
// unless kTail), x = w + a - j0.  The tail leaves at the first 4-tap chunk
// past count (count is the same for every lane: a uniform branch), so it
// issues at most three taps it does not use.
template <int Q, bool kTail>
WFT_INLINE void tiled_group(const float* x, const float* taps, int count,
                            float (&win)[tiled_width(Q)],
                            float (&acc)[kTileR]) {
  constexpr int W = tiled_width(Q);
  WFT_UNROLL
  for (int k4 = 0; k4 < W; k4 += 4) {
    if (kTail && k4 >= count) return;
    float h[4];
    load4(taps + k4, h);
    WFT_UNROLL
    for (int e = 0; e < 4; ++e) {
      const int k = k4 + e;
      if (k < W && (!kTail || k < count)) {
        win[(W - k) % W] = x[-k];
        WFT_UNROLL
        for (int u = 0; u < kTileR; ++u) {
          acc[u] = fmaf(h[e], win[(Q * u - k + W) % W], acc[u]);
        }
      }
    }
  }
}

// acc[u] = poly_dot(w, a + Q u, row, len) for u < kTileR, the row in
// layout l; w[a - len + 1 .. a + Q (kTileR - 1)] are read.
template <int Q>
WFT_INLINE void group_dot(const float* w, int a, const float* taps, int len,
                          const TapLayout& l, float (&acc)[kTileR]) {
  constexpr int W = tiled_width(Q);
  float win[W];
  WFT_UNROLL
  for (int d = 1; d < W; ++d) win[d] = w[a + d];
  WFT_UNROLL
  for (int u = 0; u < kTileR; ++u) acc[u] = 0.0f;
  int j0 = 0;
  for (; j0 + W <= len; j0 += W, taps += l.stride) {
    tiled_group<Q, false>(w + a - j0, taps, W, win, acc);
  }
  if (j0 < len) tiled_group<Q, true>(w + a - j0, taps, len - j0, win, acc);
}

// ------------------------------------------------------------ input windows
// A window is staged from a multiple of kStageAlign samples, so that its
// interior loads as 16-byte chunks where the row is 16-byte aligned.
constexpr int kStageAlign = 8;

WFT_INLINE long long stage_start(long long first) {
  return floor_div(first, kStageAlign) * kStageAlign;
}

// Floats staged for a window of `window` samples from any first sample.
WFT_INLINE int stage_floats(int window) {
  return (window + 2 * kStageAlign - 2) / kStageAlign * kStageAlign;
}

// The eight bf16 values of 16 bytes at p (16-byte aligned) as f32.
WFT_INLINE void load16(const uint16_t* p, float v[8]) {
  uint32_t u[4];
#if defined(__CUDA_ARCH__)
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  u[0] = q.x;
  u[1] = q.y;
  u[2] = q.z;
  u[3] = q.w;
#else
  std::memcpy(u, p, 16);
#endif
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = bits_to_f32(u[k] << 16);
    v[2 * k + 1] = bits_to_f32(u[k] & 0xffff0000u);
  }
}

// w[i] = row[start + i] for i < width (a multiple of 16 bytes' samples),
// zero outside [0, n), in the row's own type: 16-byte chunks inside the row
// at 16-byte aligned addresses by cp.async (visible after async_wait and a
// barrier), the others written at once.
template <typename T>
WFT_INLINE void stage_row_async(const T* row, long long n, long long start,
                                T* w, int width, int t, int threads) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const uintptr_t base = reinterpret_cast<uintptr_t>(row);
  for (int c = t; c < width / V; c += threads) {
    const long long g = start + static_cast<long long>(c) * V;
    if (g >= 0 && g + V <= n &&
        (base + static_cast<uintptr_t>(g) * sizeof(T)) % 16 == 0) {
      copy16_async(reinterpret_cast<uint8_t*>(w + c * V),
                   reinterpret_cast<const uint8_t*>(row + g));
    } else {
      WFT_UNROLL
      for (int e = 0; e < V; ++e) {
        w[c * V + e] = (g + e >= 0 && g + e < n) ? row[g + e] : T(0);
      }
    }
  }
}

// w[i] = the bf16 bits raw[i] as f32, i < width (a multiple of 8).
WFT_INLINE void widen_bf16(const uint16_t* raw, float* w, int width, int t,
                           int threads) {
  for (int c = t; c < width / 8; c += threads) {
    float v[8];
    load16(raw + 8 * c, v);
    store4(w + 8 * c, v);
    store4(w + 8 * c + 4, v + 4);
  }
}

// A CTA's work items (row, tile) of a (rows, tiles) grid: items b, b + G,
// b + 2 G, ... in row-major order, for CTA b of G.
struct TileWalk {
  long long row, tile;
};

WFT_INLINE TileWalk walk_start(long long b, long long tiles) {
  return TileWalk{b / tiles, b % tiles};
}

WFT_INLINE TileWalk walk_next(TileWalk w, long long ctas, long long tiles) {
  w.tile += ctas;
  if (w.tile >= tiles) {
    w.row += w.tile / tiles;
    w.tile %= tiles;
  }
  return w;
}

// ---------------------------------------------------------------- kernel I
// The polyphase plan (ops/resample.py::_plan): output m has anchor
// b_m = floor((m Q + c) / P) and branch r_m = m Q + c - P b_m, and is
// sum_j taps[r_m][j] * x[b_m - j].  For any m, output m + P has branch r_m
// and anchor b_m + Q, so a group of outputs m + P u (u < kTileR) is one
// core call on branch r_m's row.
struct PolyPlan {
  int up;          // P
  int down;        // Q
  int center;      // c = L / 2
  int len;         // J, taps per branch
  int tap_stride;  // row stride of the (P, tap_stride) branch-tap table
};

WFT_INLINE long long poly_anchor(long long m, const PolyPlan& p) {
  return floor_div(m * p.down + p.center, p.up);
}

WFT_INLINE int poly_branch(long long m, const PolyPlan& p) {
  return static_cast<int>(m * p.down + p.center - p.up * poly_anchor(m, p));
}

// P divides kChainThreads, so it is a power of two: output first + i of a
// run has anchor a0 + ((i Q + r0) >> log2 P) and branch (i Q + r0) mod P,
// where a0 and r0 are output first's, and i Q + r0 is 32-bit arithmetic.
struct PolyRun {
  long long a0;
  int r0;
  int shift;  // log2 P
};

WFT_INLINE PolyRun poly_run(long long first, const PolyPlan& p) {
  PolyRun r;
  r.shift = 0;
  while ((1 << r.shift) < p.up) ++r.shift;
  const long long v = first * p.down + p.center;
  r.a0 = v >> r.shift;  // floor((first Q + c) / P)
  r.r0 = static_cast<int>(v - (r.a0 << r.shift));
  return r;
}

// Input samples that n_out consecutive outputs read, at most: their first
// and last anchors lie at most ceil((n_out - 1) Q / P) apart.
WFT_INLINE int poly_window(int n_out, const PolyPlan& p) {
  return static_cast<int>((static_cast<long long>(n_out - 1) * p.down +
                           p.up - 1) / p.up) + p.len;
}

// A run of n outputs (n a multiple of P kTileR) is n / kTileR groups;
// group g = beta P + rho is the run's outputs beta P kTileR + rho + P u.
// Lanes (beta, rho) of a warp: windows Q kTileR samples apart.
WFT_INLINE int group_first(int g, int shift) {
  return ((g >> shift) * kTileR << shift) + (g & ((1 << shift) - 1));
}

// Kernel I's work item (row, tile) is the kResampleTile outputs m0 = tile
// kResampleTile .. m0 + kResampleTile - 1 of the row (m0 a multiple of P):
// kChainThreads groups, one a thread.  Shared memory, in floats: the tap
// table, two staged input windows (the next item's is staged while this
// one's is read), the tile of outputs.
constexpr int kResampleTile = kChainThreads * kTileR;

struct ResampleLayout {
  TapLayout taps;
  int stage_at;  // after the P tap rows
  int stage;     // staged window floats, each of the two
  int out_at;
  int total;
};

WFT_INLINE ResampleLayout resample_layout(const PolyPlan& p) {
  ResampleLayout l;
  l.taps = tap_layout(p.down, p.len);
  l.stage_at = p.up * l.taps.row;
  l.stage = stage_floats(poly_window(kResampleTile, p));
  l.out_at = l.stage_at + 2 * l.stage;
  l.total = l.out_at + kResampleTile;
  return l;
}

// The first sample of a staged window for the run r (its first output's
// anchor less J - 1).
WFT_INLINE long long run_x0(const PolyRun& r, const PolyPlan& p) {
  return stage_start(r.a0 - (p.len - 1));
}

// Stage item w's window into w_s (asynchronously where it can).
WFT_INLINE void resample_prefetch(const float* x, long long n,
                                  const PolyPlan& p, const TileWalk& w,
                                  float* w_s, int width, int t, int threads) {
  const PolyRun r = poly_run(w.tile * kResampleTile, p);
  stage_row_async(x + w.row * n, n, run_x0(r, p), w_s, width, t, threads);
}

// Thread t's group of the CTA's run r (x0 = run_x0): acc[u] is output
// group_first(t) + P u of the run.
template <int Q>
WFT_INLINE void resample_thread(const float* xs, long long x0,
                                const float* taps, const ResampleLayout& l,
                                const PolyPlan& p, const PolyRun& r, int t,
                                float (&acc)[kTileR]) {
  const int v = group_first(t, r.shift) * p.down + r.r0;
  group_dot<Q>(xs, static_cast<int>(r.a0 - x0) + (v >> r.shift),
               taps + (v & (p.up - 1)) * l.taps.row, p.len, l.taps, acc);
}

// The outputs of thread t's group into the CTA's tile ys.
WFT_INLINE void resample_put(const float (&acc)[kTileR], const PolyPlan& p,
                             const PolyRun& r, int t, float* ys) {
  const int i0 = group_first(t, r.shift);
  WFT_UNROLL
  for (int u = 0; u < kTileR; ++u) ys[i0 + p.up * u] = acc[u];
}

// dst[i] = ys[i] for i < count: 16-byte stores where dst is aligned.
WFT_INLINE void store_run(const float* ys, float* dst, int count, int t,
                          int threads) {
  int i = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    WFT_ROLLED
    for (int c = t; c < count / 4; c += threads) {
      float v[4];
      load4(ys + 4 * c, v);
      store4(dst + 4 * c, v);
    }
    i = count / 4 * 4;
  }
  WFT_ROLLED
  for (i += t; i < count; i += threads) dst[i] = ys[i];
}

// ---------------------------------------------------------------- kernel H
// Kernel H is kernel I's arithmetic at P = Q = 1 with the same-mode anchor:
// output o of a row is poly_dot over the zero-extended row at o + L / 2,
//   y[o] = sum_k h[k] * x[o + L / 2 - k]      (ascending k, one fmaf each).
// A work item (row, tile) is the kResampleTile outputs o0 = tile
// kResampleTile ..; thread t computes the group o0 + kTileR t + u (u <
// kTileR) with group_dot<1> from the item's f32 window, which holds
// x[x0 ..] from x0 at or below the item's first sample o0 - left (left =
// L - 1 - L / 2) such that the row address of x0 is a multiple of 16 bytes:
// every interior 16-byte chunk of the window is one cp.async.  f32 rows
// land in one of two windows; u8 rows (cp.async cannot convert) land as
// bytes in one of two raw buffers and are widened into the one window once
// the item's copies are complete.  The group's outputs go to a tile in
// shared memory that holds output i at i + m, m the output row's
// misalignment in floats, so that 16-byte stores leave it aligned on both
// sides.
//
// Shared floats: the tap table, the windows, the raw buffers (u8 rows), the
// output tile.
struct FirFloatLayout {
  TapLayout taps;
  int stage;      // samples a staged window holds (a multiple of 16)
  int window_at;  // f32 windows: two for f32 rows, one for u8 rows
  int raw_at;     // u8 rows: two raw windows of `stage` bytes
  int out_at;     // the output tile: kResampleTile + 4 floats
  int total;
};

// Samples of a 16-byte u8 chunk: a window of any sample type starts at most
// this many samples less one below its first sample.
constexpr int kFirChunk = 16;

WFT_INLINE FirFloatLayout fir_float_layout(int taps, bool u8) {
  FirFloatLayout l;
  l.taps = tap_layout(1, taps);
  const int window = kResampleTile + taps - 1;
  l.stage = (window + 2 * kFirChunk - 2) / kFirChunk * kFirChunk;
  l.window_at = l.taps.row;
  l.raw_at = l.window_at + (u8 ? 1 : 2) * l.stage;
  l.out_at = l.raw_at + (u8 ? 2 * l.stage / 4 : 0);
  l.total = l.out_at + kResampleTile + 4;
  return l;
}

// The first staged sample of a window whose first read sample is `first`:
// the nearest at or below it whose address in `row` is a multiple of 16
// bytes (rows of whole samples, as tensors are).
template <typename T>
WFT_INLINE long long fir_float_x0(const T* row, long long first) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long lead = static_cast<long long>(
      reinterpret_cast<uintptr_t>(row) / sizeof(T) % V);
  return first - (((first + lead) % V) + V) % V;
}

// Stage item o0's window of `width` samples (a multiple of 16) into w;
// returns its first sample x0.
template <typename T>
WFT_INLINE long long fir_float_stage(const T* row, long long n, long long o0,
                                     int taps, T* w, int width, int t,
                                     int threads) {
  const long long x0 = fir_float_x0(row, o0 - (taps - 1 - taps / 2));
  stage_row_async(row, n, x0, w, width, t, threads);
  return x0;
}

// w[i] = raw[i] as f32 for i < width (a multiple of 4), four a thread.
WFT_INLINE void widen_u8(const uint8_t* raw, float* w, int width, int t,
                         int threads) {
  WFT_ROLLED
  for (int c = t; c < width / 4; c += threads) {
    const uint32_t u = shared_word(raw, 4 * c);
    const float v[4] = {static_cast<float>(u & 0xffu),
                        static_cast<float>((u >> 8) & 0xffu),
                        static_cast<float>((u >> 16) & 0xffu),
                        static_cast<float>(u >> 24)};
    store4(w + 4 * c, v);
  }
}

// The output row's misalignment in floats.
WFT_INLINE int fir_float_shift(const float* dst) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
}

// Thread t's group of the item o0 from its window w (staged from x0) and
// the tap table, into the tile ys at the shift m.
WFT_INLINE void fir_float_thread(const float* w, long long o0, long long x0,
                                 const float* taps, int len,
                                 const TapLayout& l, int t, int m,
                                 float* ys) {
  float acc[kTileR];
  group_dot<1>(w, static_cast<int>(o0 + len / 2 - x0) + kTileR * t, taps,
               len, l, acc);
  WFT_UNROLL
  for (int u = 0; u < kTileR; ++u) ys[m + kTileR * t + u] = acc[u];
}

// dst[i] = ys[i + m] for i < count (m = fir_float_shift(dst)): the head up
// to dst's first aligned float, then 16-byte stores, then the tail.
WFT_INLINE void fir_float_store(const float* ys, float* dst, int count,
                                int t, int threads) {
  const int m = fir_float_shift(dst);
  const int head = ((4 - m) & 3) < count ? ((4 - m) & 3) : count;
  if (t < head) dst[t] = ys[m + t];
  const int body = (count - head) >> 2;
  WFT_ROLLED
  for (int c = t; c < body; c += threads) {
    float v[4];
    load4(ys + m + head + 4 * c, v);
    store4(dst + head + 4 * c, v);
  }
  WFT_ROLLED
  for (int i = head + 4 * body + t; i < count; i += threads) {
    dst[i] = ys[m + i];
  }
}

// ---------------------------------------------------------------- kernel J
// CTA (channel c, m0) of the fused chain over the (C, n) I and Q rows
// computes the messages m0 .. m0 + tile - 1 (m0 a multiple of tile):
//   stage 0  the two input windows   xs[plane][i] = x[plane row, x0 + i],
//   stage 1  resampled samples       rs[plane][i] = resample(q0 + i),
//            q0 = m0 - 1 - ch_left, i < rs_count = tile + Lc, zeroed
//            outside [lo, hi) (the staged path's zero pad of the resampled
//            stream, or the time-sharded chain's window,
//            chain_fused.py:246-265),
//   stage 2  channelized samples     ch[plane][i] = channelize(m0 - 1 + i),
//            i <= tile: one sample to the left, for the discriminator,
//   stage 3  the messages            atan2(cross, dot) * inv_gain, 0 at
//            output 0 (x[-1] is x[0], ops/demod.py).
// rs_count is a multiple of kResampleTile, so stage 1 is whole groups,
// kChainThreads of them a plane for each multiple; the tile is what is left
// after the channelizer's Lc.  In "bf16" storage mode the input arrives as
// bfloat16, the taps are bfloat16 values and each resampled sample is
// rounded to bfloat16 before the channelizer reads it
// (chain_fused.py:270-272); sums stay f32.
struct ChainPlan {
  PolyPlan rs;
  int ch_taps;       // Lc
  long long lo, hi;  // valid window of the resampled stream
  float inv_gain;    // 1 / (2 pi k_f), as f32
  bool bf16;
  int rs_count;      // resampled samples a plane (chain_set_tile)
  int tile;          // messages a CTA: rs_count - Lc
};

// The tiled route (core > 0): the smallest multiple of kResampleTile as
// rs_count that leaves at least half a kResampleTile of messages a CTA.
// The compact route (core 0): kChainTile messages a CTA.
WFT_INLINE void chain_set_tile(ChainPlan& c, int core) {
  if (core > 0) {
    int k = 1;
    while (k * kResampleTile - c.ch_taps < kResampleTile / 2) ++k;
    c.rs_count = k * kResampleTile;
  } else {
    c.rs_count = kChainTile + c.ch_taps;
  }
  c.tile = c.rs_count - c.ch_taps;
}

// Shared memory of a CTA, in floats: the two tap tables, four planes of
// `plane` floats, then the two resampled runs.  A CTA walks work items
// (channel, tile) and stages item k + 1's windows while it computes item k.
// f32 input: item k's two windows are planes 2 (k & 1) and 2 (k & 1) + 1,
// and once stage 1 has read them its channelized runs.  bf16 input: item
// k's raw bf16 windows fill plane k & 1, are widened into planes 2 and 3,
// which then hold the channelized runs.
struct ChainLayout {
  TapLayout rs_taps, ch_taps;
  int ch_taps_at;  // offsets
  int planes_at;
  int rs_at;
  int stage;       // staged window samples a plane
  int plane;       // floats a plane
  int rs_plane;    // floats a resampled run (kTileR past rs_count); the
                   // first holds the messages once stage 2 has read both
  int total;
};

WFT_INLINE ChainLayout chain_layout(const ChainPlan& c) {
  ChainLayout l;
  l.rs_taps = tap_layout(c.rs.down, c.rs.len);
  l.ch_taps = tap_layout(1, c.ch_taps);
  l.ch_taps_at = c.rs.up * l.rs_taps.row;
  l.planes_at = l.ch_taps_at + l.ch_taps.row;
  l.stage = stage_floats(poly_window(c.rs_count, c.rs));
  const int ch_plane = (c.tile + 1 + 3) & ~3;
  l.plane = l.stage > ch_plane ? l.stage : ch_plane;
  l.rs_plane = (c.rs_count + kTileR + 3) & ~3;
  l.rs_at = l.planes_at + 4 * l.plane;
  l.total = l.rs_at + 2 * l.rs_plane;
  return l;
}

WFT_INLINE int chain_ch_left(const ChainPlan& c) {
  return c.ch_taps - 1 - c.ch_taps / 2;
}

WFT_INLINE long long chain_rs_start(long long m0, const ChainPlan& c) {
  return m0 - 1 - chain_ch_left(c);
}

// The run of CTA m0's resampled samples.
WFT_INLINE PolyRun chain_run(long long m0, const ChainPlan& c) {
  return poly_run(chain_rs_start(m0, c), c.rs);
}

// Item k's two f32 windows, l.plane apart, which stage 2 overwrites with the
// channelized runs.
WFT_INLINE float* chain_windows(float* smem, const ChainLayout& l,
                                const ChainPlan& c, int k) {
  return smem + l.planes_at + (c.bf16 ? 2 : 2 * (k & 1)) * l.plane;
}

// Stage item (channel w.row, tile w.tile)'s two windows for its slot k:
// f32 planes, or raw bf16 planes to widen.
WFT_INLINE void chain_prefetch(const float* x_re, const float* x_im,
                                      long long n, const ChainPlan& c,
                                      const ChainLayout& l, const TileWalk& w,
                                      int k, float* smem, int t,
                                      int threads) {
  const PolyRun r = chain_run(w.tile * c.tile, c);
  float* dst = chain_windows(smem, l, c, k);
  for (int plane = 0; plane < 2; ++plane) {
    stage_row_async((plane ? x_im : x_re) + w.row * n, n, run_x0(r, c.rs),
                    dst + plane * l.plane, l.stage, t, threads);
  }
}

WFT_INLINE void chain_prefetch(const uint16_t* x_re,
                                         const uint16_t* x_im, long long n,
                                         const ChainPlan& c,
                                         const ChainLayout& l,
                                         const TileWalk& w, int k,
                                         float* smem, int t, int threads) {
  const PolyRun r = chain_run(w.tile * c.tile, c);
  uint16_t* dst =
      reinterpret_cast<uint16_t*>(smem + l.planes_at + (k & 1) * l.plane);
  for (int plane = 0; plane < 2; ++plane) {
    stage_row_async((plane ? x_im : x_re) + w.row * n, n, run_x0(r, c.rs),
                    dst + plane * l.stage, l.stage, t, threads);
  }
}

// bf16 input: widen item k's raw windows into its f32 windows.
WFT_INLINE void chain_widen(float* smem, const ChainLayout& l,
                            const ChainPlan& c, int k, int t, int threads) {
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(
      smem + l.planes_at + (k & 1) * l.plane);
  float* dst = chain_windows(smem, l, c, k);
  for (int plane = 0; plane < 2; ++plane) {
    widen_bf16(raw + plane * l.stage, dst + plane * l.plane, l.stage, t,
               threads);
  }
}

WFT_INLINE float chain_rs_value(float v, long long q, const ChainPlan& c) {
  v = (q >= c.lo && q < c.hi) ? v : 0.0f;
  return c.bf16 ? round_bf16(v) : v;
}

// Offset of q in [0, rs_count] from the run's first sample q0, clamped.
WFT_INLINE int chain_rs_offset(long long q, long long q0, const ChainPlan& c) {
  return static_cast<int>(q - q0 < 0 ? 0 : q - q0 > c.rs_count ? c.rs_count
                                                               : q - q0);
}

// Stage 1: the groups t, t + threads, ... of both planes (rs_count /
// kTileR a plane) of CTA m0's run r, from the two windows (l.plane apart)
// staged from x0.  Sample i is chain_rs_value(resample(q0 + i), q0 + i),
// with [lo, hi) as offsets.
template <int Q>
WFT_INLINE void chain_resample_thread(const float* smem,
                                      const float* windows,
                                      const ChainLayout& l,
                                      const ChainPlan& c, const PolyRun& r,
                                      long long x0, int t, int threads,
                                      float* rs, long long m0) {
  const PolyPlan& p = c.rs;
  const long long q0 = chain_rs_start(m0, c);
  const int lo = chain_rs_offset(c.lo, q0, c);
  const int hi = chain_rs_offset(c.hi, q0, c);
  const int base = static_cast<int>(r.a0 - x0);
  const int groups = c.rs_count / kTileR;
  for (int g = t; g < 2 * groups; g += threads) {
    const int plane = g >= groups;
    const int i0 = group_first(g - plane * groups, r.shift);
    const int v = i0 * p.down + r.r0;
    float acc[kTileR];
    group_dot<Q>(windows + plane * l.plane, base + (v >> r.shift),
                 smem + (v & (p.up - 1)) * l.rs_taps.row, p.len, l.rs_taps,
                 acc);
    float* run = rs + plane * l.rs_plane;
    WFT_UNROLL
    for (int u = 0; u < kTileR; ++u) {
      const int i = i0 + p.up * u;
      const float kept = (i >= lo && i < hi) ? acc[u] : 0.0f;
      run[i] = c.bf16 ? round_bf16(kept) : kept;
    }
  }
}

// Stage 2: ch[plane][i] = sum_k h[k] * rs[plane][i + Lc - 1 - k], i <= tile,
// kTileR consecutive i a group.
WFT_INLINE void chain_channelize_thread(const float* smem, const float* rs,
                                        const ChainLayout& l,
                                        const ChainPlan& c, int t,
                                        int threads, float* planes) {
  const int groups = (c.tile + kTileR) / kTileR;
  for (int g = t; g < 2 * groups; g += threads) {
    const int plane = g >= groups;
    const int i0 = (g - plane * groups) * kTileR;
    float acc[kTileR];
    group_dot<1>(rs + plane * l.rs_plane, i0 + c.ch_taps - 1,
                 smem + l.ch_taps_at, c.ch_taps, l.ch_taps, acc);
    float* ch = planes + plane * l.plane;
    WFT_UNROLL
    for (int u = 0; u < kTileR; ++u) {
      if (i0 + u <= c.tile) ch[i0 + u] = acc[u];
    }
  }
}

// The discriminator: message m from channelized samples m and m - 1,
// 0 at message 0 (x[-1] is x[0], ops/demod.py).
WFT_INLINE float fm_message(float re_c, float im_c, float re_p, float im_p,
                            long long m, float inv_gain) {
  const float cross = fmaf(im_c, re_p, -(re_c * im_p));
  const float dot = fmaf(re_c, re_p, im_c * im_p);
  return (m == 0) ? 0.0f : atan2f(cross, dot) * inv_gain;
}

// Stage 3: thread t's groups of kTileR consecutive messages m0 + j, j <
// tile, into out[j] (shared memory), each channelized sample read once:
// ch[j0 .. j0 + kTileR] of both planes for messages j0 .. j0 + kTileR - 1.
// store_run then writes the tile's messages out.
WFT_INLINE void chain_demod_thread(const float* ch_re, const float* ch_im,
                                   const ChainPlan& c, int t, int threads,
                                   float* out, long long m0) {
  const int groups = (c.tile + kTileR - 1) / kTileR;
  for (int g = t; g < groups; g += threads) {
    const int j0 = g * kTileR;
    float re_p = ch_re[j0], im_p = ch_im[j0];
    WFT_UNROLL
    for (int u = 0; u < kTileR; ++u) {
      if (j0 + u < c.tile) {
        const float re_c = ch_re[j0 + u + 1], im_c = ch_im[j0 + u + 1];
        out[j0 + u] = fm_message(re_c, im_c, re_p, im_p, m0 + j0 + u,
                                 c.inv_gain);
        re_p = re_c;
        im_p = im_c;
      }
    }
  }
}

// -------------------------------------------------------- the compact route
// Kernels I and J's route for a shape with no tiled core (Q past
// kMaxTiledDown), or whose tiled layout would not fit in shared memory: the
// kernels' first form, whose shared memory is the least any route needs,
// the taps as given and one window a plane.  A CTA (row, m0) computes
// kChainTile consecutive outputs, thread t those m0 + t + 256 u (u < 4)
// through poly_dot4: 256 is a multiple of P, so the four share a branch and
// their anchors step by 256 Q / P.  m0 is a multiple of kChainTile, so the
// window's width is the same for every CTA.

// Kernel I: CTA m0 stages x[row, b_m0 - (J - 1) .. b_(m0 + 1023)].
WFT_INLINE long long resample_compact_base(long long m0, const PolyPlan& p) {
  return poly_anchor(m0, p) - (p.len - 1);
}

WFT_INLINE long long resample_compact_window(const PolyPlan& p) {
  return poly_anchor(kChainTile - 1, p) - poly_anchor(0, p) + p.len;
}

WFT_INLINE void resample_compact_thread(const float* w, const float* taps,
                                        const PolyPlan& p, int t,
                                        float* y_row, long long out_len,
                                        long long m0) {
  const long long m = m0 + t;
  float acc[kChainPerThread];
  poly_dot4(w, static_cast<int>(poly_anchor(m, p) -
                                resample_compact_base(m0, p)),
            kChainThreads * p.down / p.up,
            taps + poly_branch(m, p) * p.tap_stride, p.len, acc);
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const long long o = m + kChainThreads * u;
    if (o < out_len) y_row[o] = acc[u];
  }
}

// Kernel J (chain_set_tile(c, 0)): CTA m0's stages as on the tiled route,
// stage 0 the input windows xs[plane][i] = x[plane row, in0 + i], without
// the tiled route's staging buffers.  Shared floats: the two tap tables as
// given, two windows, two resampled runs, two channelized runs.
WFT_INLINE long long chain_compact_base(long long m0, const ChainPlan& c) {
  return poly_anchor(chain_rs_start(m0, c), c.rs) - (c.rs.len - 1);
}

WFT_INLINE long long chain_compact_window(const ChainPlan& c) {
  const long long q0 = chain_rs_start(0, c);
  return poly_anchor(q0 + c.rs_count - 1, c.rs) - poly_anchor(q0, c.rs) +
         c.rs.len;
}

WFT_INLINE long long chain_compact_floats(const ChainPlan& c) {
  return static_cast<long long>(c.rs.up) * c.rs.tap_stride + c.ch_taps +
         2 * (chain_compact_window(c) + c.rs_count + kChainTile + 1);
}

// Stage 1 for one plane: rs[i] for i < kChainTile four at a time, the
// other Lc one at a time.
WFT_INLINE void chain_compact_resample(const float* xs, const float* rs_taps,
                                       const ChainPlan& c, int t, float* rs,
                                       long long m0) {
  const PolyPlan& p = c.rs;
  const long long q0 = chain_rs_start(m0, c);
  const long long in0 = chain_compact_base(m0, c);
  float acc[kChainPerThread];
  poly_dot4(xs, static_cast<int>(poly_anchor(q0 + t, p) - in0),
            kChainThreads * p.down / p.up,
            rs_taps + poly_branch(q0 + t, p) * p.tap_stride, p.len, acc);
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const int i = t + kChainThreads * u;
    rs[i] = chain_rs_value(acc[u], q0 + i, c);
  }
  for (int i = kChainTile + t; i < c.rs_count; i += kChainThreads) {
    const long long q = q0 + i;
    const float v = poly_dot(xs, static_cast<int>(poly_anchor(q, p) - in0),
                             rs_taps + poly_branch(q, p) * p.tap_stride, p.len);
    rs[i] = chain_rs_value(v, q, c);
  }
}

// Stage 2 for one plane: ch[i] = sum_k h[k] * rs[i + Lc - 1 - k], i <= 1024.
WFT_INLINE void chain_compact_channelize(const float* rs, const float* ch_taps,
                                         const ChainPlan& c, int t,
                                         float* ch) {
  float acc[kChainPerThread];
  poly_dot4(rs, t + c.ch_taps - 1, kChainThreads, ch_taps, c.ch_taps, acc);
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) ch[t + kChainThreads * u] = acc[u];
  if (t == 0) {
    ch[kChainTile] = poly_dot(rs, kChainTile + c.ch_taps - 1, ch_taps,
                              c.ch_taps);
  }
}

// Stage 3: messages m0 + t + 256 u of one channel from its two planes.
WFT_INLINE void chain_compact_demod(const float* ch_re, const float* ch_im,
                                    const ChainPlan& c, int t, float* y_row,
                                    long long out_len, long long m0) {
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const int j = t + kChainThreads * u;
    if (m0 + j < out_len) {
      y_row[m0 + j] = fm_message(ch_re[j + 1], ch_im[j + 1], ch_re[j],
                                 ch_im[j], m0 + j, c.inv_gain);
    }
  }
}

// ------------------------------------------------------------------ routes
// The route of a shape: the tiled core of its Q (core = Q) where Q has one
// and the tiled layout fits kMaxSharedBytes, else the compact route
// (core 0) where it fits, else none (core -1: the launch is refused).
// The compact route needs exactly the first form's shared memory, so every
// shape the first form launched has a route.
constexpr long long kMaxSharedBytes = 227 * 1024;
// Taps a table may hold at most; past it no route fits (and the layouts'
// int arithmetic is not asked).
constexpr int kMaxTableFloats = static_cast<int>(kMaxSharedBytes / 4);

struct Route {
  int core;
  long long shared_bytes;
};

// tiled_floats is read only where down has a tiled core.
inline Route pick_route(int down, long long tiled_floats,
                        long long compact_floats) {
  if (down <= kMaxTiledDown && 4 * tiled_floats <= kMaxSharedBytes) {
    return Route{down, 4 * tiled_floats};
  }
  if (4 * compact_floats <= kMaxSharedBytes) {
    return Route{0, 4 * compact_floats};
  }
  return Route{-1, 0};
}

inline Route resample_route(const PolyPlan& p) {
  if (p.tap_stride > kMaxTableFloats) return Route{-1, 0};
  return pick_route(
      p.down, p.down <= kMaxTiledDown ? resample_layout(p).total : 0,
      static_cast<long long>(p.up) * p.tap_stride + resample_compact_window(p));
}

// c's rs_count and tile are set for the route chosen.
inline Route chain_route(ChainPlan& c) {
  if (c.rs.tap_stride > kMaxTableFloats || c.ch_taps > kMaxTableFloats) {
    return Route{-1, 0};
  }
  long long tiled = 0;
  if (c.rs.down <= kMaxTiledDown) {
    chain_set_tile(c, 1);
    tiled = chain_layout(c).total;
  }
  chain_set_tile(c, 0);
  const Route r = pick_route(c.rs.down, tiled, chain_compact_floats(c));
  chain_set_tile(c, r.core);
  return r;
}

// f(std::integral_constant<int, core>()) for a route's core, 0 to
// kMaxTiledDown: each kernel's and the host harness's one dispatch onto its
// template instances.
template <typename F>
inline auto with_core(int core, F&& f) {
  switch (core) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    default: return f(std::integral_constant<int, 0>());
  }
}
static_assert(kMaxTiledDown == 5, "with_core lists the tiled cores");

}  // namespace wft
