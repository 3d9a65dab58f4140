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
// of the polyphase resampler.  The TPU kernels' band matrices
// (fir_float_mxu.py::build_tile_band_planes_f32, resample_mxu.py::
// build_resample_band) hold exactly these taps at A[a - j, i]; the card has
// native f32 FMAs, so the kernels walk the J nonzeros of each band column
// instead of multiplying by the band.
#pragma once

#include <math.h>

#include <cstdint>
#include <cstring>

#include "wft_fixed.cuh"

namespace wft {

// A CTA computes kChainTile consecutive outputs of one row (of one channel
// for kernel J); thread t computes outputs t + kChainThreads * u, u < 4.
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

// ---------------------------------------------------------------- kernel H
// CTA (row, o0): w holds x[row, o0 - left .. o0 + kChainTile + center)
// with left = L - 1 - L / 2 (fir_float_window floats); output o0 + i is
// sum_k h[k] * w[i + L - 1 - k] (the same-mode contract, k ascending).
WFT_INLINE int fir_float_window(int taps) { return kChainTile + taps - 1; }

WFT_INLINE long long fir_float_base(long long o0, int taps) {
  return o0 - (taps - 1 - taps / 2);
}

WFT_INLINE void fir_float_thread(const float* w, const float* h, int taps,
                                 int t, float* y_row, long long n,
                                 long long o0) {
  float acc[kChainPerThread];
  poly_dot4(w, t + taps - 1, kChainThreads, h, taps, acc);
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const long long o = o0 + t + kChainThreads * u;
    if (o < n) y_row[o] = acc[u];
  }
}

// ---------------------------------------------------------------- kernel I
// The polyphase plan (ops/resample.py::_plan): output m has anchor
// b_m = floor((m Q + c) / P) and branch r_m = m Q + c - P b_m, and is
// sum_j taps[r_m][j] * x[b_m - j].  Requires P | kChainThreads, so that
// every CTA start m0 and the four outputs m, m + 256, ... of a thread share
// one branch and their anchors step by 256 Q / P.
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

// Kernel I's CTA m0 stages x[row, b_m0 - (J - 1) .. b_(m0 + tile - 1)];
// m0 is a multiple of P, so the width is the same for every CTA.
WFT_INLINE long long resample_base(long long m0, const PolyPlan& p) {
  return poly_anchor(m0, p) - (p.len - 1);
}

WFT_INLINE int resample_window(const PolyPlan& p) {
  return static_cast<int>(poly_anchor(kChainTile - 1, p) -
                          poly_anchor(0, p)) + p.len;
}

WFT_INLINE void resample_thread(const float* w, const float* taps,
                                const PolyPlan& p, int t, float* y_row,
                                long long out_len, long long m0) {
  const long long m = m0 + t;
  const int a = static_cast<int>(poly_anchor(m, p) - resample_base(m0, p));
  float acc[kChainPerThread];
  poly_dot4(w, a, kChainThreads * p.down / p.up, taps + poly_branch(m, p) *
            p.tap_stride, p.len, acc);
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const long long o = m + kChainThreads * u;
    if (o < out_len) y_row[o] = acc[u];
  }
}

// ---------------------------------------------------------------- kernel J
// CTA (channel c, m0) of the fused chain over the stacked (2C, n) I/Q rows
// (row c is I, row C + c is Q) computes the messages m0 .. m0 + tile - 1:
//   stage 0  the two input windows   xs[plane][i] = x[plane row, in0 + i],
//   stage 1  resampled samples       rs[plane][i] = resample(q0 + i),
//            q0 = m0 - 1 - ch_left, i < tile + Lc, zeroed outside
//            [lo, hi) (the staged path's zero pad of the resampled stream,
//            or the time-sharded chain's window, chain_fused.py:246-265),
//   stage 2  channelized samples     ch[plane][i] = channelize(m0 - 1 + i),
//            i <= tile: one sample to the left, for the discriminator,
//   stage 3  the messages            atan2(cross, dot) * inv_gain, 0 at
//            output 0 (x[-1] is x[0], ops/demod.py).
// In "bf16" storage mode the input arrives as bfloat16, the taps are
// bfloat16 values and each resampled sample is rounded to bfloat16 before
// the channelizer reads it (chain_fused.py:270-272); sums stay f32.
struct ChainPlan {
  PolyPlan rs;
  int ch_taps;       // Lc
  long long lo, hi;  // valid window of the resampled stream
  float inv_gain;    // 1 / (2 pi k_f), as f32
  bool bf16;
};

WFT_INLINE int chain_ch_left(const ChainPlan& c) {
  return c.ch_taps - 1 - c.ch_taps / 2;
}

WFT_INLINE int chain_rs_count(const ChainPlan& c) {
  return kChainTile + c.ch_taps;
}

WFT_INLINE long long chain_rs_start(long long m0, const ChainPlan& c) {
  return m0 - 1 - chain_ch_left(c);
}

WFT_INLINE long long chain_in_base(long long m0, const ChainPlan& c) {
  return poly_anchor(chain_rs_start(m0, c), c.rs) - (c.rs.len - 1);
}

WFT_INLINE int chain_in_window(const ChainPlan& c) {
  const long long q0 = chain_rs_start(0, c);
  return static_cast<int>(poly_anchor(q0 + chain_rs_count(c) - 1, c.rs) -
                          poly_anchor(q0, c.rs)) + c.rs.len;
}

WFT_INLINE float chain_rs_value(float v, long long q, const ChainPlan& c) {
  v = (q >= c.lo && q < c.hi) ? v : 0.0f;
  return c.bf16 ? round_bf16(v) : v;
}

// Stage 1 for one plane: rs[i] for i < tile four at a time, the rest one
// at a time.
WFT_INLINE void chain_resample_thread(const float* xs, const float* rs_taps,
                                      const ChainPlan& c, int t, float* rs,
                                      long long m0) {
  const PolyPlan& p = c.rs;
  const long long q0 = chain_rs_start(m0, c);
  const long long in0 = chain_in_base(m0, c);
  {
    const long long q = q0 + t;
    float acc[kChainPerThread];
    poly_dot4(xs, static_cast<int>(poly_anchor(q, p) - in0),
              kChainThreads * p.down / p.up,
              rs_taps + poly_branch(q, p) * p.tap_stride, p.len, acc);
    WFT_UNROLL
    for (int u = 0; u < kChainPerThread; ++u) {
      const int i = t + kChainThreads * u;
      rs[i] = chain_rs_value(acc[u], q0 + i, c);
    }
  }
  for (int i = kChainTile + t; i < chain_rs_count(c); i += kChainThreads) {
    const long long q = q0 + i;
    const float v = poly_dot(xs, static_cast<int>(poly_anchor(q, p) - in0),
                             rs_taps + poly_branch(q, p) * p.tap_stride, p.len);
    rs[i] = chain_rs_value(v, q, c);
  }
}

// Stage 2 for one plane: ch[i] = sum_k h[k] * rs[i + Lc - 1 - k], i <= tile.
WFT_INLINE void chain_channelize_thread(const float* rs, const float* ch_taps,
                                        const ChainPlan& c, int t, float* ch) {
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
WFT_INLINE void chain_demod_thread(const float* ch_re, const float* ch_im,
                                   const ChainPlan& c, int t, float* y_row,
                                   long long out_len, long long m0) {
  WFT_UNROLL
  for (int u = 0; u < kChainPerThread; ++u) {
    const int j = t + kChainThreads * u;
    const long long m = m0 + j;
    if (m >= out_len) continue;
    const float re_c = ch_re[j + 1], im_c = ch_im[j + 1];
    const float re_p = ch_re[j], im_p = ch_im[j];
    const float cross = fmaf(im_c, re_p, -(re_c * im_p));
    const float dot = fmaf(re_c, re_p, im_c * im_p);
    y_row[m] = (m == 0) ? 0.0f : atan2f(cross, dot) * c.inv_gain;
  }
}

}  // namespace wft
