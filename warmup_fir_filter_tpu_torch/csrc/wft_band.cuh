// Per-thread cores of kernel A (fir_band.cu): the bit-exact same-mode
// Q-format FIR over (rows, n) uint8 rows, by two routes.
//
// Short-tap route (up to kShortMaxTaps taps): the rows are read as one flat
// byte stream of rows * n samples.
//
// Arithmetic.  The digit-plane form of the TPU kernels,
//     acc = bias + sum_b (sum_k digit_b[k] * (x[n - k + center] - 128)) << e_b,
// equals mod 2^32
//     acc = start + sum_k h[k] * x[n - k + center],  start = bias - 128 sum(h),
// because sum_b digit_b[k] << e_b == h[k] (mod 2^32) and the zero pad
// (x = 0, rebiased -128) is the same term for every tap.  So a thread
// multiplies the raw u8 samples by the int32 taps in uint32 (wrapping as
// the reference's int32 does) from `start`, which keeps the rounding bias
// of the no-wrap epilogue, and runs wft::fixed_epilogue.
//
// Instances.  One template instance per tap count up to 8, then 12, 16,
// 24 and 32: a filter runs on the first that holds it, zero taps around
// it.  Every window index is then a constant.
//
// Layout.  Thread q owns the 16 outputs y[16q .. 16q + 15] of the flat
// array: one 128-bit store.  It reads the 48 samples x[16q - 16 .. 16q + 32)
// as three 16-byte chunks (its own and its neighbours', the latter from
// L1), which covers the halo for up to 33 taps.  A row edge is a mask: a
// chunk that lies inside one row with its whole halo (the common case) runs
// unmasked; one that meets a row edge or the array's end checks each tap's
// column.  A chunk partly outside the array, or an input that is not
// 16-byte aligned, is read byte by byte; the output buffer must be 16-byte
// aligned.
//
// Digit-plane route (more taps, up to kBandMaxTaps): the encoding of the
// TPU band kernels.  A CTA of kBandLane threads computes one 128-column
// output tile of kBandRows rows: every thread stages part of the tile's
// input window (the tile plus its `left` / `center` halo, samples rebiased
// to x ^ 0x80 as int8, positions outside the row u8 0, i.e. -128) and the
// digits in shared memory, then, after a barrier, one column of each row:
//     acc = bias + sum_b (sum_k digit_b[k] * x~[n - k + center]) << exp_b
// mod 2^32, where the bias's 128 * sum(h) cancels the pad's -128.
//
// The header also compiles as plain C++: the CPU tests build it with g++
// and run every thread of every CTA on the host, a CTA's phases one after
// another where the kernels put a barrier.
#pragma once

#include <cstdint>
#include <cstring>

#include "wft_fixed.cuh"

namespace wft {

constexpr int kShortMaxTaps = 32;
constexpr int kShortChunk = 16;          // outputs a thread owns
constexpr int kShortThreads = 256;       // threads of a CTA
constexpr int kShortPerThread = 2;       // chunks a thread loads at once
constexpr int kShortCtaChunks = kShortThreads * kShortPerThread;

struct BandShort {
  uint32_t h[kShortMaxTaps];  // the int32 taps mod 2^32
  uint32_t start;             // bias - 128 * sum(h), mod 2^32
  int wrap, frac_bits, acc_bits;
};

// x[s .. s + 16) as four little-endian words, zero outside [0, total).
WFT_INLINE void short_load(const uint8_t* x, long long total, long long s,
                           bool aligned, uint32_t* w) {
  if (aligned && s >= 0 && s + kShortChunk <= total) {
#if defined(__CUDA_ARCH__)
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + s));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
#else
    std::memcpy(w, x + s, kShortChunk);
#endif
    return;
  }
  WFT_UNROLL
  for (int i = 0; i < 4; ++i) w[i] = 0u;
  WFT_UNROLL
  for (int i = 0; i < kShortChunk; ++i) {
    const long long j = s + i;
    if (j >= 0 && j < total) {
      w[i >> 2] |= static_cast<uint32_t>(x[j]) << (8 * (i & 3));
    }
  }
}

// The 48-sample window of chunk q: word i holds x[16q - 16 + 4i .. + 4).
struct ShortWindow {
  uint32_t w[12];
};

template <int L>
WFT_INLINE ShortWindow short_window(const uint8_t* x, long long total,
                                    long long q, bool aligned) {
  constexpr int center = L / 2, left = L - 1 - center;
  ShortWindow win;
  const long long p0 = q * kShortChunk;
  if (left > 0) {
    short_load(x, total, p0 - kShortChunk, aligned, win.w);
  } else {
    for (int i = 0; i < 4; ++i) win.w[i] = 0u;
  }
  short_load(x, total, p0, aligned, win.w + 4);
  if (center > 0) {
    short_load(x, total, p0 + kShortChunk, aligned, win.w + 8);
  } else {
    for (int i = 8; i < 12; ++i) win.w[i] = 0u;
  }
  return win;
}

WFT_INLINE uint32_t window_byte(const ShortWindow& win, int i) {
  return (win.w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// The 16 accumulators of chunk q (first column c0) through the epilogue,
// packed four to a word.  EDGE checks each tap's column against the row.
template <int L, bool EDGE, bool WRAP>
WFT_INLINE void short_compute(const ShortWindow& win, long long c0,
                              long long n, const BandShort& p,
                              uint32_t* out) {
  constexpr int center = L / 2;
  long long c = c0;  // column of output j
  WFT_UNROLL
  for (int j = 0; j < kShortChunk; ++j) {
    uint32_t acc = p.start;
    WFT_UNROLL
    for (int k = 0; k < L; ++k) {
      if (!EDGE || (c + center - k >= 0 && c + center - k < n)) {
        acc += p.h[k] * window_byte(win, kShortChunk + j + center - k);
      }
    }
    out[j >> 2] |=
        static_cast<uint32_t>(fixed_epilogue(acc, WRAP, p.frac_bits,
                                             p.acc_bits))
        << (8 * (j & 3));
    if (EDGE) c = c + 1 == n ? 0 : c + 1;
  }
}

// The 16 outputs of chunk q from its window, stored to y.
template <int L>
WFT_INLINE void short_outputs(const ShortWindow& win, uint8_t* y,
                              long long total, long long n, long long q,
                              const BandShort& p) {
  constexpr int center = L / 2, left = L - 1 - center;
  const long long p0 = q * kShortChunk;
  const long long c0 =
      total <= 0xFFFFFFFFll
          ? static_cast<long long>(static_cast<uint32_t>(p0) %
                                   static_cast<uint32_t>(n))
          : p0 % n;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
  if (c0 >= left && c0 + (kShortChunk - 1) + center < n) {  // one row
    p.wrap ? short_compute<L, false, true>(win, c0, n, p, out)
           : short_compute<L, false, false>(win, c0, n, p, out);
  } else {
    p.wrap ? short_compute<L, true, true>(win, c0, n, p, out)
           : short_compute<L, true, false>(win, c0, n, p, out);
  }
  if (p0 + kShortChunk <= total) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(y + p0) = make_uint4(out[0], out[1], out[2],
                                                   out[3]);
#else
    std::memcpy(y + p0, out, kShortChunk);
#endif
  } else {
    WFT_UNROLL
    for (int j = 0; j < kShortChunk; ++j) {
      if (p0 + j < total) {
        y[p0 + j] = static_cast<uint8_t>(out[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

// The short route's instances: a filter of `taps` runs on the first of
// these tap counts that holds it, its taps placed so that the center
// stays put and zero taps fill the rest (one instance for each count up
// to 8, the main path's 3- and 5-tap banks included, then buckets).
constexpr int kShortInstances[] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32};
constexpr int kShortInstanceCount = 12;

inline int short_instance(int taps) {
  int i = 0;
  while (kShortInstances[i] < taps) ++i;
  return i;
}

// The accumulator's start and the launch constants of the short route for
// the instance of `width` taps (width >= taps).
WFT_INLINE BandShort band_short_params(int taps, int width, const int32_t* h,
                                       uint32_t bias, int wrap, int frac_bits,
                                       int acc_bits) {
  BandShort p{};
  const int shift = width / 2 - taps / 2;  // keeps the center tap's column
  uint32_t sum = 0u;
  for (int k = 0; k < taps; ++k) {
    p.h[k + shift] = static_cast<uint32_t>(h[k]);
    sum += static_cast<uint32_t>(h[k]);
  }
  p.start = bias - 128u * sum;
  p.wrap = wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  return p;
}

// Thread t of CTA b: chunks b * kShortCtaChunks + t + i * kShortThreads,
// i < kShortPerThread, all loaded before any is computed.
template <int L>
WFT_INLINE void short_thread(const uint8_t* x, uint8_t* y, long long total,
                             long long n, long long chunks,
                             const BandShort& p, long long b, int t) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  ShortWindow win[kShortPerThread];
  WFT_UNROLL
  for (int i = 0; i < kShortPerThread; ++i) {
    const long long q = b * kShortCtaChunks + t + i * kShortThreads;
    if (q < chunks) win[i] = short_window<L>(x, total, q, aligned);
  }
  WFT_UNROLL
  for (int i = 0; i < kShortPerThread; ++i) {
    const long long q = b * kShortCtaChunks + t + i * kShortThreads;
    if (q < chunks) short_outputs<L>(win[i], y, total, n, q, p);
  }
}

// ------------------------------------------------------ digit-plane route
constexpr int kBandLane = 128;                    // output columns a CTA
constexpr int kBandRows = 8;                      // rows a CTA
constexpr int kBandMaxTaps = 2 * kBandLane + 1;   // fir_mxu.py:82
constexpr int kBandMaxPlanes = 5;                 // base-256 digits of an int32
constexpr int kBandWindow = kBandLane + kBandMaxTaps - 1;

struct BandParams {
  int planes;
  int taps;
  int left;  // taps - 1 - taps / 2
  int exps[kBandMaxPlanes];
  uint32_t bias;  // 128 sum(h) (+ 2^(frac_bits-1) when !needs_wrap), mod 2^32
  int needs_wrap;
  int frac_bits;
  int acc_bits;
};

// Thread i's share of CTA (row0, col0)'s staging: digits and input window.
WFT_INLINE void band_stage_thread(const uint8_t* x, long long rows,
                                  long long n, long long row0, long long col0,
                                  const int8_t* digits, const BandParams& p,
                                  int8_t (*xs)[kBandWindow],
                                  int8_t (*ds)[kBandMaxTaps], int i) {
  const int width = kBandLane + p.taps - 1;
  for (int j = i; j < p.planes * p.taps; j += kBandLane) {
    ds[j / p.taps][j % p.taps] = digits[j];
  }
  for (int r = 0; r < kBandRows; ++r) {
    const long long row = row0 + r;
    for (int j = i; j < width; j += kBandLane) {
      const long long m = col0 - p.left + j;
      uint8_t v = 0;  // zero pad: rebiases to -128
      if (row < rows && m >= 0 && m < n) v = x[row * n + m];
      xs[r][j] = static_cast<int8_t>(v ^ 0x80u);
    }
  }
}

// Thread i's outputs: column col0 + i of the CTA's rows.
WFT_INLINE void band_planes_thread(int8_t (*xs)[kBandWindow],
                                   int8_t (*ds)[kBandMaxTaps],
                                   const BandParams& p, uint8_t* y,
                                   long long rows, long long n,
                                   long long row0, long long col0, int i) {
  const long long col = col0 + i;
  if (col >= n) return;
  for (int r = 0; r < kBandRows; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;
    // xs[r][i + taps - 1 - k] holds x~[col - k + center].
    const int8_t* xw = &xs[r][i + p.taps - 1];
    uint32_t acc = p.bias;
    // Constant plane indices keep p.exps out of local memory.
    WFT_UNROLL
    for (int b = 0; b < kBandMaxPlanes; ++b) {
      if (b < p.planes) {
        const int8_t* d = ds[b];
        int32_t s = 0;  // |s| <= 257 * 128 * 128: no overflow
        for (int k = 0; k < p.taps; ++k) {
          s += static_cast<int32_t>(d[k]) * static_cast<int32_t>(xw[-k]);
        }
        const int e = p.exps[b];
        // A shift of 32 or more leaves nothing mod 2^32 (and is UB in C++).
        if (e < 32) acc += static_cast<uint32_t>(s) << e;
      }
    }
    y[row * n + col] =
        fixed_epilogue(acc, p.needs_wrap != 0, p.frac_bits, p.acc_bits);
  }
}

}  // namespace wft
