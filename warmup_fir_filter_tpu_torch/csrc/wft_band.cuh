// Cores of kernel A (fir_band.cu): the bit-exact same-mode Q-format FIR
// over (rows, n) uint8 rows, by two routes.
//
// Short-tap route (kernel A's up to kBandShortMaxTaps taps, kernel B's up
// to kShortMaxTaps): the rows are read as one flat byte stream of rows * n
// samples.
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
// it.  Every window index is then a constant.  Kernel A compiles the
// first kBandShortInstances of them, kernel B all.
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
// Digit-plane route (kernel A's from kBandShortMaxTaps + 1 to kBandMaxTaps
// taps): the encoding of the TPU band kernels (kept signed base-256 digit
// planes, one exponent each) on int8 tensor cores.  A CTA of kPlanesWarps
// warps builds every lane's A fragments of every plane's Toeplitz band
// once (planes_setup_*); then each warp works alone through a contiguous
// run of items, an item being kPlanesCols output columns of one row
// (planes_warp), its window staged by cp.async while earlier items
// multiply.
//
// The header also compiles as plain C++: the CPU tests build it with g++
// and run every thread of every CTA on the host, a CTA's phases one after
// another where the kernels put a barrier, and the digit-plane route's
// warps with their 32 lanes as one unit (wft_band_mma.cuh emulates the
// MMA).
#pragma once

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "wft_band_mma.cuh"
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

// Kernel A's crossover: the short-tap route up to kBandShortMaxTaps taps,
// on its first kBandShortInstances instances, the digit planes beyond.  On
// an H100 at 19,456 x 8,192 the digit planes take about 0.17 ms from 1 to
// 16 taps, the short route 0.12 at 3 taps, 0.15 at 5, 0.17 at 6 and 0.20
// at 7 (PERF.md §6).  Kernel B keeps the short route to kShortMaxTaps.
constexpr int kBandShortMaxTaps = 6;
constexpr int kBandShortInstances = 6;
static_assert(kShortInstances[kBandShortInstances - 1] == kBandShortMaxTaps,
              "kernel A's short instances end at its crossover");

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
constexpr int kBandMaxTaps = 257;    // fir_mxu.py:82, 2 * 128 + 1
constexpr int kBandMaxPlanes = 5;    // signed base-256 digits of an int32
constexpr int kPlanesWarps = 4;      // warps of a CTA, each alone on its items
constexpr int kPlanesThreads = kWarp * kPlanesWarps;
constexpr int kPlanesTiles = 8;      // 128-column m16n8 tiles of an item
constexpr int kPlanesCols = 128 * kPlanesTiles;  // output columns of an item
constexpr int kPlanesMaxChunks = 9;  // k32 chunks of a band at kBandMaxTaps
constexpr int kPlanesPass = 2;       // planes whose bands a warp holds at once
constexpr int kPlanesStages = 4;     // a warp's windows: items staged ahead + 1

// k32 chunks of a 16-column sub-tile's band: k runs over taps + 15.
WFT_INLINE int planes_chunks(int taps) { return (taps + 15 + 31) / 32; }

// The per-launch constants.  start = bias - 128 sum(h) mod 2^32: the MMA
// multiplies the raw u8 samples, not x ^ 0x80 (see below).
struct PlanesParams {
  int planes, taps, left, chunks;
  uint32_t start;
  int wrap, frac_bits, acc_bits;
  int exps[kBandMaxPlanes];
  long long items_per_row;  // ceil((n + 15) / kPlanesCols)
  long long items;          // rows * items_per_row
};

// A call's constants: items < 1 where rows * items_per_row would overflow.
WFT_INLINE PlanesParams planes_params(long long rows, long long n, int planes,
                                      int taps, const int* exps,
                                      uint32_t bias, int wrap, int frac_bits,
                                      int acc_bits, const int32_t* h) {
  PlanesParams p;
  p.planes = planes;
  p.taps = taps;
  p.left = taps - 1 - taps / 2;
  p.chunks = planes_chunks(taps);
  uint32_t sum = 0u;
  for (int k = 0; k < taps; ++k) sum += static_cast<uint32_t>(h[k]);
  p.start = bias - 128u * sum;
  p.wrap = wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  for (int b = 0; b < kBandMaxPlanes; ++b) {
    p.exps[b] = b < planes ? exps[b] : 32;
  }
  p.items_per_row = (n + 15 + kPlanesCols - 1) / kPlanesCols;
  p.items = p.items_per_row > LLONG_MAX / rows ? 0 : rows * p.items_per_row;
  return p;
}

// Byte offsets of a CTA's dynamic shared memory.
struct PlanesLayout {
  int band;        // A fragments: planes x chunks x 32 lanes x 4 words
  int digits;      // the digit planes as given, planes x taps bytes
  int flags;       // [kBandMaxPlanes][kPlanesMaxChunks]: chunk has a digit
  int meta;        // ints: the planes' exponents
  int warps;       // the first warp's region: its windows, the output tile
  int win;         // bytes of a window: its item's samples and their halo
  int out;         // bytes of the output tile
  int part;        // bytes of the accumulators between passes
  int warp_bytes;  // kPlanesStages windows, the output tile, the part
  int total;
};

WFT_INLINE int round16(int bytes) { return (bytes + 15) / 16 * 16; }

WFT_INLINE PlanesLayout planes_layout(int planes, int taps, int chunks) {
  PlanesLayout lay;
  lay.band = 0;
  lay.digits = planes * chunks * kWarp * 16;
  lay.flags = lay.digits + round16(planes * taps);
  lay.meta = lay.flags + round16(kBandMaxPlanes * kPlanesMaxChunks);
  lay.warps = lay.meta + 32;
  lay.win = kPlanesCols + 32 * chunks - 16;
  lay.out = kPlanesCols + 16;
  lay.part = kPlanesTiles * 4 * kWarp * 4;
  lay.warp_bytes = kPlanesStages * lay.win + lay.out + lay.part;
  lay.total = lay.warps + kPlanesWarps * lay.warp_bytes;
  return lay;
}

// Word w of lane l's A fragment of chunk c: the band A[i, k] = rd[k - i]
// (rd[q] = digit[taps - 1 - q], 0 outside the taps) with the k order that
// puts a lane's two B words side by side: k slot 4t + e is k = 8t + e and
// slot 16 + 4t + e is k = 8t + 4 + e.  So a[0] = A(g, 32c + 8t + e),
// a[1] = A(g + 8, ...), a[2] = A(g, 32c + 8t + 4 + e), a[3] = A(g + 8, ...).
WFT_INLINE uint32_t planes_band_word(const int8_t* digit, int taps, int c,
                                     int lane, int w) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = 32 * c + 8 * t + 4 * (w >> 1) - g - 8 * (w & 1);
  uint32_t word = 0u;
  for (int e = 0; e < 4; ++e) {
    const int q = q0 + e;
    if (q >= 0 && q < taps) {
      word |= static_cast<uint32_t>(static_cast<uint8_t>(digit[taps - 1 - q]))
              << (8 * e);
    }
  }
  return word;
}

// Thread i of the CTA's first set-up phase: the digit planes into shared
// memory (32-bit loads, the last partial word by bytes) and the exponents.
WFT_INLINE void planes_setup_digits(uint8_t* smem, const int8_t* digits,
                                    const PlanesParams& p,
                                    const PlanesLayout& lay, int i) {
  uint8_t* ds = smem + lay.digits;
  const int count = p.planes * p.taps;
  int words = 0;
  if ((reinterpret_cast<uintptr_t>(digits) & 3u) == 0) {
    words = count / 4;
    for (int w = i; w < words; w += kPlanesThreads) {
      reinterpret_cast<uint32_t*>(ds)[w] =
          reinterpret_cast<const uint32_t*>(digits)[w];
    }
  }
  for (int j = 4 * words + i; j < count; j += kPlanesThreads) {
    ds[j] = static_cast<uint8_t>(digits[j]);
  }
  if (i == 0) {
    int* meta = reinterpret_cast<int*>(smem + lay.meta);
    WFT_UNROLL
    for (int b = 0; b < kBandMaxPlanes; ++b) meta[b] = p.exps[b];
  }
}

// Thread i of the second phase: every lane's A fragments of every plane and
// chunk, and which chunks of a plane hold a nonzero digit (chunk c's band
// reads rd[32c - 15 .. 32c + 31]).
WFT_INLINE void planes_setup_band(uint8_t* smem, const PlanesParams& p,
                                  const PlanesLayout& lay, int i) {
  const int8_t* ds = reinterpret_cast<const int8_t*>(smem + lay.digits);
  uint32_t* band = reinterpret_cast<uint32_t*>(smem + lay.band);
  const int words = p.planes * p.chunks * kWarp * 4;
  for (int j = i; j < words; j += kPlanesThreads) {
    const int bc = j / (kWarp * 4);
    const int b = bc / p.chunks;
    band[j] = planes_band_word(ds + b * p.taps, p.taps, bc % p.chunks,
                               (j / 4) % kWarp, j % 4);
  }
  for (int j = i; j < p.planes * p.chunks; j += kPlanesThreads) {
    const int b = j / p.chunks;
    const int c = j % p.chunks;
    uint8_t any = 0;
    for (int q = 32 * c - 15; q <= 32 * c + 31; ++q) {
      if (q >= 0 && q < p.taps && ds[b * p.taps + p.taps - 1 - q] != 0) {
        any = 1;
      }
    }
    smem[lay.flags + b * kPlanesMaxChunks + c] = any;
  }
}

// Item k of row r: output columns col0 + [0, 128 tiles), where col0 is
// shifted down from k * kPlanesCols by the row's misalignment, so that the
// window's first sample, column col0 - left, is 16-byte aligned in device
// memory.  tiles counts the 128-column tiles that reach into the row.
struct PlanesItem {
  long long r, col0;
  int tiles;
};

WFT_INLINE PlanesItem planes_item(const uint8_t* x, long long n, int left,
                                  long long r, long long k) {
  PlanesItem it;
  it.r = r;
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(r * n) -
       static_cast<uintptr_t>(left)) & 15u);
  it.col0 = k * kPlanesCols - shift;
  const long long rest = n - it.col0;
  it.tiles = rest <= 0 ? 0
             : rest >= kPlanesCols ? kPlanesTiles
                                   : static_cast<int>((rest + 127) / 128);
  return it;
}

// One lane's share of staging item `it`'s window into buf: the row's
// 16-byte chunks lane, lane + 32, ...; buf[j] is column col0 - left + j.
// A chunk inside the row lands by cp.async, one outside it is zeroed (u8
// 0, the TPU's zero pad), one a row edge cuts is loaded whole (16 bytes)
// with the other row's bytes zeroed; only a chunk past either end of the
// array is read byte by byte.
WFT_INLINE void planes_stage(uint8_t* buf, const uint8_t* x, long long rows,
                             long long n, int left, int chunks,
                             const PlanesItem& it, int lane) {
  if (it.tiles == 0) return;
  const int bytes = 128 * it.tiles + 32 * chunks - 16;
  const long long m0 = it.col0 - left;  // row column of buf[0]
  const long long total = rows * n;
  const uint8_t* row = x + it.r * n;
  for (int c = lane; c < bytes / 16; c += kWarp) {
    const long long m = m0 + 16LL * c;
    uint8_t* dst = buf + 16 * c;
    if (m >= 0 && m + 16 <= n) {
      copy16_async(dst, row + m);
    } else if (m + 16 <= 0 || m >= n) {
      zero16(dst);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const long long s = it.r * n + m;  // flat index of the chunk
      if (s >= 0 && s + 16 <= total) {
#if defined(__CUDA_ARCH__)
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + m));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
#else
        std::memcpy(w, row + m, 16);
#endif
        for (int e = 0; e < 16; ++e) {
          if (m + e < 0 || m + e >= n) w[e >> 2] &= ~(0xFFu << (8 * (e & 3)));
        }
      } else {
        for (int e = 0; e < 16; ++e) {
          if (m + e >= 0 && m + e < n) {
            w[e >> 2] |= static_cast<uint32_t>(row[m + e]) << (8 * (e & 3));
          }
        }
      }
#if defined(__CUDA_ARCH__)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
      std::memcpy(dst, w, 16);
#endif
    }
  }
}

// One lane's share of writing item `it`'s output tile to its row of y.
// out[off + j] is column col0 + j (off, the output's alignment, is the
// same for every item of a row), so out's 16-byte chunk c is the row's
// aligned chunk at column col0 - off + 16c.  A chunk inside [lo, hi) goes
// as one store, one that a row end cuts byte by byte.  Where the previous
// item of the warp's run ended inside chunk 0 (carry_in), its bytes are in
// out[0, off) already, so the chunk goes whole; where the next item goes
// on with the row (carry_out), the last chunk is left to it: lane 0 moves
// it to out's chunk 0.
WFT_INLINE void planes_store(uint8_t* out, int off, uint8_t* y, long long n,
                             const PlanesItem& it, bool carry_in,
                             bool carry_out, int lane) {
  const long long lo =
      carry_in ? it.col0 - off : it.col0 > 0 ? it.col0 : 0;
  const long long end = it.col0 + 128LL * it.tiles;
  const long long hi = end < n ? end : n;
  uint8_t* row = y + it.r * n;
  const int chunks = (off + 128 * it.tiles + 15) / 16 - (carry_out ? 1 : 0);
  for (int c = lane; c < chunks; c += kWarp) {
    const long long m = it.col0 - off + 16LL * c;  // column of out[16c]
#if defined(__CUDA_ARCH__)
    const uint4 v = *reinterpret_cast<const uint4*>(out + 16 * c);
#endif
    if (m >= lo && m + 16 <= hi) {
#if defined(__CUDA_ARCH__)
      *reinterpret_cast<uint4*>(row + m) = v;
#else
      std::memcpy(row + m, out + 16 * c, 16);
#endif
    } else {
      uint32_t w[4];
#if defined(__CUDA_ARCH__)
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
#else
      std::memcpy(w, out + 16 * c, 16);
#endif
      WFT_UNROLL
      for (int e = 0; e < 16; ++e) {
        if (m + e >= lo && m + e < hi) {
          row[m + e] = static_cast<uint8_t>(w[e >> 2] >> (8 * (e & 3)));
        }
      }
    }
  }
  if (carry_out && lane == 0) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(out) =
        *reinterpret_cast<const uint4*>(out + 16 * chunks);
#else
    std::memcpy(out, out + 16 * chunks, 16);
#endif
  }
}

// The accumulators of an item's tiles through the epilogue into its output
// tile: D(g, 2t) is column 32t + g of tile u, D(g, 2t+1) 32t + 16 + g,
// D(g+8, 2t) 32t + 8 + g, D(g+8, 2t+1) 32t + 24 + g.
template <bool WRAP, int TILES>
WFT_INLINE void planes_bytes(const uint32_t (&acc)[TILES][kLaneSlots][4],
                             uint8_t* out, int frac_bits, int acc_bits) {
  WFT_LANES(l) {
    const int g = l >> 2;
    const int t = l & 3;
    WFT_UNROLL
    for (int u = 0; u < TILES; ++u) {
      WFT_UNROLL
      for (int j = 0; j < 4; ++j) {
        out[128 * u + 32 * t + g + 16 * (j & 1) + 8 * (j >> 1)] =
            fixed_epilogue(acc[u][WFT_SLOT(l)][j], WRAP, frac_bits, acc_bits);
      }
    }
  }
}

// A warp's items first .. first + count - 1 (item k of row r is
// r * items_per_row + k), CHUNKS = p.chunks.
//
// Sub-tile m (0-7) of tile u is output columns col0 + 128u + 16m + [0, 16):
//     D[i, m] = sum_k A[i, k] B[k, m],  A[i, k] = rd[k - i],
//     B[k, m] = buf[128u + 16m + k],
// one m16n8k32 MMA a chunk, with A (the band, in registers for the whole
// run of items while the planes fit one pass) in the permuted k order of
// planes_band_word, so B(4t.., g) and B(16 + 4t.., g) of chunk c are the
// two words of one 8-byte shared load at 128u + 16g + 32c + 8t.  The
// samples stay u8 (mma s8 x u8), so a pad column is 0 and the start
// bias - 128 sum(h) stands for the rebias x ^ 0x80 of the plain version:
// the same accumulator mod 2^32.  A plane's s32 sums are exact
// (|s| <= 288 * 128 * 255 < 2^24) and fold into the uint32 accumulators
// shifted by its exponent; chunks of a plane with no nonzero digit are
// skipped, so a low-pass's high-byte plane costs its main lobe only.  An
// item multiplies 2, 4 or all 8 of its tiles, the fewest that reach the
// row's end (the outputs past it are not stored).  The accumulators go
// through the epilogue into the output tile at the output's alignment,
// then out in 16-byte stores, a chunk that two items share whole
// (planes_store).  The windows of the next kPlanesStages - 1 items land by
// cp.async while this one multiplies: a warp keeps 3-4 KB of its row in
// flight.
template <int CHUNKS>
WFT_INLINE void planes_warp(const uint8_t* x, uint8_t* y, long long rows,
                            long long n, const uint8_t* cta, uint8_t* own,
                            const PlanesParams& p, const PlanesLayout& lay,
                            long long first, long long count) {
  const uint32_t* band = reinterpret_cast<const uint32_t*>(cta + lay.band);
  const uint8_t* flags = cta + lay.flags;
  const int* meta = reinterpret_cast<const int*>(cta + lay.meta);
  uint8_t* out = own + kPlanesStages * lay.win;
  const int passes = (p.planes + kPlanesPass - 1) / kPlanesPass;

  // The A fragments, chunk masks and exponents of one pass's planes.
  uint32_t a[kPlanesPass][CHUNKS][kLaneSlots][4];
  uint32_t mask[kPlanesPass];
  int exp[kPlanesPass];
  const auto load_pass = [&](int pass) {
    WFT_UNROLL
    for (int q = 0; q < kPlanesPass; ++q) {
      const int b = pass * kPlanesPass + q;
      mask[q] = 0u;
      exp[q] = 32;
      if (b < p.planes) {
        exp[q] = meta[b];
        WFT_UNROLL
        for (int c = 0; c < CHUNKS; ++c) {
          mask[q] |= static_cast<uint32_t>(flags[b * kPlanesMaxChunks + c])
                     << c;
        }
        if (exp[q] >= 32) mask[q] = 0u;  // nothing mod 2^32
      }
      WFT_UNROLL
      for (int c = 0; c < CHUNKS; ++c) {
        WFT_LANES(l) {
          const int at = ((b * CHUNKS + c) * kWarp + l) * 4;
          WFT_UNROLL
          for (int w = 0; w < 4; ++w) {
            a[q][c][WFT_SLOT(l)][w] = b < p.planes ? band[at + w] : 0u;
          }
        }
      }
    }
  };
  if (passes == 1) load_pass(0);

  // The item in buf, TILES of its tiles (the rest lie past the row's
  // end), through every pass and the epilogue into out_at.
  uint32_t* part = reinterpret_cast<uint32_t*>(out + lay.out);
  const auto multiply = [&](auto tiles, const uint8_t* buf, uint8_t* out_at) {
    constexpr int TILES = decltype(tiles)::value;
    // One pass's plane sums.
    int32_t s[TILES][kPlanesPass][kLaneSlots][4];
    const auto sums = [&]() {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int u = 0; u < TILES; ++u) {
          WFT_UNROLL
          for (int q = 0; q < kPlanesPass; ++q) {
            WFT_UNROLL
            for (int j = 0; j < 4; ++j) s[u][q][WFT_SLOT(l)][j] = 0;
          }
        }
      }
      WFT_UNROLL
      for (int c = 0; c < CHUNKS; ++c) {
        uint32_t bf[TILES][kLaneSlots][2];
        WFT_LANES(l) {
          const uint8_t* at = buf + 16 * (l >> 2) + 32 * c + 8 * (l & 3);
          WFT_UNROLL
          for (int u = 0; u < TILES; ++u) {
#if defined(__CUDA_ARCH__)
            const uint2 v = *reinterpret_cast<const uint2*>(at + 128 * u);
            bf[u][0][0] = v.x;
            bf[u][0][1] = v.y;
#else
            std::memcpy(bf[u][l], at + 128 * u, 8);
#endif
          }
        }
        WFT_UNROLL
        for (int q = 0; q < kPlanesPass; ++q) {
          if ((mask[q] >> c) & 1u) {
            WFT_UNROLL
            for (int u = 0; u < TILES; ++u) {
              mma_s8u8(s[u][q], a[q][c], bf[u]);
            }
          }
        }
      }
    };
    // The accumulators, start + each plane's sums << its exponent, the
    // shift a multiply by 2^exponent (0 for a skipped plane).  With more
    // than one pass they wait in shared memory, word (4u + j) * 32 + lane
    // of part, while the next pass multiplies.
    uint32_t acc[TILES][kLaneSlots][4];
    const auto fold = [&](bool first_pass) {
      uint32_t scale[kPlanesPass];
      WFT_UNROLL
      for (int q = 0; q < kPlanesPass; ++q) {
        scale[q] = mask[q] != 0u ? 1u << exp[q] : 0u;
      }
      WFT_LANES(l) {
        WFT_UNROLL
        for (int u = 0; u < TILES; ++u) {
          WFT_UNROLL
          for (int j = 0; j < 4; ++j) {
            uint32_t& shared = part[(4 * u + j) * kWarp + l];
            uint32_t v = first_pass ? p.start : shared;
            WFT_UNROLL
            for (int q = 0; q < kPlanesPass; ++q) {
              v += static_cast<uint32_t>(s[u][q][WFT_SLOT(l)][j]) * scale[q];
            }
            if (first_pass) {
              acc[u][WFT_SLOT(l)][j] = v;
            } else {
              shared = v;
            }
          }
        }
      }
    };
    // acc to part (to_part) or back.
    const auto park = [&](bool to_part) {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int u = 0; u < TILES; ++u) {
          WFT_UNROLL
          for (int j = 0; j < 4; ++j) {
            uint32_t& shared = part[(4 * u + j) * kWarp + l];
            if (to_part) {
              shared = acc[u][WFT_SLOT(l)][j];
            } else {
              acc[u][WFT_SLOT(l)][j] = shared;
            }
          }
        }
      }
    };
    if (passes > 1) load_pass(0);
    sums();
    fold(true);
    if (passes > 1) {
      park(true);
      for (int pass = 1; pass < passes; ++pass) {
        load_pass(pass);
        sums();
        fold(false);
      }
      park(false);
    }
    if (p.wrap) {
      planes_bytes<true, TILES>(acc, out_at, p.frac_bits, p.acc_bits);
    } else {
      planes_bytes<false, TILES>(acc, out_at, p.frac_bits, p.acc_bits);
    }
  };

  // Two cursors over the run: the item this step multiplies, and the one
  // it stages kPlanesStages - 1 items ahead.
  long long r = first / p.items_per_row;
  long long k = first % p.items_per_row;
  long long rs = r;
  long long ks = k;
  const auto advance = [&](long long& row, long long& col) {
    if (++col == p.items_per_row) {
      col = 0;
      ++row;
    }
  };
  for (int ahead = 0; ahead < kPlanesStages - 1; ++ahead) {
    if (ahead < count) {
      const PlanesItem st = planes_item(x, n, p.left, rs, ks);
      WFT_LANES(l) planes_stage(own + ahead * lay.win, x, rows, n, p.left,
                                CHUNKS, st, l);
      advance(rs, ks);
    }
    async_commit();
  }
  bool carry_in = false;
  for (long long step = 0; step < count; ++step) {
    const PlanesItem it = planes_item(x, n, p.left, r, k);
    advance(r, k);
    if (step + kPlanesStages - 1 < count) {
      const PlanesItem st = planes_item(x, n, p.left, rs, ks);
      WFT_LANES(l) {
        planes_stage(own + ((step + kPlanesStages - 1) % kPlanesStages) *
                               lay.win,
                     x, rows, n, p.left, CHUNKS, st, l);
      }
      advance(rs, ks);
    }
    async_commit();
    async_wait<kPlanesStages - 1>();
    warp_sync();
    if (it.tiles == 0) {  // a row's spare last item: nothing to write
      carry_in = false;
      continue;
    }
    const uint8_t* buf = own + (step % kPlanesStages) * lay.win;
    const int off = static_cast<int>(
        (reinterpret_cast<uintptr_t>(y) +
         static_cast<uintptr_t>(it.r * n + it.col0)) & 15u);
    if (it.tiles <= 2) {
      multiply(std::integral_constant<int, 2>(), buf, out + off);
    } else if (it.tiles <= 4) {
      multiply(std::integral_constant<int, 4>(), buf, out + off);
    } else {
      multiply(std::integral_constant<int, kPlanesTiles>(), buf, out + off);
    }
    warp_sync();
    const bool carry_out = off != 0 && it.tiles == kPlanesTiles &&
                           it.col0 + kPlanesCols < n &&
                           step + 1 < count && r == it.r;
    WFT_LANES(l) planes_store(out, off, y, n, it, carry_in, carry_out, l);
    carry_in = carry_out;
    warp_sync();  // out and buf are read before they are written again
  }
}

// Warp w of `warps`: its run of the items, as (first, count).
WFT_INLINE void planes_share(long long items, long long warps, long long w,
                             long long* first, long long* count) {
  const long long per = items / warps;
  const long long extra = items % warps;
  *first = per * w + (w < extra ? w : extra);
  *count = per + (w < extra ? 1 : 0);
}

}  // namespace wft
