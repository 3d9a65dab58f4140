// Warp cores of kernel C (fir_window.cu) and kernel D (window_copy.cu).
//
// Like wft_fixed.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run kernel C's warp items with a warp's lanes as one
// unit (wft_band_mma.cuh emulates mma.sync from its fragment layout) and
// kernel D's chunks one by one, and hold the results against the plain
// PyTorch versions.
#pragma once

#include <climits>
#include <cstdint>

#include "wft_band_mma.cuh"
#include "wft_fixed.cuh"

namespace wft {

// Kernel C: a CTA of kWindowWarps warps, each working alone through its
// items; an item is kWindowCols output columns of one row, kWindowTiles
// m16 tiles of 16 eight-column sub-tiles each.
constexpr int kWindowWarps = 8;
constexpr int kWindowThreads = kWarp * kWindowWarps;
constexpr int kWindowTiles = 4;
constexpr int kWindowCols = 128 * kWindowTiles;
constexpr int kWindowMaxPlanes = 5;   // signed base-256 digits of an int32
constexpr int kWindowMaxTaps = 4096;  // fir_mxu.py MAX_TAPS_WINDOWED
// Fields of one plane's entry in the plane table.
constexpr int kPlaneExp = 0;     // accumulation shift
constexpr int kPlaneQuad0 = 1;   // first quad of reversed digits the plane reads
constexpr int kPlaneQuads = 2;   // quads in the plane's trimmed tap range
constexpr int kPlaneOffset = 3;  // first digit word of the plane
constexpr int kPlaneFields = 4;
// A-fragment words of a warp held in registers, indexed by v mod
// kWindowRing: chunk c of tile u reads v = 8u + 2c + {0, 1, 4, 5}, so
// 8 kWindowTiles - 2 consecutive words are live, and each chunk loads two.
constexpr int kWindowRing = 8 * kWindowTiles;
// Chunks a fully unrolled block walks: one turn of the ring.
constexpr int kWindowUnroll = kWindowRing / 2;

struct WindowPlane {
  int exp, a0, quads, offset;  // the plane table's fields
  int chunks;  // k32 chunks an 8-column sub-tile walks (0: a zero plane)
  int stride;  // words of one shifted copy of the digits, = 8 (mod 32)
  int base;    // first shared word of the plane's four copies
};

// What the kernel derives from the plane table: the planes, the shared
// words of their shifted digit copies, and the window of an item, the
// positions xs[j0, j1) where xs[j] is the sample at column col0 - left + j.
struct WindowLayout {
  int planes;
  WindowPlane plane[kWindowMaxPlanes];
  int copy_words;
  int j0, j1;
  int buf_bytes;  // one staging buffer, a multiple of 16
};

// Plane b reads its quads [a0, a0 + quads) of reversed digits, taps
// q in [4 a0, 4 (a0 + quads)).  An 8-column sub-tile's k range starts at
// 4 a0 - delta (delta <= 3 aligns the A words, see window_warp) and must
// reach past q + 7, hence chunks = ceil((4 quads + 10) / 32).  Its B words
// are w in [a0 - 2, a0 + 8 chunks), so a copy holds 8 chunks + 2 words,
// padded to 8 (mod 32) words, which puts the four copies of a lane group's
// loads in distinct shared-memory banks.
WFT_INLINE WindowLayout window_layout(const int* table, int planes) {
  WindowLayout lay;
  lay.planes = planes;
  lay.copy_words = 0;
  int j0 = INT_MAX;
  int j1 = INT_MIN;
  for (int b = 0; b < planes; ++b) {
    WindowPlane& pl = lay.plane[b];
    const int* t = table + b * kPlaneFields;
    pl.exp = t[kPlaneExp];
    pl.a0 = t[kPlaneQuad0];
    pl.quads = t[kPlaneQuads];
    pl.offset = t[kPlaneOffset];
    pl.chunks = pl.quads > 0 ? (4 * pl.quads + 10 + 31) / 32 : 0;
    pl.stride = 0;
    if (pl.chunks > 0) {
      const int words = 8 * pl.chunks + 2;
      pl.stride = words + ((8 - words % 32) + 32) % 32;
      const int lo = 4 * pl.a0 - 4;
      const int hi = 4 * pl.a0 + 32 * pl.chunks + kWindowCols - 8;
      j0 = lo < j0 ? lo : j0;
      j1 = hi > j1 ? hi : j1;
    }
    pl.base = lay.copy_words;
    lay.copy_words += 4 * pl.stride;
  }
  if (j1 < j0) j0 = j1 = 0;  // no plane reads a sample
  lay.j0 = j0;
  lay.j1 = j1;
  // xs[j] lands at byte off + j - j0 with off < 16.
  lay.buf_bytes = j1 > j0 ? ((j1 - j0 + 30) >> 4) << 4 : 0;
  return lay;
}

// Word i of the shared digit copies: copy sigma of plane b holds, as word
// L, the reversed digits rd[4w - sigma .. 4w - sigma + 3] with
// w = a0 - 2 + L (zero outside the plane's quads).
WFT_INLINE uint32_t window_copy_word(const uint32_t* digits,
                                     const WindowLayout& lay, int i) {
  int b = 0;
  while (b + 1 < lay.planes && i >= lay.plane[b + 1].base) ++b;
  const WindowPlane& pl = lay.plane[b];
  const int local = i - pl.base;
  const int sigma = local / pl.stride;
  const int w = pl.a0 - 2 + local % pl.stride;
  const auto quad = [&](int a) {
    return a >= pl.a0 && a < pl.a0 + pl.quads ? digits[pl.offset + a - pl.a0]
                                               : 0u;
  };
  return band_copy_word(quad(w - 1), quad(w), sigma);
}

// Kernel C, one lane's share of staging an item's window into buf: the
// row's aligned 16-byte chunks lane, lane + 32, ...  A chunk inside the row
// copies whole and asynchronously; one outside it is zeroed (u8 0 rebiases
// to -128, the TPU's zero pad); one the row's ends cut is copied byte by
// byte.  Nothing outside the row is read.  xs[j] lands at byte
// off + j - j0 of buf, off the address of xs[j0] mod 16, which this
// returns: the row's chunks are aligned in buf as in device memory.
WFT_INLINE int window_stage(uint8_t* buf, const uint8_t* x, long long n,
                            long long r, long long col0, int left,
                            const WindowLayout& lay, int lane) {
  const long long first = col0 - left + lay.j0;  // row column of xs[j0]
  const int off = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(r * n + first)) &
      15u);
  const long long m0 = first - off;  // row column of buf[0]
  if (lay.j1 <= lay.j0) return off;
  const int chunks = (off + lay.j1 - lay.j0 + 15) >> 4;
  const uint8_t* row = x + r * n;
  for (int k = lane; k < chunks; k += kWarp) {
    const long long m = m0 + 16LL * k;
    uint8_t* dst = buf + 16 * k;
    if (m >= 0 && m + 16 <= n) {
      copy16_async(dst, row + m);
    } else if (m + 16 <= 0 || m >= n) {
      zero16(dst);
    } else {
      for (int i = 0; i < 16; ++i) {
        dst[i] = m + i >= 0 && m + i < n ? row[m + i] : 0;
      }
    }
  }
  return off;
}

// Kernel C, one warp item: outputs col0 + [0, kWindowCols) of row r from
// the staged window buf.
//
// With the taps reversed (rd[q] = digit[taps - 1 - q]) the same-mode sum of
// a plane is the correlation  s(i) = sum_q rd[q] xs[i + q]: K3's window
// matmul against its Toeplitz band (fir_mxu.py:691-751).  Here M indexes
// 8-column sub-tiles, so m16 tile u of the item is
//     D[m, i] = sum_k A[m, k] B[k, i],  A[m, k] = xs[128u + 8m + k],
//     B[k, i] = rd[k - i],
// over k32 chunks from kb0 = 4 a0 - delta.  delta = off & 3 makes every A
// word aligned in shared memory: A(m, 4t..) of chunk c is the word
// R(v) = xs[kb0 + 8g + 4t + 16v] with v = 8u + 2c (+4 for row m + 8, +1
// for k + 16), so a chunk of all four tiles needs two new words a lane,
// kept in a ring of registers.  The B words come from the plane's shifted
// digit copies (window_layout): B(4t.., g) of chunk c starts at rd byte
// p = kb0 + 32c + 4t - g, word a0 + 8c + t - ((g + delta) >> 2) of copy
// (g + delta) & 3.  Samples are rebiased (x ^ 0x80) as the words are read.
// Each plane's s32 sums are exact (|s| <= 4096 * 128 * 128 = 2^26) and
// fold into the uint32 accumulator mod 2^32 shifted by the plane's
// exponent; a shift of 32 or more leaves nothing.
//
// window_warp is three parts: the accumulators start at the bias
// (window_start), the planes' sums fold in (window_accumulate), the
// epilogue writes the bytes (window_epilogue).  Kernel B runs the middle
// part once per tap chunk on accumulators it keeps across the chunks.
// A lane's accumulators: D fragment j of m16 tile u, for each lane slot.
using WindowAcc = uint32_t[kWindowTiles][kLaneSlots][4];

WFT_INLINE void window_start(WindowAcc& acc, uint32_t bias) {
  WFT_LANES(l) {
    WFT_UNROLL
    for (int u = 0; u < kWindowTiles; ++u) {
      WFT_UNROLL
      for (int j = 0; j < 4; ++j) acc[u][WFT_SLOT(l)][j] = bias;
    }
  }
}

WFT_INLINE void window_accumulate(const uint8_t* buf, int off,
                                  const uint32_t* ds, const WindowLayout& lay,
                                  WindowAcc& acc) {
  constexpr uint32_t kRebias = 0x80808080u;
  const int delta = off & 3;
  for (int b = 0; b < lay.planes; ++b) {
    const WindowPlane& pl = lay.plane[b];
    if (pl.chunks == 0 || pl.exp >= 32) continue;
    int32_t s[kWindowTiles][kLaneSlots][4];
    uint32_t ring[kLaneSlots][kWindowRing];
    int a_at[kLaneSlots];
    const uint32_t* bw[kLaneSlots];
    WFT_LANES(l) {
      const int i = WFT_SLOT(l);
      const int g = l >> 2;
      const int t = l & 3;
      const int h = g + delta;
      a_at[i] = off + 4 * pl.a0 - delta - lay.j0 + 8 * g + 4 * t;
      bw[i] = ds + pl.base + (h & 3) * pl.stride + t - (h >> 2) + 2;
      WFT_UNROLL
      for (int u = 0; u < kWindowTiles; ++u) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) s[u][i][j] = 0;
      }
      WFT_UNROLL
      for (int v = 0; v < kWindowRing - 4; ++v) {
        ring[i][v] = shared_word(buf, a_at[i] + 16 * v) ^ kRebias;
      }
    }
    // Chunk c, cc = c mod kWindowUnroll: the ring slots stay compile-time
    // constants in the unrolled loops below.
    const auto chunk = [&](int cc, int c) {
      constexpr int kNew = kWindowRing - 4;  // first word chunk 0 loads
      uint32_t bf[kLaneSlots][2];
      WFT_LANES(l) {
        const int i = WFT_SLOT(l);
        ring[i][(2 * cc + kNew) % kWindowRing] =
            shared_word(buf, a_at[i] + 16 * (2 * c + kNew)) ^ kRebias;
        ring[i][(2 * cc + kNew + 1) % kWindowRing] =
            shared_word(buf, a_at[i] + 16 * (2 * c + kNew + 1)) ^ kRebias;
        bf[i][0] = bw[i][8 * c];
        bf[i][1] = bw[i][8 * c + 4];
      }
      WFT_UNROLL
      for (int u = 0; u < kWindowTiles; ++u) {
        uint32_t af[kLaneSlots][4];
        WFT_LANES(l) {
          const int i = WFT_SLOT(l);
          af[i][0] = ring[i][(8 * u + 2 * cc) % kWindowRing];
          af[i][1] = ring[i][(8 * u + 2 * cc + 4) % kWindowRing];
          af[i][2] = ring[i][(8 * u + 2 * cc + 1) % kWindowRing];
          af[i][3] = ring[i][(8 * u + 2 * cc + 5) % kWindowRing];
        }
        mma_s8(s[u], af, bf);
      }
    };
    for (int c0 = 0; c0 < pl.chunks; c0 += kWindowUnroll) {
      if (c0 + kWindowUnroll <= pl.chunks) {
        WFT_UNROLL
        for (int cc = 0; cc < kWindowUnroll; ++cc) chunk(cc, c0 + cc);
      } else {
        WFT_UNROLL
        for (int cc = 0; cc < kWindowUnroll; ++cc) {
          if (c0 + cc < pl.chunks) chunk(cc, c0 + cc);
        }
      }
    }
    WFT_LANES(l) {
      WFT_UNROLL
      for (int u = 0; u < kWindowTiles; ++u) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) {
          acc[u][WFT_SLOT(l)][j] +=
              static_cast<uint32_t>(s[u][WFT_SLOT(l)][j]) << pl.exp;
        }
      }
    }
  }
}

// Outputs col0 + [0, kWindowCols) of row r from the accumulators.
WFT_INLINE void window_epilogue(const WindowAcc& acc, bool wrap,
                                int frac_bits, int acc_bits, uint8_t* y,
                                long long r, long long n, long long col0) {
  uint8_t* out = y + r * n;
  WFT_LANES(l) {
    const int g = l >> 2;
    const int t = l & 3;
    WFT_UNROLL
    for (int u = 0; u < kWindowTiles; ++u) {
      WFT_UNROLL
      for (int j = 0; j < 4; ++j) {
        const long long col =
            col0 + 128 * u + 8 * (g + 8 * (j >> 1)) + 2 * t + (j & 1);
        if (col < n) {
          out[col] = fixed_epilogue(acc[u][WFT_SLOT(l)][j], wrap, frac_bits,
                                    acc_bits);
        }
      }
    }
  }
}

WFT_INLINE void window_warp(const uint8_t* buf, int off, const uint32_t* ds,
                            const WindowLayout& lay, uint32_t bias,
                            bool wrap, int frac_bits, int acc_bits,
                            uint8_t* y, long long r, long long n,
                            long long col0) {
  WindowAcc acc;
  window_start(acc, bias);
  window_accumulate(buf, off, ds, lay, acc);
  window_epilogue(acc, wrap, frac_bits, acc_bits, y, r, n, col0);
}

// Kernel B's long route (fir_direct.cu): kernel C's warp core walked over
// chunks of the reversed taps.  Chunk c holds rd[q0 + q'] for q' below its
// length (q0 = c times the chunk length, at most kWindowMaxTaps, so that a
// chunk's plane sums stay exact in s32); its share of output column col is
// C's correlation over the window xs_c[j] = x~[col - left + q0 + j], so a
// chunk is C's item with the halo left - q0 and a plane table of its own,
// each plane trimmed to its nonzero quads within the chunk.  The host
// builds each chunk's shifted digit copies in window_layout's shared layout
// (kernels/fir_direct.py::chunk_operands), so a CTA stages them with
// cp.async; the chunks' sums fold into the accumulators mod 2^32, which is
// associative, so the chunking changes no byte.
//
// A chunk's row of the chunk table: its first copy word (a multiple of 4),
// q0, then kPlaneFields ints a plane (exponent, first quad, quads, 0).
constexpr int kChunkCopyAt = 0;
constexpr int kChunkQ0 = 1;
constexpr int kChunkPlanes = 2;

WFT_INLINE int chunk_fields(int planes) {
  return kChunkPlanes + kPlaneFields * planes;
}

struct DirectChunk {
  WindowLayout lay;
  int copy_at;  // first word of the chunk's copies
  int q0;       // first reversed tap of the chunk
};

WFT_INLINE DirectChunk direct_chunk(const int* table, int planes, int c) {
  const int* row = table + c * chunk_fields(planes);
  DirectChunk ch;
  ch.lay = window_layout(row + kChunkPlanes, planes);
  ch.copy_at = row[kChunkCopyAt];
  ch.q0 = row[kChunkQ0];
  return ch;
}

// Thread t of `threads`: the chunk's copy words into ds, 16 bytes at a time
// by cp.async (copy_words is a multiple of 4: each plane's 4 * stride).
WFT_INLINE void direct_stage_copies(uint32_t* ds, const uint32_t* copies,
                                    const DirectChunk& ch, int t,
                                    int threads) {
  for (int i = t; i < ch.lay.copy_words / 4; i += threads) {
    copy16_async(reinterpret_cast<uint8_t*>(ds + 4 * i),
                 reinterpret_cast<const uint8_t*>(copies + ch.copy_at + 4 * i));
  }
}

// Kernel D, one 16-byte chunk: chunk k of output row `row` (window
// r = row / channels of channel c = row % channels) holds columns
// r*sub - 128 + 16k .. +15 of the virtual stream carry_ext || x || zeros.
// sub and total are multiples of 16, so a chunk never straddles two of the
// three parts.  Returns the chunk's source, or nullptr where it is zeros.
WFT_INLINE const uint8_t* window_chunk_source(const uint8_t* x,
                                              const uint8_t* carry_ext,
                                              long long channels,
                                              long long total, long long sub,
                                              long long row, long long k) {
  const long long r = row / channels;
  const long long c = row % channels;
  const long long col = r * sub - 128 + 16 * k;
  if (col < 0) return carry_ext + c * 128 + (col + 128);
  if (col < total) return x + c * total + col;
  return nullptr;
}

}  // namespace wft
