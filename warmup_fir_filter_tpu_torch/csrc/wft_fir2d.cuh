// Cores of kernels E and F (fir2d_frame.cu) and G (fir2d_bf16.cu).
//
// Like wft_window.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every work item of the three kernels with a warp's
// lanes as one unit (wft_band_mma.cuh), in a host loop, and hold the frames
// against the plain PyTorch versions.
//
// All three are band products on the tensor cores over the same work items:
// kOframeRows frame rows of one 128-column frame tile, in CTAs of 4 warps,
// each warp an m16 tile of rows by one half (64 lanes) of the tile, with
// M = rows, N = lanes and K = the staged columns; the source rows of up to
// kOframeChunk tap rows are staged at a time, so any number of tap rows
// fits; each item's output bytes go out through a shared-memory tile.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "wft_band_mma.cuh"
#include "wft_fixed.cuh"

namespace wft {

constexpr int kLane = 128;                 // columns of a frame tile
constexpr int kFir2dPlaneFields = 2;       // tap row, exponent
constexpr int kFir2dMaxTapsC = 2 * kLane + 1;  // fir_mxu.py MAX_TAPS
constexpr int kFir2dMaxOverlap = 96;           // OFRAME_MAX_OVERLAP

struct Fir2dGeometry {
  long long hp, wp;        // frame rows and columns, wp a multiple of 128
  int t0, core_h, core_w;  // the image: rows [t0, t0 + core_h), core_w columns
  int taps_r, taps_c;
};

// The frame row that output row R reads at tap row kr is
// q = R + taps_r / 2 - kr.  The TPU kernels read the rows around a row block
// as two t0-row operands whose block index is clamped at the frame's edges,
// so q < 0 reads row q + t0 and q >= hp reads q - t0 (only pad rows, which
// the row mask zeroes, do so in a frame from pad_frame()).
WFT_INLINE long long fir2d_source_row(long long q, int t0, long long hp) {
  return q < 0 ? q + t0 : q >= hp ? q - t0 : q;
}

WFT_INLINE bool fir2d_core_row(const Fir2dGeometry& g, long long row) {
  return row >= g.t0 && row < g.t0 + g.core_h;
}

// K8's float epilogue (fir2d_mxu.py:1056-1058): floor(acc * 2^-fb + 0.5)
// clipped to [0, 255].  acc * scale is exact (a power of two times an
// integer-valued float), so contraction into an fma changes nothing.
WFT_INLINE uint8_t bf16_epilogue(float acc, float scale) {
  const float v = floorf(acc * scale + 0.5f);
  return static_cast<uint8_t>(v <= 0.0f ? 0.0f : v >= 255.0f ? 255.0f : v);
}

// ---------------------------------------------------------------------------
// Work items, staging and the output tile (kernels E, F and G)
// ---------------------------------------------------------------------------

// A work item: kOframeRows frame rows of one tile, a CTA's warps each an
// m16 row tile by one half (64 lanes) of the tile.  32 rows in CTAs of 4
// warps measured faster than 64 rows in CTAs of 8: more CTAs an SM, each
// barrier among fewer warps, for 7 halo rows staged every 32.
constexpr int kOframeRows = 32;
constexpr int kOframeWarps = 2 * kOframeRows / 16;
constexpr int kOframeThreads = kWarp * kOframeWarps;
constexpr int kOframeNTiles = 8;   // n8 lane tiles of a warp
constexpr int kOframeChunk = 8;    // tap rows whose source rows stage together
constexpr int kOframeStageRows = kOframeRows + kOframeChunk - 1;
// 16 padding bytes a staged row put the A words of a warp's 32 lanes in
// distinct banks (row stride 36 words).  Any stride of 16 x an odd number of
// bytes does: the 8 rows a fragment reads start 4 x an odd number of words
// apart, so in 8 distinct groups of 4 banks.
constexpr int kOframeRowBytes = kLane + 16;
constexpr int kOframeBufBytes = kOframeStageRows * kOframeRowBytes;
// The item's output bytes, kOframeRows rows of the same padded stride (the
// two-byte writes of a warp's lanes land in distinct banks).
constexpr int kOframeTileBytes = kOframeRows * kOframeRowBytes;
// Planes of one chunk: kOframeChunk tap rows of at most 5 digits.
constexpr int kOframeMaxChunkPlanes = 5 * kOframeChunk;
// A shifted copy of a plane's reversed digits: the B words w in
// [kOframeWord0, kOframeWord0 + kOframeCopyWords) cover rd bytes -38 ..
// Lc + 37 for Lc <= 97; 56 = 24 (mod 32) words put the four copies a warp
// reads in distinct banks.
constexpr int kOframeWord0 = -12;
constexpr int kOframeCopyWords = 56;
constexpr int kOframePlaneWords = 4 * kOframeCopyWords;

// Work item `item`: tile c and first row r0; whether its outputs are all
// zero (a pad tile, or rows that all lie outside the image).
struct OframeItem {
  long long c, r0;
  bool zero;
};

WFT_INLINE OframeItem oframe_item(const Fir2dGeometry& g, long long item) {
  const long long tiles = g.wp / kLane;
  OframeItem it;
  it.c = item % tiles;
  it.r0 = item / tiles * kOframeRows;
  it.zero = it.c == 0 || it.c == tiles - 1 || it.r0 + kOframeRows <= g.t0 ||
            it.r0 >= g.t0 + g.core_h;
  return it;
}

// The end of the chunk of planes starting at p0 (planes are in tap-row
// order, Fields ints a plane in the table, the tap row first): those within
// kOframeChunk tap rows of plane p0's, at most kOframeMaxChunkPlanes.
template <int Fields = kFir2dPlaneFields>
WFT_INLINE int oframe_chunk_end(const int* table, int planes, int p0) {
  const int k0 = table[Fields * p0];
  int p1 = p0;
  while (p1 < planes && table[Fields * p1] < k0 + kOframeChunk &&
         p1 - p0 < kOframeMaxChunkPlanes) {
    ++p1;
  }
  return p1;
}

// One thread's share of staging the source rows of tap rows [k0, k0 +
// kOframeChunk) for the item whose rows start at r0: staged row u holds
// `chunks` 16-byte chunks from frame column col0 of frame row
// fir2d_source_row(r0 + Lr/2 - (k0 + kOframeChunk - 1) + u), so output row
// r0 + m reads staged row m + k0 + kOframeChunk - 1 - kr at tap row kr.
// Chunks i = tid, tid + threads, ...: copied asynchronously from a 16-byte
// aligned frame (col0 a multiple of 16), byte by byte otherwise; a row
// outside the frame (no output reads it) is zeroed.
WFT_INLINE void stage_rows(uint8_t* buf, const uint8_t* x,
                           const Fir2dGeometry& g, long long col0, int chunks,
                           int row_bytes, long long r0, int k0, bool aligned,
                           int tid, int threads) {
  for (int i = tid; i < kOframeStageRows * chunks; i += threads) {
    const int u = i / chunks;
    const int part = 16 * (i - u * chunks);
    uint8_t* dst = buf + u * row_bytes + part;
    const long long q = fir2d_source_row(
        r0 + g.taps_r / 2 - (k0 + kOframeChunk - 1) + u, g.t0, g.hp);
    if (q < 0 || q >= g.hp) {
      zero16(dst);
      continue;
    }
    const uint8_t* src = x + q * g.wp + col0 + part;
    if (aligned) {
      copy16_async(dst, src);
    } else {
      for (int b = 0; b < 16; ++b) dst[b] = src[b];
    }
  }
}

// Kernels F and G stage the tile's own 128 columns.
WFT_INLINE void oframe_stage(uint8_t* buf, const uint8_t* x,
                             const Fir2dGeometry& g, long long c,
                             long long r0, int k0, bool aligned, int tid,
                             int threads) {
  stage_rows(buf, x, g, c * kLane, kLane / 16, kOframeRowBytes, r0, k0,
             aligned, tid, threads);
}

// Word i (< 4 * copy_words) of plane p's shifted digit copies: copy sigma
// holds, as word w - kOframeWord0, the reversed digits rd[4w - sigma ..
// 4w - sigma + 3], rd[q] = digit[Lc - 1 - q] (zero outside [0, Lc)).
WFT_INLINE uint32_t oframe_copy_word(const int8_t* digits, int taps_c, int p,
                                     int i, int copy_words) {
  const int sigma = i / copy_words;
  const int q0 = 4 * (i % copy_words + kOframeWord0) - sigma;
  const int8_t* d = digits + static_cast<long long>(p) * taps_c;
  uint32_t word = 0;
  for (int b = 0; b < 4; ++b) {
    const int q = q0 + b;
    const uint32_t v = q >= 0 && q < taps_c
                           ? static_cast<uint8_t>(d[taps_c - 1 - q])
                           : 0u;
    word |= v << (8 * b);
  }
  return word;
}

// One warp: the epilogue epi(raw value) of its lanes, 0 outside the image
// rows and for a zero item, into the item's shared-memory tile (two lanes a
// store).
template <typename Acc, typename Epilogue>
WFT_INLINE void oframe_tile(const Fir2dGeometry& g, const OframeItem& it,
                            int warp, Acc (*acc)[kLaneSlots][4],
                            const Epilogue& epi, uint8_t* tile) {
  const int mt = warp >> 1;
  const int h = warp & 1;
  WFT_LANES(l) {
    WFT_UNROLL
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * mt + (l >> 2) + 8 * half;
      const bool row_ok = !it.zero && fir2d_core_row(g, it.r0 + m);
      WFT_UNROLL
      for (int n = 0; n < kOframeNTiles; ++n) {
        uint32_t pair = 0;
        if (row_ok) {
          pair = epi(acc[n][WFT_SLOT(l)][2 * half]) |
                 static_cast<uint32_t>(epi(acc[n][WFT_SLOT(l)][2 * half + 1]))
                     << 8;
        }
        const int lane = 64 * h + 8 * n + 2 * (l & 3);
        *reinterpret_cast<uint16_t*>(tile + m * kOframeRowBytes + lane) =
            static_cast<uint16_t>(pair);
      }
    }
  }
}

// 16 bytes from shared src to dst, which is 16-byte aligned.
WFT_INLINE void store16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  std::memcpy(dst, src, 16);
#endif
}

// ---------------------------------------------------------------------------
// Kernel F: the overlapped frame (K7) on the int8 tensor cores
// ---------------------------------------------------------------------------
//
// As on the TPU (fir2d_mxu.py:635-742), tile c's raw accumulator is, for
// every kept (tap row kr, digit) plane, one aligned band product of the
// tile's own 128 columns of the frame rows shifted by kr:
//     raw[R, l] = bias + sum_p (sum_{j < 128} x~[R + Lr/2 - kr_p][128c + j]
//                                 * rd_p[j - l + left]) << e_p,
// rd_p the plane's reversed digits, so lanes [left, 128 - center) are exact
// and the boundary lanes partial.  Each warp takes only the k32 chunks that
// meet an n8 tile's band.  The TPU's patch (lane i < left of tile c takes
// raw lane i + stride of tile c - 1, lane i >= 128 - center raw lane
// i - stride of tile c + 1) is done by writing, not by reading: each item
// puts the epilogue of its raw lanes in a shared-memory tile
// (oframe_tile) and writes lanes [left, 128 - center) of it to its own
// tile, [stride, stride + left) to lanes [0, left) of tile c + 1 and
// [left, left + center) to lanes [128 - center, 128) of tile c - 1
// (oframe_write), each byte with its destination's masks, so every output
// byte is written once and no item stages a neighbour's columns.  Copying
// raw values gives the TPU's partial sums at Lc >= 87 byte for byte.

// Kernel F, one warp: adds planes [p0, p1) of the chunk at tap row k0 to
// acc (kOframeNTiles n8 tiles, lanes 64h + 8n' + ..), each plane's s32 sum
// (|s| <= 97 * 128 * 128 < 2^21) shifted by its exponent mod 2^32.  A(m, j)
// is staged row 16 mt + m + k0 + kOframeChunk - 1 - kr, column j, rebiased
// as it is read; B(j, l) = rd[j - l + left], word (p + sigma) / 4 of copy
// sigma = (g - left) & 3 for the fragment starting at rd byte
// p = 32 kc + 4t - 8 nt - g + left.  The copies of plane p start at
// dcopies + (p - pbase) * kOframePlaneWords.
WFT_INLINE void oframe_warp(const uint8_t* buf, const uint32_t* dcopies,
                            int pbase, const int* table, int p0, int p1,
                            int k0, int left, int center, int warp,
                            uint32_t (*acc)[kLaneSlots][4]) {
  constexpr uint32_t kRebias = 0x80808080u;
  const int mt = warp >> 1;
  const int h = warp & 1;
  // The columns the warp's half reads: its lanes' bands.
  const int j_lo = 64 * h - left > 0 ? 64 * h - left : 0;
  const int j_hi = 64 * h + 63 + center < kLane - 1 ? 64 * h + 63 + center
                                                     : kLane - 1;
  for (int p = p0; p < p1; ++p) {
    const int kr = table[kFir2dPlaneFields * p];
    const int e = table[kFir2dPlaneFields * p + 1];
    if (e < 0 || e >= 32) continue;  // nothing is left of it mod 2^32
    const int row0 = 16 * mt + k0 + kOframeChunk - 1 - kr;
    const uint32_t* dp = dcopies + (p - pbase) * kOframePlaneWords;
    // The fragment of (nt, kc) starts at rd byte 32 kc - 8 nt + q with
    // q = 4t - g + left, so its word is bl[8 kc - 2 nt] with one base a
    // lane: q + sigma is a multiple of 4.
    const uint32_t* bl[kLaneSlots];
    WFT_LANES(l) {
      const int g = l >> 2;
      const int sigma = (g - left) & 3;
      bl[WFT_SLOT(l)] = dp + sigma * kOframeCopyWords - kOframeWord0 +
                        (4 * (l & 3) - g + left + sigma) / 4;
    }
    uint32_t af[4][kLaneSlots][4];
    WFT_UNROLL
    for (int kc = 0; kc < 4; ++kc) {
      if (kc < j_lo >> 5 || kc > j_hi >> 5) continue;
      WFT_LANES(l) {
        const int i = WFT_SLOT(l);
        const int at = (row0 + (l >> 2)) * kOframeRowBytes + 32 * kc + 4 * (l & 3);
        af[kc][i][0] = shared_word(buf, at) ^ kRebias;
        af[kc][i][1] = shared_word(buf, at + 8 * kOframeRowBytes) ^ kRebias;
        af[kc][i][2] = shared_word(buf, at + 16) ^ kRebias;
        af[kc][i][3] = shared_word(buf, at + 8 * kOframeRowBytes + 16) ^ kRebias;
      }
    }
    WFT_UNROLL
    for (int n = 0; n < kOframeNTiles; ++n) {
      // Folded right after its MMAs, so one tile's sums are live at a time.
      int32_t s[kLaneSlots][4];
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) s[WFT_SLOT(l)][j] = 0;
      }
      // The n8 tile's band spans columns [8 nt - left, 8 nt + 7 + center].
      const int nt = 8 * h + n;
      const int lo = 8 * nt - left > 0 ? 8 * nt - left : 0;
      const int hi = 8 * nt + 7 + center < kLane - 1 ? 8 * nt + 7 + center
                                                     : kLane - 1;
      WFT_UNROLL
      for (int kc = 0; kc < 4; ++kc) {
        if (kc < lo >> 5 || kc > hi >> 5) continue;
        uint32_t bf[kLaneSlots][2];
        WFT_LANES(l) {
          const uint32_t* w = bl[WFT_SLOT(l)] + 8 * kc - 2 * nt;
          bf[WFT_SLOT(l)][0] = w[0];
          bf[WFT_SLOT(l)][1] = w[4];
        }
        mma_s8(s, af[kc], bf);
      }
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) {
          acc[n][WFT_SLOT(l)][j] += static_cast<uint32_t>(s[WFT_SLOT(l)][j])
                                    << e;
        }
      }
    }
  }
}

// Kernels F and G, one thread's share of writing the item's tile out: own
// lanes [left, 128 - center) of tile c (from lane 0 on tile 0, to lane 127
// on the last tile, which no neighbour writes) in 16-byte chunks, whole
// where the chunk is all own lanes inside the image columns and the output
// is 16-byte aligned (vec), byte by byte otherwise; then the patches: tile
// lanes [stride, stride + left) to lanes [0, left) of tile c + 1, tile
// lanes [left, left + center) to lanes [128 - center, 128) of tile c - 1.
// A byte is 0 where its destination lane lies outside the image columns
// or in a pad tile.
WFT_INLINE void oframe_write(const Fir2dGeometry& g, const OframeItem& it,
                             const uint8_t* tile, bool vec, uint8_t* y,
                             int tid, int threads) {
  const int center = g.taps_c / 2;
  const int left = g.taps_c - 1 - center;
  const int stride = kLane - (g.taps_c - 1);
  const long long tiles = g.wp / kLane;
  const long long rows_left = g.hp - it.r0;
  const int rows = rows_left < kOframeRows ? static_cast<int>(rows_left)
                                           : kOframeRows;
  const auto col = [&](long long d, int i) {
    return (d - 1) * stride - left + i;
  };
  const auto keep = [&](long long d, int i) {
    return d >= 1 && d <= tiles - 2 && col(d, i) >= 0 && col(d, i) < g.core_w;
  };
  const int own_lo = it.c == 0 ? 0 : left;
  const int own_hi = it.c == tiles - 1 ? kLane : kLane - center;
  for (int task = tid; task < rows * (kLane / 16); task += threads) {
    const int m = task / (kLane / 16);
    const int i0 = 16 * (task % (kLane / 16));
    const uint8_t* src = tile + m * kOframeRowBytes;
    uint8_t* dst = y + (it.r0 + m) * g.wp + it.c * kLane;
    if (vec && i0 >= own_lo && i0 + 16 <= own_hi && keep(it.c, i0) &&
        keep(it.c, i0 + 15)) {
      store16(dst + i0, src + i0);
      continue;
    }
    for (int i = i0; i < i0 + 16; ++i) {
      if (i >= own_lo && i < own_hi) dst[i] = keep(it.c, i) ? src[i] : 0;
    }
  }
  const int sides = left + center;
  for (int task = tid; task < rows * sides; task += threads) {
    const int m = task / sides;
    const int j = task % sides;
    long long d;
    int i, from;
    if (j < left) {
      d = it.c + 1;
      i = j;
      from = j + stride;
    } else {
      d = it.c - 1;
      i = kLane - center + (j - left);
      from = j;
    }
    if (d < 0 || d >= tiles) continue;
    y[(it.r0 + m) * g.wp + d * kLane + i] =
        keep(d, i) ? tile[m * kOframeRowBytes + from] : 0;
  }
}

// ---------------------------------------------------------------------------
// Kernel E: the plain frame (K6) on the int8 tensor cores
// ---------------------------------------------------------------------------
//
// Lane l of tile c is frame column lo + l, lo = 128c, and sums every tap
// (fir2d_mxu.py:224-266):
//     acc[R, l] = bias + sum_p (sum_k digit_p[k]
//                       * x~[R + Lr/2 - kr_p][lo + l + center - k]) << e_p,
// reading frame columns [lo + l - left, lo + l + center] through tiles
// c - 1, c and c + 1 (left, center <= 128).  An item stages its source
// rows' columns [lo - pre, lo + 128 + center), pre = left rounded up to 16,
// in whole aligned 16-byte chunks (eframe_stage); staged column s is frame
// column lo - pre + s, so lane l reads staged columns [l + s0, l + s0 + Lc),
// s0 = pre - left.  As one band product with K = the staged columns:
//     B(s, l) = rd[s - l - s0],
// F's reversed digits and shifted copies with -s0 in place of left; the n8
// tile nt's band is the Lc + 7 columns [8 nt + s0, 8 nt + s0 + Lc + 6], at
// most 10 k32 chunks (9 where s0 = 0, as at Lc = 257).  The TPU's split into
// a main band and two side bands (a_cur, a_prev, a_next) exists only for
// its 128-wide matrix unit: the sums mod 2^32 do not depend on their order.
// No patch: each item writes its tile's own 128 lanes (eframe_write).

struct EframeShape {
  int pre;         // staged columns before the tile: left rounded up to 16
  int s0;          // staged column of lane 0's last tap: pre - left
  int chunks;      // 16-byte chunks a staged row: through lo + 128 + center
  int row_bytes;   // staged row stride, 16 x odd, past the last k32 chunk
  int copy_words;  // words of one shifted copy of a plane's digits
};

WFT_INLINE EframeShape eframe_shape(int taps_c) {
  const int center = taps_c / 2;
  const int left = taps_c - 1 - center;
  EframeShape es;
  es.pre = (left + 15) / 16 * 16;
  es.s0 = es.pre - left;
  es.chunks = (es.pre + kLane + center + 15) / 16;
  // The last k32 chunk ends before column round_up(pre + 128 + center, 32);
  // its columns past the staged ones meet only zero digits.
  es.row_bytes = (es.pre + kLane + center + 31) / 32 * 32 + 16;
  // The B words a warp reads lie in [-9, (Lc + 37) / 4]: 8 x an odd number
  // of words a copy puts the four copies a warp reads in distinct banks.
  const int need = (taps_c + 37) / 4 + 1 - kOframeWord0;
  int eights = (need + 7) / 8;
  eights += 1 - (eights & 1);
  es.copy_words = 8 * eights;
  return es;
}

WFT_INLINE void eframe_stage(uint8_t* buf, const uint8_t* x,
                             const Fir2dGeometry& g, const EframeShape& es,
                             long long c, long long r0, int k0, bool aligned,
                             int tid, int threads) {
  stage_rows(buf, x, g, c * kLane - es.pre, es.chunks, es.row_bytes, r0, k0,
             aligned, tid, threads);
}

// Kernel E, one warp: adds planes [p0, p1) of the chunk at tap row k0 to
// acc, each plane's s32 sum (|s| <= 257 * 128 * 128 < 2^23) shifted by its
// exponent mod 2^32.  A(m, s) is staged row 16 mt + m + k0 + kOframeChunk -
// 1 - kr, column s, rebiased as it is read; the fragment of (nt, kc) starts
// at rd byte p = 32 kc + 4t - 8 nt - g - s0, word (p + sigma) / 4 of copy
// sigma = (g + s0) & 3.  Chunk by chunk over the warp's columns [64h + s0,
// 64h + 63 + s0 + Lc): one A fragment feeds every n8 tile whose band meets
// the chunk, and each tile's sums are folded after the plane's last chunk.
WFT_INLINE void eframe_warp(const uint8_t* buf, const EframeShape& es,
                            const uint32_t* dcopies, int pbase,
                            const int* table, int p0, int p1, int k0,
                            int taps_c, int warp,
                            uint32_t (*acc)[kLaneSlots][4]) {
  constexpr uint32_t kRebias = 0x80808080u;
  const int mt = warp >> 1;
  const int h = warp & 1;
  const int kc_lo = (64 * h + es.s0) >> 5;
  const int kc_hi = (64 * h + 63 + es.s0 + taps_c - 1) >> 5;
  for (int p = p0; p < p1; ++p) {
    const int kr = table[kFir2dPlaneFields * p];
    const int e = table[kFir2dPlaneFields * p + 1];
    if (e < 0 || e >= 32) continue;  // nothing is left of it mod 2^32
    const int row0 = 16 * mt + k0 + kOframeChunk - 1 - kr;
    const uint32_t* dp = dcopies + (p - pbase) * 4 * es.copy_words;
    const uint32_t* bl[kLaneSlots];
    int a_at[kLaneSlots];
    WFT_LANES(l) {
      const int g = l >> 2;
      const int sigma = (g + es.s0) & 3;
      bl[WFT_SLOT(l)] = dp + sigma * es.copy_words - kOframeWord0 +
                        (4 * (l & 3) - g - es.s0 + sigma) / 4 - 16 * h;
      a_at[WFT_SLOT(l)] = (row0 + g) * es.row_bytes + 4 * (l & 3);
    }
    int32_t s[kOframeNTiles][kLaneSlots][4];
    WFT_UNROLL
    for (int n = 0; n < kOframeNTiles; ++n) {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) s[n][WFT_SLOT(l)][j] = 0;
      }
    }
    for (int kc = kc_lo; kc <= kc_hi; ++kc) {
      uint32_t af[kLaneSlots][4];
      WFT_LANES(l) {
        const int at = a_at[WFT_SLOT(l)] + 32 * kc;
        af[WFT_SLOT(l)][0] = shared_word(buf, at) ^ kRebias;
        af[WFT_SLOT(l)][1] = shared_word(buf, at + 8 * es.row_bytes) ^ kRebias;
        af[WFT_SLOT(l)][2] = shared_word(buf, at + 16) ^ kRebias;
        af[WFT_SLOT(l)][3] =
            shared_word(buf, at + 8 * es.row_bytes + 16) ^ kRebias;
      }
      // Tile n meets the chunk where 8 (8h + n) lies in [32 kc - s0 - Lc -
      // 6, 32 kc - s0 + 31].
      const int first = 32 * kc - es.s0 - taps_c - 6 - 64 * h;
      const int last = 32 * kc - es.s0 + 31 - 64 * h;
      WFT_UNROLL
      for (int n = 0; n < kOframeNTiles; ++n) {
        if (8 * n < first || 8 * n > last) continue;
        uint32_t bf[kLaneSlots][2];
        WFT_LANES(l) {
          const uint32_t* w = bl[WFT_SLOT(l)] + 8 * kc - 2 * n;
          bf[WFT_SLOT(l)][0] = w[0];
          bf[WFT_SLOT(l)][1] = w[4];
        }
        mma_s8(s[n], af, bf);
      }
    }
    WFT_UNROLL
    for (int n = 0; n < kOframeNTiles; ++n) {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) {
          acc[n][WFT_SLOT(l)][j] +=
              static_cast<uint32_t>(s[n][WFT_SLOT(l)][j]) << e;
        }
      }
    }
  }
}

// Kernel E, one thread's share of writing the item's tile out: the tile's
// own 128 lanes in 16-byte chunks, whole where the output is 16-byte
// aligned (vec) and every lane of the chunk is kept, byte by byte
// otherwise.  A lane is 0 past the image's last column in the tile that
// column cuts (0 < limit < 128: K6's spill columns); pad tiles and rows
// outside the image are 0 in the tile already.
WFT_INLINE void eframe_write(const Fir2dGeometry& g, const OframeItem& it,
                             const uint8_t* tile, bool vec, uint8_t* y,
                             int tid, int threads) {
  const long long limit = kLane + g.core_w - it.c * kLane;
  const bool whole = limit <= 0 || limit >= kLane;
  const long long rows_left = g.hp - it.r0;
  const int rows = rows_left < kOframeRows ? static_cast<int>(rows_left)
                                           : kOframeRows;
  for (int task = tid; task < rows * (kLane / 16); task += threads) {
    const int m = task / (kLane / 16);
    const int i0 = 16 * (task % (kLane / 16));
    const uint8_t* src = tile + m * kOframeRowBytes;
    uint8_t* dst = y + (it.r0 + m) * g.wp + it.c * kLane;
    if (vec && (whole || i0 + 16 <= limit)) {
      store16(dst + i0, src + i0);
      continue;
    }
    for (int i = i0; i < i0 + 16; ++i) {
      dst[i] = whole || i < limit ? src[i] : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel G: the overlapped frame with bf16 taps (K8) on the bf16 tensor cores
// ---------------------------------------------------------------------------
//
// K8's product (fir2d_mxu.py:1000-1083): per nonzero tap row, one bf16 band
// product of the tile's own 128 columns, the samples widened to bf16 (every
// value 0-255 is exact) and the band B(j, l) = rr[j - l + left], rr the
// row's reversed taps as bf16, on mma.sync m16n8k16 with f32 sums; each row's
// product is its own f32 fragment, added to the running sum in tap-row
// order as the TPU kernel adds its per-row dots (fir2d_mxu.py:1047-1054);
// then K7's boundary patch (oframe_write) after the float epilogue.  Every
// product is exact, so where every partial sum is an integer below 2^24 the
// order inside a product changes nothing.  The samples are staged as bytes
// (oframe_stage, cp.async) and widened once into a second buffer
// (bf16_widen), so an A word is two consecutive samples.  Two copies of each
// row's reversed taps, shifted by one element, make each B word one aligned
// 32-bit shared load, as F's four byte-shifted copies of a plane's digits.

// A widened row: 128 bf16 samples and 16 bytes of padding (16 x 17 bytes:
// a warp's A words in distinct banks).
constexpr int kBf16RowBytes = 2 * kLane + 16;
constexpr int kBf16BufBytes = kOframeStageRows * kBf16RowBytes;
// A shifted copy of a tap row's reversed taps: the B words w in
// [kBf16Word0, kBf16Word0 + kBf16CopyWords) cover rr elements -24 .. 135
// (a warp reads -22 .. Lc + 21); 80 = 16 (mod 32) words put the two copies
// a warp reads in distinct banks.
constexpr int kBf16Word0 = -12;
constexpr int kBf16CopyWords = 80;
constexpr int kBf16RowWords = 2 * kBf16CopyWords;

// The bf16 bits of the four samples in the bytes of w, two a word, the
// lower sample in the lower half: a value 0-255 has at most 8 significant
// bits, so its float's upper half is its bf16.
WFT_INLINE void widen_bf16(uint32_t w, uint32_t* out) {
  WFT_UNROLL
  for (int i = 0; i < 2; ++i) {
    const uint32_t lo =
        float_bits(static_cast<float>((w >> (16 * i)) & 0xffu));
    const uint32_t hi =
        float_bits(static_cast<float>((w >> (16 * i + 8)) & 0xffu));
    out[i] = (lo >> 16) | (hi & 0xffff0000u);
  }
}

// One thread's share of widening the staged rows of buf (oframe_stage's
// layout) to bf16 in wide: each sample once, 8 bytes written for each 4
// read.
WFT_INLINE void bf16_widen(const uint8_t* buf, uint8_t* wide, int tid,
                           int threads) {
  for (int i = tid; i < kOframeStageRows * (kLane / 4); i += threads) {
    const int u = i / (kLane / 4);
    const int v = 4 * (i % (kLane / 4));
    uint32_t out[2];
    widen_bf16(shared_word(buf, u * kOframeRowBytes + v), out);
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(wide + u * kBf16RowBytes + 2 * v);
    dst[0] = out[0];
    dst[1] = out[1];
  }
}

// Word i (< kBf16RowWords) of tap row p's shifted copies: copy sigma holds,
// as word w - kBf16Word0, the reversed taps rr[2w - sigma] (low half) and
// rr[2w - sigma + 1] as bf16, rr[q] = row[Lc - 1 - q] (zero outside [0,
// Lc)).  The rows are bf16-exact floats, so each bf16 is a float's upper
// half.
WFT_INLINE uint32_t bf16_copy_word(const float* rows, int taps_c, int p,
                                   int i) {
  const int sigma = i / kBf16CopyWords;
  const int q0 = 2 * (i % kBf16CopyWords + kBf16Word0) - sigma;
  const float* r = rows + static_cast<long long>(p) * taps_c;
  uint32_t word = 0;
  for (int b = 0; b < 2; ++b) {
    const int q = q0 + b;
    const uint32_t v =
        q >= 0 && q < taps_c ? float_bits(r[taps_c - 1 - q]) >> 16 : 0u;
    word |= v << (16 * b);
  }
  return word;
}

// Kernel G, one warp: adds tap rows [p0, p1) of the chunk at tap row k0 to
// acc in order, each row's product first in its own f32 fragment.  A(m, j)
// is widened row 16 mt + m + k0 + kOframeChunk - 1 - kr, column j; the
// fragment of (nt, kc) starts at rr element p = 16 kc + 2t - 8 nt - g +
// left, word (p + sigma) / 2 of copy sigma = (left - g) & 1.  Chunk by chunk
// over the k16 chunks of the warp's columns, as eframe_warp.
WFT_INLINE void bf16_warp(const uint8_t* wide, const uint32_t* wcopies,
                          int pbase, const int* table, int p0, int p1, int k0,
                          int left, int center, int warp,
                          float (*acc)[kLaneSlots][4]) {
  const int mt = warp >> 1;
  const int h = warp & 1;
  const int j_lo = 64 * h - left > 0 ? 64 * h - left : 0;
  const int j_hi = 64 * h + 63 + center < kLane - 1 ? 64 * h + 63 + center
                                                     : kLane - 1;
  for (int p = p0; p < p1; ++p) {
    const int kr = table[p];
    const int row0 = 16 * mt + k0 + kOframeChunk - 1 - kr;
    const uint32_t* rp = wcopies + (p - pbase) * kBf16RowWords;
    const uint32_t* bl[kLaneSlots];
    int a_at[kLaneSlots];
    WFT_LANES(l) {
      const int g = l >> 2;
      const int sigma = (left - g) & 1;
      bl[WFT_SLOT(l)] = rp + sigma * kBf16CopyWords - kBf16Word0 +
                        (2 * (l & 3) - g + left + sigma) / 2 - 32 * h;
      a_at[WFT_SLOT(l)] = (row0 + g) * kBf16RowBytes + 4 * (l & 3);
    }
    float s[kOframeNTiles][kLaneSlots][4];
    WFT_UNROLL
    for (int n = 0; n < kOframeNTiles; ++n) {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) s[n][WFT_SLOT(l)][j] = 0.0f;
      }
    }
    for (int kc = j_lo >> 4; kc <= j_hi >> 4; ++kc) {
      uint32_t af[kLaneSlots][4];
      WFT_LANES(l) {
        const int at = a_at[WFT_SLOT(l)] + 32 * kc;
        af[WFT_SLOT(l)][0] = shared_word(wide, at);
        af[WFT_SLOT(l)][1] = shared_word(wide, at + 8 * kBf16RowBytes);
        af[WFT_SLOT(l)][2] = shared_word(wide, at + 16);
        af[WFT_SLOT(l)][3] = shared_word(wide, at + 8 * kBf16RowBytes + 16);
      }
      // Tile n's band, columns [8 nt - left, 8 nt + 7 + center], meets the
      // chunk where 8 (8h + n) lies in [16 kc - 7 - center, 16 kc + 15 +
      // left].
      const int first = 16 * kc - 7 - center - 64 * h;
      const int last = 16 * kc + 15 + left - 64 * h;
      WFT_UNROLL
      for (int n = 0; n < kOframeNTiles; ++n) {
        if (8 * n < first || 8 * n > last) continue;
        uint32_t bf[kLaneSlots][2];
        WFT_LANES(l) {
          const uint32_t* w = bl[WFT_SLOT(l)] + 8 * kc - 4 * n;
          bf[WFT_SLOT(l)][0] = w[0];
          bf[WFT_SLOT(l)][1] = w[4];
        }
        mma_bf16(s[n], af, bf);
      }
    }
    WFT_UNROLL
    for (int n = 0; n < kOframeNTiles; ++n) {
      WFT_LANES(l) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) {
          acc[n][WFT_SLOT(l)][j] += s[n][WFT_SLOT(l)][j];
        }
      }
    }
  }
}

}  // namespace wft
