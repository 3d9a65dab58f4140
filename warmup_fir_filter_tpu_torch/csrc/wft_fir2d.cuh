// Cores of kernels E and F (fir2d_frame.cu) and G (fir2d_bf16.cu).
//
// Like wft_window.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every CTA and thread of kernels E and G, and every
// work item of kernel F with a warp's lanes as one unit, in a host loop and
// hold the frames against the plain PyTorch versions.
//
// Kernels E and G: a CTA owns kFir2dRows frame rows of one 128-column frame
// tile c, one thread per column (lane).  It stages, for up to kFir2dChunk tap rows at a
// time, the input rows those tap rows read from tiles c-1, c and c+1 (the
// "window") in shared memory; each thread then sums its lane over the taps
// of every plane of those tap rows.  Tall filters stream through the window
// chunk by chunk, so any number of tap rows fits.
#pragma once

#include <cmath>
#include <cstdint>

#include "wft_band_mma.cuh"
#include "wft_fixed.cuh"

namespace wft {

constexpr int kLane = 128;       // columns of a frame tile: one thread each
constexpr int kFir2dRows = 16;   // frame rows a CTA computes
constexpr int kFir2dChunk = 16;  // tap rows whose input rows are staged at once
constexpr int kFir2dWinRows = kFir2dRows + kFir2dChunk - 1;
constexpr int kFir2dWinCols = 3 * kLane;  // tiles c-1, c and c+1
constexpr int kFir2dPlaneFields = 2;      // tap row, exponent
constexpr int kFir2dMaxTapsC = 2 * kLane + 1;      // fir_mxu.py MAX_TAPS
constexpr int kFir2dMaxOverlap = 96;               // OFRAME_MAX_OVERLAP

struct Fir2dGeometry {
  long long hp, wp;        // frame rows and columns, wp a multiple of 128
  int t0, core_h, core_w;  // the image: rows [t0, t0 + core_h), core_w columns
  int taps_r, taps_c;
  int overlap;  // 0: the plain frame (K6); 1: the overlapped frame (K7, K8)
};

// The frame row that output row R reads at tap row kr is
// q = R + taps_r / 2 - kr.  The TPU kernels read the rows around a row block
// as two t0-row operands whose block index is clamped at the frame's edges,
// so q < 0 reads row q + t0 and q >= hp reads q - t0 (only pad rows, which
// the row mask zeroes, do so in a frame from pad_frame()).
WFT_INLINE long long fir2d_source_row(long long q, int t0, long long hp) {
  return q < 0 ? q + t0 : q >= hp ? q - t0 : q;
}

// Window row u of the chunk starting at tap row k0 holds frame row
// fir2d_source_row(r0 + taps_r / 2 - (k0 + kFir2dChunk - 1) + u), so output
// row r0 + r reads window row r + (k0 + kFir2dChunk - 1 - kr) at tap row kr.
// Returns the frame bytes of tiles c-1 .. c+1 of that row, or nullptr where
// the row lies outside the frame (no output reads it).
WFT_INLINE const uint8_t* fir2d_window_row(const uint8_t* x,
                                           const Fir2dGeometry& g,
                                           long long c, long long r0, int k0,
                                           int u) {
  const long long q = fir2d_source_row(
      r0 + g.taps_r / 2 - (k0 + kFir2dChunk - 1) + u, g.t0, g.hp);
  if (q < 0 || q >= g.hp) return nullptr;
  return x + q * g.wp + (c - 1) * kLane;
}

// What one lane of an interior tile c sums and whether it is kept.
struct Fir2dLane {
  int col;         // window column of tap k = 0; tap k reads column col - k
  int k_lo, k_hi;  // the taps it sums
  bool zero;       // its source is a pad tile: the TPU kernel's zero accumulator
  bool keep;       // inside the image columns (the row mask is separate)
};

// Plain frame (K6, fir2d_mxu.py:224-266): lane i is frame column
// c*128 + i and sums every tap, reading columns [i - left, i + center]
// around it through the three tiles.  Only a tile that the image's last
// column cuts (0 < limit < 128) masks its spill columns.
//
// Overlapped frame (K7, fir2d_mxu.py:635-742): tile c's one aligned band
// gives lane l the sum over the taps that stay inside tile c, which is the
// whole sum for l in [left, 128 - center).  The boundary lanes are patched
// from the neighbours: lane i < left takes lane i + stride of tile c-1, lane
// i >= 128 - center lane i - stride of tile c+1, each with only the taps
// inside that tile (for taps_c >= 87 these are partial sums, as on the TPU).
// Lane i is image column (c-1)*stride - left + i.
WFT_INLINE Fir2dLane fir2d_lane(const Fir2dGeometry& g, long long c, int i) {
  const int center = g.taps_c / 2;
  const int left = g.taps_c - 1 - center;
  Fir2dLane s;
  if (!g.overlap) {
    s.col = kLane + i + center;
    s.k_lo = 0;
    s.k_hi = g.taps_c - 1;
    s.zero = false;
    const long long limit = kLane + g.core_w - c * kLane;
    s.keep = limit <= 0 || limit >= kLane || i < limit;
    return s;
  }
  const int stride = kLane - (g.taps_c - 1);
  int tile = 0;  // source tile relative to c
  int l = i;     // source lane
  if (left && i < left) {
    tile = -1;
    l = i + stride;
  } else if (center && i >= kLane - center) {
    tile = 1;
    l = i - stride;
  }
  s.col = (1 + tile) * kLane + l + center;
  const int lo = l + center - (kLane - 1);
  s.k_lo = lo > 0 ? lo : 0;
  s.k_hi = l + center < g.taps_c - 1 ? l + center : g.taps_c - 1;
  s.zero = c + tile == 0 || c + tile == g.wp / kLane - 1;
  const long long col = (c - 1) * stride - left + i;
  s.keep = col >= 0 && col < g.core_w;
  return s;
}

WFT_INLINE bool fir2d_core_row(const Fir2dGeometry& g, long long row) {
  return row >= g.t0 && row < g.t0 + g.core_h;
}

// Whether every output of the CTA (c, r0) is zero: a pad tile, or rows
// that all lie outside the image.
WFT_INLINE bool fir2d_cta_is_zero(const Fir2dGeometry& g, long long c,
                                  long long r0) {
  return c == 0 || c == g.wp / kLane - 1 || r0 + kFir2dRows <= g.t0 ||
         r0 >= g.t0 + g.core_h;
}

WFT_INLINE void fir2d_store_zero(const Fir2dGeometry& g, uint8_t* y,
                                 long long c, long long r0, int i) {
  for (int r = 0; r < kFir2dRows && r0 + r < g.hp; ++r) {
    y[(r0 + r) * g.wp + c * kLane + i] = 0;
  }
}

// Kernel E, one thread: adds the planes [p, ...) of the chunk at tap
// row k0 (planes are in tap-row order) to acc, each plane's int32 sum
// shifted by its exponent, mod 2^32.  Returns the first plane of the next
// chunk.
//   xs      the window, kFir2dWinRows rows of kFir2dWinCols u8
//   digits  planes rows of taps_c int8 digits
//   table   kFir2dPlaneFields ints a plane: tap row, exponent
WFT_INLINE int fir2d_int_planes(const uint8_t* xs, const Fir2dLane& s,
                                const int8_t* digits, const int* table,
                                int planes, int p, int k0, int taps_c,
                                uint32_t* acc) {
  for (; p < planes; ++p) {
    const int kr = table[kFir2dPlaneFields * p];
    const int e = table[kFir2dPlaneFields * p + 1];
    if (kr < k0 || kr >= k0 + kFir2dChunk) break;
    const int8_t* d = digits + static_cast<long long>(p) * taps_c;
    const uint8_t* xr = xs + (k0 + kFir2dChunk - 1 - kr) * kFir2dWinCols + s.col;
    int32_t sum[kFir2dRows];  // |sum| <= 257 * 128 * 128 < 2^23
    WFT_UNROLL
    for (int r = 0; r < kFir2dRows; ++r) sum[r] = 0;
    for (int k = s.k_lo; k <= s.k_hi; ++k) {
      const int32_t dk = d[k];
      WFT_UNROLL
      for (int r = 0; r < kFir2dRows; ++r) {
        // x ^ 0x80 as int8 is x - 128.
        sum[r] += dk * (static_cast<int32_t>(xr[r * kFir2dWinCols - k]) - 128);
      }
    }
    // A shift of 32 or more leaves nothing mod 2^32 (and is UB in C++).
    if (e >= 0 && e < 32) {
      WFT_UNROLL
      for (int r = 0; r < kFir2dRows; ++r) {
        acc[r] += static_cast<uint32_t>(sum[r]) << e;
      }
    }
  }
  return p;
}

// Kernel E, one thread: the epilogue and the masks of its lane i of
// rows r0 .. r0 + kFir2dRows - 1 of tile c.
WFT_INLINE void fir2d_int_store(const Fir2dGeometry& g, const Fir2dLane& s,
                                const uint32_t* acc, bool wrap, int frac_bits,
                                int acc_bits, uint8_t* y, long long c,
                                long long r0, int i) {
  // Unrolled with a guard, not a break, so acc stays in registers.
  WFT_UNROLL
  for (int r = 0; r < kFir2dRows; ++r) {
    if (r0 + r < g.hp) {
      // A zero accumulator's epilogue is 0 on either path.
      const bool keep = s.keep && !s.zero && fir2d_core_row(g, r0 + r);
      y[(r0 + r) * g.wp + c * kLane + i] =
          keep ? fixed_epilogue(acc[r], wrap, frac_bits, acc_bits) : 0;
    }
  }
}

// Kernel G, one thread: adds the tap rows [p, ...) of the chunk at k0 to
// acc, each row's f32 sum first, as K8 adds one band product per row.
// Products of a bf16 tap and a u8 sample are exact in f32, so a fused
// multiply-add gives the same sums as a multiply and an add.
//   w      rows of taps_c f32 values (bf16-exact)
//   table  the tap row of each
WFT_INLINE int fir2d_bf16_rows(const uint8_t* xs, const Fir2dLane& s,
                               const float* w, const int* table, int rows,
                               int p, int k0, int taps_c, float* acc) {
  for (; p < rows; ++p) {
    const int kr = table[p];
    if (kr < k0 || kr >= k0 + kFir2dChunk) break;
    const float* wr = w + static_cast<long long>(p) * taps_c;
    const uint8_t* xr = xs + (k0 + kFir2dChunk - 1 - kr) * kFir2dWinCols + s.col;
    float sum[kFir2dRows];
    WFT_UNROLL
    for (int r = 0; r < kFir2dRows; ++r) sum[r] = 0.0f;
    for (int k = s.k_lo; k <= s.k_hi; ++k) {
      const float wk = wr[k];
      WFT_UNROLL
      for (int r = 0; r < kFir2dRows; ++r) {
        sum[r] += wk * static_cast<float>(xr[r * kFir2dWinCols - k]);
      }
    }
    WFT_UNROLL
    for (int r = 0; r < kFir2dRows; ++r) acc[r] += sum[r];
  }
  return p;
}

// K8's float epilogue (fir2d_mxu.py:1056-1058): floor(acc * 2^-fb + 0.5)
// clipped to [0, 255].  acc * scale is exact (a power of two times an
// integer-valued float), so contraction into an fma changes nothing.
WFT_INLINE uint8_t bf16_epilogue(float acc, float scale) {
  const float v = floorf(acc * scale + 0.5f);
  return static_cast<uint8_t>(v <= 0.0f ? 0.0f : v >= 255.0f ? 255.0f : v);
}

WFT_INLINE void fir2d_bf16_store(const Fir2dGeometry& g, const Fir2dLane& s,
                                 const float* acc, float scale, uint8_t* y,
                                 long long c, long long r0, int i) {
  WFT_UNROLL
  for (int r = 0; r < kFir2dRows; ++r) {
    if (r0 + r < g.hp) {
      const bool keep = s.keep && !s.zero && fir2d_core_row(g, r0 + r);
      y[(r0 + r) * g.wp + c * kLane + i] =
          keep ? bf16_epilogue(acc[r], scale) : 0;
    }
  }
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
// and the boundary lanes partial.  A work item is kOframeRows frame rows of
// one tile, each warp an m16 tile of rows by 64 lanes (8 n8 tiles), with
// M = rows, N = lanes and K = the tile's columns, only the k32 chunks that
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
// distinct banks (row stride 36 words).
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
// order): those within kOframeChunk tap rows of plane p0's, at most
// kOframeMaxChunkPlanes.
WFT_INLINE int oframe_chunk_end(const int* table, int planes, int p0) {
  const int k0 = table[kFir2dPlaneFields * p0];
  int p1 = p0;
  while (p1 < planes && table[kFir2dPlaneFields * p1] < k0 + kOframeChunk &&
         p1 - p0 < kOframeMaxChunkPlanes) {
    ++p1;
  }
  return p1;
}

// One thread's share of staging the source rows of tap rows [k0, k0 +
// kOframeChunk) for the item at (c, r0): staged row u holds the 128 columns
// of tile c of frame row fir2d_source_row(r0 + Lr/2 - (k0 + kOframeChunk -
// 1) + u), so output row r0 + m reads staged row m + k0 + kOframeChunk - 1
// - kr at tap row kr.  16-byte chunks i = tid, tid + threads, ...: copied
// asynchronously from a 16-byte aligned frame, byte by byte otherwise; a
// row outside the frame (no output reads it) is zeroed.
WFT_INLINE void oframe_stage(uint8_t* buf, const uint8_t* x,
                             const Fir2dGeometry& g, long long c,
                             long long r0, int k0, bool aligned, int tid,
                             int threads) {
  for (int i = tid; i < kOframeStageRows * (kLane / 16); i += threads) {
    const int u = i / (kLane / 16);
    const int part = 16 * (i % (kLane / 16));
    uint8_t* dst = buf + u * kOframeRowBytes + part;
    const long long q = fir2d_source_row(
        r0 + g.taps_r / 2 - (k0 + kOframeChunk - 1) + u, g.t0, g.hp);
    if (q < 0 || q >= g.hp) {
      zero16(dst);
      continue;
    }
    const uint8_t* src = x + q * g.wp + c * kLane + part;
    if (aligned) {
      copy16_async(dst, src);
    } else {
      for (int b = 0; b < 16; ++b) dst[b] = src[b];
    }
  }
}

// Word i (< kOframePlaneWords) of plane p's shifted digit copies: copy
// sigma holds, as word w - kOframeWord0, the reversed digits rd[4w - sigma
// .. 4w - sigma + 3], rd[q] = digit[Lc - 1 - q] (zero outside [0, Lc)).
WFT_INLINE uint32_t oframe_copy_word(const int8_t* digits, int taps_c, int p,
                                     int i) {
  const int sigma = i / kOframeCopyWords;
  const int q0 = 4 * (i % kOframeCopyWords + kOframeWord0) - sigma;
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

// Kernel F, one warp: the epilogue of its raw values, 0 outside the
// image rows and for a zero item, into the item's shared-memory tile (two
// lanes a store).
WFT_INLINE void oframe_tile(const Fir2dGeometry& g, const OframeItem& it,
                            int warp, uint32_t (*acc)[kLaneSlots][4],
                            bool wrap, int frac_bits, int acc_bits,
                            uint8_t* tile) {
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
          pair = fixed_epilogue(acc[n][WFT_SLOT(l)][2 * half], wrap,
                                frac_bits, acc_bits) |
                 static_cast<uint32_t>(fixed_epilogue(
                     acc[n][WFT_SLOT(l)][2 * half + 1], wrap, frac_bits,
                     acc_bits)) << 8;
        }
        const int lane = 64 * h + 8 * n + 2 * (l & 3);
        *reinterpret_cast<uint16_t*>(tile + m * kOframeRowBytes + lane) =
            static_cast<uint16_t>(pair);
      }
    }
  }
}

// Kernel F, one thread's share of writing the item's tile out: own lanes
// [left, 128 - center) of tile c (from lane 0 on tile 0, to lane 127 on
// the last tile, which no neighbour writes) in 16-byte chunks, whole where
// the chunk is all own lanes inside the image columns and the output is
// 16-byte aligned (vec), byte by byte otherwise; then the patches: tile
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
#if defined(__CUDA_ARCH__)
      *reinterpret_cast<uint4*>(dst + i0) =
          *reinterpret_cast<const uint4*>(src + i0);
#else
      std::memcpy(dst + i0, src + i0, 16);
#endif
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

}  // namespace wft
