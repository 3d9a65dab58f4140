// Per-thread cores of kernels E and F (fir2d_frame.cu) and G (fir2d_bf16.cu).
//
// Like wft_window.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every CTA and thread of the three kernels in a host
// loop and hold the frames against the plain PyTorch versions.
//
// A CTA owns kFir2dRows frame rows of one 128-column frame tile c, one
// thread per column (lane).  It stages, for up to kFir2dChunk tap rows at a
// time, the input rows those tap rows read from tiles c-1, c and c+1 (the
// "window") in shared memory; each thread then sums its lane over the taps
// of every plane of those tap rows.  Tall filters stream through the window
// chunk by chunk, so any number of tap rows fits.
#pragma once

#include <cmath>
#include <cstdint>

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

// Kernels E and F, one thread: adds the planes [p, ...) of the chunk at tap
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

// Kernels E and F, one thread: the epilogue and the masks of its lane i of
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

}  // namespace wft
