// Per-thread cores of kernel C (fir_window.cu) and kernel D (window_copy.cu).
//
// Like wft_fixed.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every CTA and thread of both kernels in a host loop
// and hold the result against the plain PyTorch versions.  On the device
// the two intrinsics below are __byte_perm and __dp4a; on the host they are
// emulated bit for bit.
#pragma once

#include <cstdint>

#include "wft_fixed.cuh"

namespace wft {

// Kernel C tile: each of kWindowThreads threads computes 4 adjacent output
// columns of kWindowRows rows.
constexpr int kWindowThreads = 128;
constexpr int kWindowCols = 4 * kWindowThreads;
constexpr int kWindowRows = 8;
constexpr int kWindowMaxPlanes = 5;   // signed base-256 digits of an int32
constexpr int kWindowMaxTaps = 4096;  // fir_mxu.py MAX_TAPS_WINDOWED
// Fields of one plane's entry in the plane table.
constexpr int kPlaneExp = 0;     // accumulation shift
constexpr int kPlaneQuad0 = 1;   // first window quad the plane reads
constexpr int kPlaneQuads = 2;   // quads in the plane's trimmed tap range
constexpr int kPlaneOffset = 3;  // first digit word of the plane
constexpr int kPlaneFields = 4;

// Bytes {y:x} selected by the nibbles of s (x = bytes 0-3, y = bytes 4-7).
WFT_INLINE uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) {
    const uint32_t sel = (s >> (4 * k)) & 7u;
    r |= static_cast<uint32_t>((v >> (8 * sel)) & 0xffu) << (8 * k);
  }
  return r;
#endif
}

// c + the dot product of the four signed bytes of a and b.
WFT_INLINE int32_t dp4a(uint32_t a, uint32_t b, int32_t c) {
#if defined(__CUDA_ARCH__)
  return __dp4a(static_cast<int>(a), static_cast<int>(b), c);
#else
  for (int k = 0; k < 4; ++k) {
    c += static_cast<int32_t>(static_cast<int8_t>(a >> (8 * k))) *
         static_cast<int32_t>(static_cast<int8_t>(b >> (8 * k)));
  }
  return c;
#endif
}

// Row words of kernel C's window: byte j of a row holds x~[col0 - left + j];
// thread t's last read is word t + (taps + 3) / 4 (see window_thread).
WFT_INLINE int window_row_words(int taps) {
  return kWindowThreads + (taps + 3) / 4;
}

// The rebiased sample at column m of row `row`; outside the rows or the row
// it is u8 0, i.e. x~ = -128, as the TPU kernels' zero pad gives.
WFT_INLINE uint8_t window_byte(const uint8_t* x, long long rows, long long n,
                               long long row, long long m) {
  return (row < rows && m >= 0 && m < n)
             ? static_cast<uint8_t>(x[row * n + m] ^ 0x80u)
             : static_cast<uint8_t>(0x80u);
}

// Kernel C, one thread: outputs col0 + 4t + j (j < 4) of rows row0 ..
// row0 + kWindowRows - 1.
//
// With the taps reversed (rd[q] = digit[taps - 1 - q]) the same-mode sum of
// a plane is the correlation  s(i) = sum_q rd[q] * xs[i + q],  where
// xs[j] = x~[col0 - left + j]: K3's window matmul against its Toeplitz band
// A[j, i] = rd[j - i] (fir_mxu.py:691-751), without the band.  A plane
// walks only its own nonzero tap range, in quads of 4 taps: word a of the
// plane's digits holds rd[4a .. 4a+3], and output 4t + j meets bytes
// 4(t+a) + j .. 4(t+a) + j + 3 of the row, i.e. words t+a and t+a+1 shifted
// by j bytes (byte_perm), so each quad is one dp4a per output.
//   xs      kWindowRows rows of row_words words (rebiased int8 bytes)
//   ds      the planes' digit words
//   planes  kPlaneFields ints per plane (kPlane* above)
WFT_INLINE void window_thread(const uint32_t* xs, int row_words, int t,
                              const uint32_t* ds, const int* planes,
                              int num_planes, uint32_t bias, bool wrap,
                              int frac_bits, int acc_bits, uint8_t* y,
                              long long row0, long long rows, long long n,
                              long long col0) {
  uint32_t acc[kWindowRows][4];
  WFT_UNROLL
  for (int r = 0; r < kWindowRows; ++r) {
    WFT_UNROLL
    for (int j = 0; j < 4; ++j) acc[r][j] = bias;
  }
  for (int b = 0; b < num_planes; ++b) {
    const int* plane = planes + kPlaneFields * b;
    const int e = plane[kPlaneExp];
    const int a0 = plane[kPlaneQuad0];
    const int quads = plane[kPlaneQuads];
    const uint32_t* d = ds + plane[kPlaneOffset];
    int32_t s[kWindowRows][4];  // |s| <= 4096 * 128 * 128 = 2^26
    uint32_t w0[kWindowRows];
    WFT_UNROLL
    for (int r = 0; r < kWindowRows; ++r) {
      WFT_UNROLL
      for (int j = 0; j < 4; ++j) s[r][j] = 0;
      w0[r] = xs[r * row_words + t + a0];
    }
    for (int a = 0; a < quads; ++a) {
      const uint32_t dw = d[a];
      WFT_UNROLL
      for (int r = 0; r < kWindowRows; ++r) {
        const uint32_t w1 = xs[r * row_words + t + a0 + a + 1];
        s[r][0] = dp4a(w0[r], dw, s[r][0]);
        s[r][1] = dp4a(byte_perm(w0[r], w1, 0x4321u), dw, s[r][1]);
        s[r][2] = dp4a(byte_perm(w0[r], w1, 0x5432u), dw, s[r][2]);
        s[r][3] = dp4a(byte_perm(w0[r], w1, 0x6543u), dw, s[r][3]);
        w0[r] = w1;
      }
    }
    // A shift of 32 or more leaves nothing mod 2^32 (and is UB in C++).
    if (e < 32) {
      WFT_UNROLL
      for (int r = 0; r < kWindowRows; ++r) {
        WFT_UNROLL
        for (int j = 0; j < 4; ++j) {
          acc[r][j] += static_cast<uint32_t>(s[r][j]) << e;
        }
      }
    }
  }
  WFT_UNROLL
  for (int r = 0; r < kWindowRows; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;
    WFT_UNROLL
    for (int j = 0; j < 4; ++j) {
      const long long col = col0 + 4 * t + j;
      if (col < n) {
        y[row * n + col] = fixed_epilogue(acc[r][j], wrap, frac_bits, acc_bits);
      }
    }
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
