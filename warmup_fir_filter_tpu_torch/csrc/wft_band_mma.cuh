// Warp-level tensor-core band products shared by kernels A (fir_band.cu,
// its digit-plane route), C (fir_window.cu), E and F (fir2d_frame.cu) and
// G (fir2d_bf16.cu).
//
// C, E and F multiply staged, rebiased samples by the Toeplitz band of a
// digit plane on mma.sync.aligned.m16n8k32 (s8 x s8 -> s32), as the TPU
// kernels multiply by band planes on their matrix unit, without building
// the band: a B fragment word holds 4 consecutive k of one column n, that
// is 4 consecutive reversed digits, so with four copies of a plane's
// reversed digits shifted by 0-3 bytes every fragment word is one aligned
// 32-bit shared-memory load (band_copy_word).  G does the same on
// mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32) with two copies of a tap
// row's reversed bf16 taps shifted by one element.  A holds the band
// itself in registers instead, as the A operand, and multiplies the raw u8
// samples on mma.sync m16n8k32 s8 x u8 (mma_s8u8; wft_band.cuh).
//
// Like the other headers, this one also compiles as plain C++.  On the host
// a warp's 32 lanes run as one unit: per-lane values live in arrays of
// kLaneSlots (32 on the host, 1 on the card), WFT_LANES(l) loops over the
// lanes (on the card it is the thread's own lane), and mma_s8, mma_s8u8 and
// mma_bf16 emulate the instructions from the PTX fragment layout, so the
// CPU tests run the kernels' own index maths.
#pragma once

#include <cstdint>
#include <cstring>

#include "wft_fixed.cuh"

namespace wft {

constexpr int kWarp = 32;

#if defined(__CUDA_ARCH__)
constexpr int kLaneSlots = 1;
#define WFT_LANES(l)                                                  \
  for (int l = static_cast<int>(threadIdx.x) & 31, l##_once = 1; \
       l##_once; l##_once = 0)
#define WFT_SLOT(l) 0
#else
constexpr int kLaneSlots = kWarp;
#define WFT_LANES(l) for (int l = 0; l < kWarp; ++l)
#define WFT_SLOT(l) (l)
#endif

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

// The word of bytes r[4w - sigma .. 4w - sigma + 3] of a byte string r whose
// aligned words are q[w - 1] and q[w]: copy sigma (0-3) of a plane's
// reversed digits.  A fragment word that starts at byte p of r is word
// (p + sigma) / 4 of copy sigma = (-p) & 3.
WFT_INLINE uint32_t band_copy_word(uint32_t q_prev, uint32_t q, int sigma) {
  // Bytes 4 - sigma .. 7 - sigma of q:q_prev (sigma = 0 selects q).
  return byte_perm(q_prev, q, 0x7654u - 0x1111u * static_cast<uint32_t>(sigma));
}

#if !defined(__CUDA_ARCH__)
// The host emulation of mma.sync m16n8k32 with s8 A and s8 (BSigned) or
// u8 B fragments, from the PTX fragment layout (mma_s8 below).
template <bool BSigned>
inline void mma_k32_host(int32_t (*d)[4], uint32_t (*a)[4],
                         uint32_t (*b)[2]) {
  int32_t am[16][32];
  int32_t bm[32][8];
  for (int l = 0; l < kWarp; ++l) {
    const int g = l >> 2;
    const int t = l & 3;
    for (int i = 0; i < 4; ++i) {
      const auto s8 = [i](uint32_t w) {
        return static_cast<int32_t>(static_cast<int8_t>(w >> (8 * i)));
      };
      const auto bv = [i](uint32_t w) {
        return BSigned ? static_cast<int32_t>(static_cast<int8_t>(w >> (8 * i)))
                       : static_cast<int32_t>((w >> (8 * i)) & 0xffu);
      };
      am[g][4 * t + i] = s8(a[l][0]);
      am[g + 8][4 * t + i] = s8(a[l][1]);
      am[g][16 + 4 * t + i] = s8(a[l][2]);
      am[g + 8][16 + 4 * t + i] = s8(a[l][3]);
      bm[4 * t + i][g] = bv(b[l][0]);
      bm[16 + 4 * t + i][g] = bv(b[l][1]);
    }
  }
  for (int l = 0; l < kWarp; ++l) {
    const int g = l >> 2;
    const int t = l & 3;
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (j >> 1);
      const int col = 2 * t + (j & 1);
      uint32_t sum = static_cast<uint32_t>(d[l][j]);
      for (int k = 0; k < 32; ++k) {
        sum += static_cast<uint32_t>(am[row][k] * bm[k][col]);
      }
      d[l][j] = static_cast<int32_t>(sum);
    }
  }
}
#endif

// d += a * b over one m16n8k32 tile, s8 x s8 -> s32, for a whole warp.
// Lane l = 4g + t holds the fragments of mma.sync.aligned.m16n8k32.row.col
// (PTX ISA, "Matrix Fragments for mma.m16n8k32"), byte i of a word being
// element i:
//   a[0] A(g, 4t..4t+3)     a[1] A(g+8, 4t..4t+3)
//   a[2] A(g, 16+4t..+3)    a[3] A(g+8, 16+4t..+3)
//   b[0] B(4t..4t+3, g)     b[1] B(16+4t..+3, g)
//   d[0] D(g, 2t)  d[1] D(g, 2t+1)  d[2] D(g+8, 2t)  d[3] D(g+8, 2t+1)
// Each array has kLaneSlots entries: the thread's own on the card, all 32
// lanes on the host.  The sums wrap mod 2^32 like the instruction's.
WFT_INLINE void mma_s8(int32_t (*d)[4], uint32_t (*a)[4], uint32_t (*b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(b[0][0]), "r"(b[0][1]));
#else
  mma_k32_host<true>(d, a, b);
#endif
}

// mma_s8 with unsigned bytes in B: s8 x u8 -> s32 (kernel A's digit planes
// times the raw samples).
WFT_INLINE void mma_s8u8(int32_t (*d)[4], uint32_t (*a)[4],
                         uint32_t (*b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(b[0][0]), "r"(b[0][1]));
#else
  mma_k32_host<false>(d, a, b);
#endif
}

// The bits of a float.
WFT_INLINE uint32_t float_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(f);
#else
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

// The float of bf16 bits h (the upper half of a float's bits).
WFT_INLINE float bf16_float(uint32_t h) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(h << 16);
#else
  const uint32_t u = h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

// d += a * b over one m16n8k16 tile, bf16 x bf16 -> f32, for a whole warp.
// Lane l = 4g + t holds the fragments of mma.sync.aligned.m16n8k16.row.col
// with .bf16 operands (PTX ISA, "Matrix Fragments for mma.m16n8k16 with
// floating point type"), the low half of a word being the lower k:
//   a[0] A(g, 2t..2t+1)     a[1] A(g+8, 2t..2t+1)
//   a[2] A(g, 8+2t..+1)     a[3] A(g+8, 8+2t..+1)
//   b[0] B(2t..2t+1, g)     b[1] B(8+2t..+1, g)
//   d as mma_s8's.
// Every product of two bf16 values is exact in f32.  The host sums each
// element's 16 products and d in double and rounds once to f32; the card
// adds with its own alignment, so the two agree wherever every partial sum
// is an integer below 2^24 (kernel G's exact case).
WFT_INLINE void mma_bf16(float (*d)[4], uint32_t (*a)[4], uint32_t (*b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(b[0][0]), "r"(b[0][1]));
#else
  double am[16][16];
  double bm[16][8];
  for (int l = 0; l < kWarp; ++l) {
    const int g = l >> 2;
    const int t = l & 3;
    for (int i = 0; i < 2; ++i) {
      const auto el = [i](uint32_t w) {
        return static_cast<double>(bf16_float((w >> (16 * i)) & 0xffffu));
      };
      am[g][2 * t + i] = el(a[l][0]);
      am[g + 8][2 * t + i] = el(a[l][1]);
      am[g][8 + 2 * t + i] = el(a[l][2]);
      am[g + 8][8 + 2 * t + i] = el(a[l][3]);
      bm[2 * t + i][g] = el(b[l][0]);
      bm[8 + 2 * t + i][g] = el(b[l][1]);
    }
  }
  for (int l = 0; l < kWarp; ++l) {
    const int g = l >> 2;
    const int t = l & 3;
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (j >> 1);
      const int col = 2 * t + (j & 1);
      double sum = d[l][j];
      for (int k = 0; k < 16; ++k) sum += am[row][k] * bm[k][col];
      d[l][j] = static_cast<float>(sum);
    }
  }
#endif
}

// The 32-bit shared-memory word at byte offset i (a multiple of 4).
WFT_INLINE uint32_t shared_word(const uint8_t* s, int i) {
  return *reinterpret_cast<const uint32_t*>(s + i);
}

// 16 bytes from device memory to shared memory, asynchronously on the card
// (cp.async, completed by async_wait); both addresses 16-byte aligned.
WFT_INLINE void copy16_async(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

WFT_INLINE void zero16(uint8_t* dst) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
#else
  std::memset(dst, 0, 16);
#endif
}

// A warp's barrier; on the host a warp's lanes run as one unit.
WFT_INLINE void warp_sync() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#endif
}

// Closes the thread's group of copies issued since the last commit.
WFT_INLINE void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `Pending` of the thread's committed groups are still
// in flight.
template <int Pending>
WFT_INLINE void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
#endif
}

}  // namespace wft
