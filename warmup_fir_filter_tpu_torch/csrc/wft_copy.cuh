// Core of kernel N (copy_rows.cu): one thread's share of a byte copy.
//
// Like wft_fixed.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every thread of every CTA of a launch in turn
// between two separate buffers at every alignment and at widths around the
// 16-byte vectors and the CTA's chunk, and hold the destination to the
// source.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define WFT_COPY_FN __device__ __forceinline__
#else
#define WFT_COPY_FN inline
#endif

namespace wft {

constexpr int kCopyThreads = 256;
// Vectors a thread loads before it stores them; a CTA's chunk is
// kCopyThreads * kCopyUnroll consecutive vectors (16 KB).
constexpr int kCopyUnroll = 4;
constexpr long long kCopyChunk =
    static_cast<long long>(kCopyThreads) * kCopyUnroll;

// A byte range cut at the 16-byte boundaries of its address: head bytes up
// to the first boundary, whole 16-byte vectors, then tail bytes (each at
// most 15, fewer than a CTA's threads).
struct CopySplit {
  long long head, vectors, tail;
};

inline CopySplit copy_split(uintptr_t addr, long long nbytes) {
  long long head = static_cast<long long>((16 - (addr & 15)) & 15);
  if (head > nbytes) head = nbytes;
  const long long vectors = (nbytes - head) / 16;
  return {head, vectors, nbytes - head - 16 * vectors};
}

// CTAs of a launch: one a chunk of vectors, at least one for the bytes.
inline long long copy_blocks(const CopySplit& s) {
  const long long blocks = (s.vectors + kCopyChunk - 1) / kCopyChunk;
  return blocks > 0 ? blocks : 1;
}

#if defined(__CUDACC__)
// Streaming loads and stores (evict first): every byte is touched once.
using CopyVec = uint4;
WFT_COPY_FN CopyVec copy_load(const uint8_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}
WFT_COPY_FN void copy_store(uint8_t* p, const CopyVec& v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}
WFT_COPY_FN void copy_byte(const uint8_t* src, uint8_t* dst) {
  __stcs(dst, __ldcs(src));
}
#else
struct CopyVec {
  uint8_t b[16];
};
inline CopyVec copy_load(const uint8_t* p) {
  CopyVec v;
  std::memcpy(v.b, p, 16);
  return v;
}
inline void copy_store(uint8_t* p, const CopyVec& v) {
  std::memcpy(p, v.b, 16);
}
inline void copy_byte(const uint8_t* src, uint8_t* dst) { *dst = *src; }
#endif

// Thread t of CTA b: the vectors b * kCopyChunk + t + u * kCopyThreads,
// u < kCopyUnroll (neighbouring threads on neighbouring vectors), all
// loaded before any is stored; CTA 0's first threads also take the head
// and tail bytes.  src and dst share their alignment mod 16 (the entry
// point checks); they may be the same buffer, since each byte is read and
// written by one thread, its load before its store.
WFT_COPY_FN void copy_thread(const uint8_t* src, uint8_t* dst,
                             const CopySplit& s, long long b, int t) {
  if (b == 0) {
    if (t < s.head) copy_byte(src + t, dst + t);
    const long long tail0 = s.head + 16 * s.vectors;
    if (t < s.tail) copy_byte(src + tail0 + t, dst + tail0 + t);
  }
  const uint8_t* vs = src + s.head;
  uint8_t* vd = dst + s.head;
  const long long base = b * kCopyChunk + t;
  CopyVec v[kCopyUnroll];
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kCopyThreads;
    if (i < s.vectors) v[u] = copy_load(vs + 16 * i);
  }
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kCopyThreads;
    if (i < s.vectors) copy_store(vd + 16 * i, v[u]);
  }
}

}  // namespace wft
