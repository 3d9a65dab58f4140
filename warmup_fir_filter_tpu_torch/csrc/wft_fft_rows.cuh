// Per-thread core of kernel K (fft_rows.cu): the batched row FFT and scaled
// inverse over (rows, n) f32 re/im planes, n = 2^LOG_N, 2 <= n <= 16,384,
// natural order in and out, as Stockham passes in registers.
//
// The transform.  n = R_0 R_1 ... R_{p-1} with every radix 16 but the last
// (2, 4, 8 or 16): 2,048 = 16 16 8, 16,384 = 16 16 16 4; below 16 points a
// single pass of radix n.  A thread holds P = min(n, 16) points of its row
// in registers, and a row takes T = n / P threads.  Pass i (Ns = R_0 ...
// R_{i-1} points transformed so far) is the Stockham step of Govindaraju et
// al. (SC'08): butterfly j < n / R reads points j + s n / R (s < R),
// multiplies point s by W_{Ns R}^{(j mod Ns) s}, runs a radix-R DFT in
// registers and writes output s to (j / Ns) Ns R + (j mod Ns) + s Ns.  With
// butterfly j = t + b T on thread t (b < P / R), every pass reads the
// thread's points t + q T, q < P, and the last pass writes them: the first
// pass reads x[row, t + q T] and the last writes y[row, t + q T], both
// coalesced across a warp, and neither end has a bit reversal.  Between
// passes the points go through shared memory once: write, barrier, read
// (and a barrier before the next write).
//
// Shared memory: separate re and im float planes, a row at
// stride n + n / 16, point i at i + i / 16: the one pad slot every 16
// points keeps the strided writes of each pass to at most two accesses a
// bank.  A CTA takes max(1, 128 / T) rows.
//
// Twiddles: tw[k] = exp(-2 pi i k / n), k < n / 2, computed in float64 on
// the host and stored as f32 (kernels/fft.py::fft_twiddles), read through
// the read-only path: log2 R of them a butterfly, the powers of two of its
// twiddle, and the other powers as products of those (at most three
// roundings more).  The radix-16 DFT's own constants are f32 literals.  No fast-math sine: the kernels
// must meet the JAX package's SNR bounds (about 1e-6 relative error).  The
// inverse conjugates every twiddle and scales by 1 / n on the store.
//
// Like wft_fft.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++ and run every thread of every CTA on the host, the
// phases of a CTA one after another where the kernel puts a barrier.
#pragma once

#include <cstddef>
#include <cstdint>

#include "wft_fft.cuh"

namespace wft {

template <int LOG_N>
struct RowsPlan {
  static constexpr int n = 1 << LOG_N;
  static constexpr int P = LOG_N < 4 ? n : 16;   // points a thread holds
  static constexpr int T = n / P;                // threads a row
  static constexpr int threads = T >= 128 ? T : 128;
  static constexpr int rows = threads / T;       // rows a CTA
  static constexpr int passes = LOG_N < 4 ? 1 : (LOG_N + 3) / 4;
  static constexpr int stride = n + (n >> 4);    // a padded shared row
  static constexpr std::size_t shared_bytes =
      passes > 1 ? 2 * sizeof(float) * rows * stride : 0;
};

// log2 of pass I's radix, and of the points it has transformed before it.
template <int LOG_N, int I>
constexpr int kRowsLogRadix =
    LOG_N < 4 ? LOG_N
              : (I + 1 < RowsPlan<LOG_N>::passes ? 4 : LOG_N - 4 * I);
template <int I>
constexpr int kRowsLogNs = 4 * I;

WFT_INLINE int rows_slot(int i) { return i + (i >> 4); }

WFT_INLINE constexpr int reverse_bits(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

// d * W_16^m (forward, W_16 = exp(-2 pi i / 16)) or d * conj(W_16^m).
template <bool INV>
WFT_INLINE Cf rot16(Cf d, int m) {
  if (m == 0) return d;
  if (m == 4) return INV ? Cf{-d.im, d.re} : Cf{d.im, -d.re};
  float c, s;  // W_16^m = c - i s
  switch (m) {
    case 1: c = 0.92387953251128674f; s = 0.38268343236508977f; break;
    case 2: c = 0.70710678118654752f; s = 0.70710678118654752f; break;
    case 3: c = 0.38268343236508977f; s = 0.92387953251128674f; break;
    case 5: c = -0.38268343236508977f; s = 0.92387953251128674f; break;
    case 6: c = -0.70710678118654752f; s = 0.70710678118654752f; break;
    default: c = -0.92387953251128674f; s = 0.38268343236508977f; break;
  }
  return INV ? Cf{d.re * c - d.im * s, d.im * c + d.re * s}
             : Cf{d.re * c + d.im * s, d.im * c - d.re * s};
}

// Stage ST of a radix-2^LOG_R DIF in registers: the butterflies of half
// h = R >> (ST + 1) over the points v[b + s B].
template <int LOG_R, int ST, int B, bool INV>
WFT_INLINE void dft_stage(Cf* v, int b) {
  constexpr int h = (1 << LOG_R) >> (ST + 1);
  WFT_UNROLL
  for (int u = 0; u < (1 << LOG_R) / 2; ++u) {
    const int j = u % h;
    const int i = (u / h) * 2 * h + j;
    Cf& a = v[b + i * B];
    Cf& c = v[b + (i + h) * B];
    const Cf d = csub(a, c);
    a = cadd(a, c);
    c = rot16<INV>(d, j * (8 / h));  // W_2h^j = W_16^(8 j / h)
  }
  if constexpr (ST + 1 < LOG_R) dft_stage<LOG_R, ST + 1, B, INV>(v, b);
}

// The radix-2^LOG_R DFT of the points v[b + s B], s < 2^LOG_R, in place,
// natural order in and out: radix-2 DIF stages, then the bit-reversed
// result put back in order (register renaming on the card).
template <int LOG_R, int B, bool INV>
WFT_INLINE void dft_in_registers(Cf* v, int b) {
  constexpr int R = 1 << LOG_R;
  if constexpr (LOG_R > 0) dft_stage<LOG_R, 0, B, INV>(v, b);
  Cf tmp[R];
  WFT_UNROLL
  for (int k = 0; k < R; ++k) tmp[k] = v[b + reverse_bits(k, LOG_R) * B];
  WFT_UNROLL
  for (int k = 0; k < R; ++k) v[b + k * B] = tmp[k];
}

// tw[i], i < n / 2, through the read-only path; conjugated for the inverse.
template <bool INV>
WFT_INLINE Cf table_twiddle(const Cf* tw, int i) {
#if defined(__CUDA_ARCH__)
  const float2 f = __ldg(reinterpret_cast<const float2*>(tw) + i);
  const Cf w{f.x, f.y};
#else
  const Cf w = tw[i];
#endif
  return INV ? Cf{w.re, -w.im} : w;
}

// Pass I of thread t on its registers: twiddles, then the radix-R DFTs.
// Butterfly j's point s takes W^(k s), W = W_{Ns R} = W_n^(n / (Ns R)),
// k = j mod Ns: the table gives W^(k 2^e) for e < log2 R (all under n / 2)
// and each other power is a product of at most four of them, formed where
// it is used so that few registers hold twiddles.
template <int LOG_N, int I, bool INV>
WFT_INLINE void rows_pass(Cf* v, const Cf* tw, int t) {
  using Plan = RowsPlan<LOG_N>;
  constexpr int log_r = kRowsLogRadix<LOG_N, I>, log_ns = kRowsLogNs<I>;
  constexpr int R = 1 << log_r, B = Plan::P / R;
  WFT_UNROLL
  for (int b = 0; b < B; ++b) {
    if constexpr (I > 0) {
      const int k = (t + b * Plan::T) & ((1 << log_ns) - 1);
      Cf base[log_r];  // W^(k 2^e)
      WFT_UNROLL
      for (int e = 0; e < log_r; ++e) {
        base[e] = table_twiddle<INV>(tw, k << (e + LOG_N - log_ns - log_r));
      }
      WFT_UNROLL
      for (int s = 1; s < R; ++s) {
        Cf w{1.0f, 0.0f};
        bool first = true;
        WFT_UNROLL
        for (int e = 0; e < log_r; ++e) {
          if ((s >> e) & 1) {
            w = first ? base[e] : cmul(w, base[e]);
            first = false;
          }
        }
        v[b + s * B] = cmul(v[b + s * B], w);
      }
    }
    dft_in_registers<log_r, B, INV>(v, b);
  }
}

// Pass I's outputs into the row's shared planes.
template <int LOG_N, int I>
WFT_INLINE void rows_write(const Cf* v, float* sre, float* sim, int t) {
  using Plan = RowsPlan<LOG_N>;
  constexpr int log_r = kRowsLogRadix<LOG_N, I>, log_ns = kRowsLogNs<I>;
  constexpr int R = 1 << log_r, B = Plan::P / R;
  WFT_UNROLL
  for (int b = 0; b < B; ++b) {
    const int j = t + b * Plan::T;
    const int base = ((j >> log_ns) << (log_ns + log_r)) +
                     (j & ((1 << log_ns) - 1));
    WFT_UNROLL
    for (int s = 0; s < R; ++s) {
      const int slot = rows_slot(base + (s << log_ns));
      sre[slot] = v[b + s * B].re;
      sim[slot] = v[b + s * B].im;
    }
  }
}

// The thread's points t + q T of the row's shared planes.
template <int LOG_N>
WFT_INLINE void rows_read(Cf* v, const float* sre, const float* sim, int t) {
  using Plan = RowsPlan<LOG_N>;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) {
    const int slot = rows_slot(t + q * Plan::T);
    v[q] = Cf{sre[slot], sim[slot]};
  }
}

// Row `row` of the (rows, n) planes, points t + q T; xi == nullptr is a
// real input; rows past the end load zeros.
template <int LOG_N>
WFT_INLINE void rows_load(const float* xr, const float* xi, long long rows,
                          long long row, int t, Cf* v) {
  using Plan = RowsPlan<LOG_N>;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) v[q] = Cf{0.0f, 0.0f};
  if (row >= rows) return;
  const long long base = row * Plan::n + t;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) v[q].re = xr[base + q * Plan::T];
  if (xi != nullptr) {
    WFT_UNROLL
    for (int q = 0; q < Plan::P; ++q) v[q].im = xi[base + q * Plan::T];
  }
}

template <int LOG_N>
WFT_INLINE void rows_store(const Cf* v, long long rows, long long row, int t,
                           float scale, float* yr, float* yi) {
  using Plan = RowsPlan<LOG_N>;
  if (row >= rows) return;
  const long long base = row * Plan::n + t;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) {
    yr[base + q * Plan::T] = v[q].re * scale;
    yi[base + q * Plan::T] = v[q].im * scale;
  }
}

}  // namespace wft
