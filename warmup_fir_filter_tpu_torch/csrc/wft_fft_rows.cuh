// Per-thread cores of the FFT kernels: kernel K's batched row FFT and
// scaled inverse (fft_rows.cu) and, on the same passes, the overlap-save
// filters of kernels L (osfilt.cu) and M (osfilt_stream.cu).
//
// The transform.  n = 2^LOG_N, 2 <= n <= 16,384, natural order in and out,
// as Stockham passes in registers.  n = R_0 R_1 ... R_{p-1} with every
// radix 16 but the last (2, 4, 8 or 16): 2,048 = 16 16 8, 16,384 = 16 16 16
// 4; below 16 points a single pass of radix n.  A thread holds P = min(n,
// 16) points of its row in registers, and a row takes T = n / P threads.
// Pass i (Ns = R_0 ... R_{i-1} points transformed so far) is the Stockham
// step of Govindaraju et al. (SC'08): butterfly j < n / R reads points j +
// s n / R (s < R), multiplies point s by W_{Ns R}^{(j mod Ns) s}, runs a
// radix-R DFT in registers and writes output s to (j / Ns) Ns R + (j mod
// Ns) + s Ns.  With butterfly j = t + b T on thread t (b < P / R), every
// pass reads the thread's points t + q T, q < P, and the last pass writes
// them: the first pass reads x[row, t + q T] and the last writes y[row, t +
// q T], both coalesced across a warp, and neither end has a bit reversal.
// Between passes the points go through shared memory once: write, barrier,
// read (and a barrier before the next write).
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
// roundings more).  The radix-16 DFT's own constants are f32 literals.  No
// fast-math sine: the kernels must meet the JAX package's SNR bounds (about
// 1e-6 relative error).  The inverse conjugates every twiddle; kernel K
// scales by 1 / n on the store, the filters fold 1 / n into the spectrum.
//
// The filter (kernels L and M): forward transform, product with the filter
// spectrum, inverse transform.  After the forward's last pass thread t
// holds points t + q T of the spectrum in natural order, which is where the
// inverse's first pass reads them, so the product (spectrum in natural
// order, 1 / n folded in, through the read-only path) happens in registers
// with no exchange between the two transforms: a 512- or 2,048-point
// filter makes four exchanges through shared memory, two a transform.  The
// filter is real, so one complex transform filters two real inputs, one as
// its real part and one as its imaginary part.  filter_phase<LOG_N, PH> is
// a thread's work between two barriers of its CTA.
//
// This header also compiles as plain C++: the CPU tests build it with g++
// and run every thread of every CTA on the host, the phases of a CTA one
// after another where the kernels put a barrier.
#pragma once

#include <math.h>

#include <cstddef>
#include <cstdint>

#include "wft_chain.cuh"

namespace wft {

struct alignas(8) Cf {
  float re, im;
};

constexpr int kFftMaxLog2 = 14;
// Kernel M's transform: 512 points.
constexpr int kStreamLog2 = 9;

WFT_INLINE Cf cadd(Cf a, Cf b) { return {a.re + b.re, a.im + b.im}; }
WFT_INLINE Cf csub(Cf a, Cf b) { return {a.re - b.re, a.im - b.im}; }
WFT_INLINE Cf cmul(Cf a, Cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// The u8 output stage of the TPU kernels (fft_pallas.py:542-544): round
// half up, saturate to [0, 255]; NaN stores 0.
WFT_INLINE uint8_t round_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(floorf(v + 0.5f), 0.0f), 255.0f));
}
WFT_INLINE void store_sample(float* y, long long i, float v) { y[i] = v; }
WFT_INLINE void store_sample(uint8_t* y, long long i, float v) {
  y[i] = round_u8(v);
}

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
// result put back in order by swapping pairs (register renaming on the
// card).  A copy array here was left in local memory in some filter
// instances, which made kernel L 3x slower at 2,048 points.
template <int LOG_R, int B, bool INV>
WFT_INLINE void dft_in_registers(Cf* v, int b) {
  constexpr int R = 1 << LOG_R;
  if constexpr (LOG_R > 0) dft_stage<LOG_R, 0, B, INV>(v, b);
  WFT_UNROLL
  for (int k = 0; k < R; ++k) {
    const int r = reverse_bits(k, LOG_R);
    if (k < r) {
      const Cf s = v[b + k * B];
      v[b + k * B] = v[b + r * B];
      v[b + r * B] = s;
    }
  }
}

// table[i] through the read-only path.
WFT_INLINE Cf table_entry(const Cf* table, int i) {
#if defined(__CUDA_ARCH__)
  const float2 f = __ldg(reinterpret_cast<const float2*>(table) + i);
  return Cf{f.x, f.y};
#else
  return table[i];
#endif
}

// tw[i], i < n / 2; conjugated for the inverse.
template <bool INV>
WFT_INLINE Cf table_twiddle(const Cf* tw, int i) {
  const Cf w = table_entry(tw, i);
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

// ------------------------------------------------------------- the filter
// Passes g < 2 p of a filter: forward pass g for g < p, inverse pass g - p
// after it.  Exchange k < 2 (p - 1) writes after pass
// filter_written_pass(k) and reads before the next; the forward's last pass
// and the inverse's first have no exchange between them.  Phase 0 runs
// pass 0 and writes; phase 2k - 1 reads exchange k - 1 and runs the passes
// up to the next write (the product among them after the forward's last);
// phase 2k writes exchange k, after a barrier that waits for every read of
// exchange k - 1.
template <int LOG_N>
struct FilterPlan {
  static constexpr int passes = RowsPlan<LOG_N>::passes;
  static constexpr int exchanges = 2 * (passes - 1);
  static constexpr int phases = passes == 1 ? 1 : 2 * exchanges;
};

WFT_INLINE constexpr int filter_written_pass(int k, int passes) {
  return k < passes - 1 ? k : k + 1;
}

// The spectrum's points t + q T times the thread's registers.
template <int LOG_N>
WFT_INLINE void filter_product(Cf* v, const Cf* spec, int t) {
  using Plan = RowsPlan<LOG_N>;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) {
    v[q] = cmul(v[q], table_entry(spec, t + q * Plan::T));
  }
}

// Passes G .. LAST of the filter.
template <int LOG_N, int G, int LAST>
WFT_INLINE void filter_passes(Cf* v, const Cf* tw, const Cf* spec, int t) {
  constexpr int p = RowsPlan<LOG_N>::passes;
  rows_pass<LOG_N, G % p, (G >= p)>(v, tw, t);
  if constexpr (G == p - 1) filter_product<LOG_N>(v, spec, t);
  if constexpr (G < LAST) filter_passes<LOG_N, G + 1, LAST>(v, tw, spec, t);
}

template <int LOG_N, int PH>
WFT_INLINE void filter_phase(Cf* v, const Cf* tw, const Cf* spec, float* sre,
                             float* sim, int t) {
  using Plan = FilterPlan<LOG_N>;
  constexpr int p = Plan::passes;
  if constexpr (p == 1) {
    filter_passes<LOG_N, 0, 1>(v, tw, spec, t);
  } else if constexpr (PH == 0) {
    filter_passes<LOG_N, 0, 0>(v, tw, spec, t);
    rows_write<LOG_N, 0>(v, sre, sim, t);
  } else if constexpr (PH % 2 == 1) {
    constexpr int k = (PH + 1) / 2;
    constexpr int first = filter_written_pass(k - 1, p) + 1;
    constexpr int last =
        k < Plan::exchanges ? filter_written_pass(k, p) : 2 * p - 1;
    rows_read<LOG_N>(v, sre, sim, t);
    filter_passes<LOG_N, first, last>(v, tw, spec, t);
  } else {
    rows_write<LOG_N, filter_written_pass(PH / 2, p) % p>(v, sre, sim, t);
  }
}

#if defined(__CUDACC__)
// The filter's phases in a CTA, a barrier between two.
template <int LOG_N, int PH = 0>
__device__ __forceinline__ void filter_cta(Cf* v, const Cf* tw,
                                           const Cf* spec, float* sre,
                                           float* sim, int t) {
  filter_phase<LOG_N, PH>(v, tw, spec, sre, sim, t);
  if constexpr (PH + 1 < FilterPlan<LOG_N>::phases) {
    __syncthreads();
    filter_cta<LOG_N, PH + 1>(v, tw, spec, sre, sim, t);
  }
}
#endif

// ---------------------------------------------------------------- kernel L
// Row r of CTA c filters the framed segments s = 2 (c rows + r) (real part)
// and s + 1 (imaginary part) of (batch, n); a segment past the end loads
// zeros and stores nothing.
WFT_INLINE long long osfilt_ctas(long long batch, int rows) {
  return ((batch + 1) / 2 + rows - 1) / rows;
}

template <int LOG_N, typename T>
WFT_INLINE void osfilt_load_t(const T* seg, long long batch, long long s,
                              int t, Cf* v) {
  using Plan = RowsPlan<LOG_N>;
  WFT_UNROLL
  for (int q = 0; q < Plan::P; ++q) v[q] = Cf{0.0f, 0.0f};
  if (s < batch) {
    const T* a = seg + s * Plan::n + t;
    WFT_UNROLL
    for (int q = 0; q < Plan::P; ++q) v[q].re = sample_f32(a, q * Plan::T);
  }
  if (s + 1 < batch) {
    const T* b = seg + (s + 1) * Plan::n + t;
    WFT_UNROLL
    for (int q = 0; q < Plan::P; ++q) v[q].im = sample_f32(b, q * Plan::T);
  }
}

template <int LOG_N, typename U>
WFT_INLINE void osfilt_store_t(const Cf* v, U* y, long long batch,
                               long long s, int t) {
  using Plan = RowsPlan<LOG_N>;
  if (s < batch) {
    WFT_UNROLL
    for (int q = 0; q < Plan::P; ++q) {
      store_sample(y, s * Plan::n + t + q * Plan::T, v[q].re);
    }
  }
  if (s + 1 < batch) {
    WFT_UNROLL
    for (int q = 0; q < Plan::P; ++q) {
      store_sample(y, (s + 1) * Plan::n + t + q * Plan::T, v[q].im);
    }
  }
}

// Samples uint8 when u8, else f32: one branch for the whole load or store.
template <int LOG_N>
WFT_INLINE void osfilt_load(const void* seg, bool u8, long long batch,
                            long long s, int t, Cf* v) {
  if (u8) {
    osfilt_load_t<LOG_N>(static_cast<const uint8_t*>(seg), batch, s, t, v);
  } else {
    osfilt_load_t<LOG_N>(static_cast<const float*>(seg), batch, s, t, v);
  }
}

template <int LOG_N>
WFT_INLINE void osfilt_store(const Cf* v, void* y, bool u8, long long batch,
                             long long s, int t) {
  if (u8) {
    osfilt_store_t<LOG_N>(v, static_cast<uint8_t*>(y), batch, s, t);
  } else {
    osfilt_store_t<LOG_N>(v, static_cast<float*>(y), batch, s, t);
  }
}

// ---------------------------------------------------------------- kernel M
// 512-point overlap-save off a (C, tx) stream: window w of a channel is
// x[a, a + 512) with a = w hop + start (zero outside [0, tx)), and its
// circular outputs p in [512 - hop, 512) are the call's outputs q = w hop +
// p - (512 - hop), written where q < out_len (kernels/fft.py::stream_plan:
// hop = 512 - L + 1, start = off + L / 2 - (L - 1)).  Row r of CTA c of a
// channel filters windows w = 2 (c rows + r) (real part) and w + 1
// (imaginary part), so a CTA's windows are consecutive and their
// overlapping reads meet in the cache.
using StreamRows = RowsPlan<kStreamLog2>;

WFT_INLINE long long stream_ctas_per_channel(long long out_len, int hop) {
  const long long windows = (out_len + hop - 1) / hop;
  return osfilt_ctas(windows, StreamRows::rows);
}

template <typename T>
WFT_INLINE void stream_load_t(const T* row, long long tx, long long a,
                              int hop, int t, Cf* v) {
  constexpr int P = StreamRows::P, TH = StreamRows::T;
  if (a >= 0 && a + hop + StreamRows::n <= tx) {
    const T* x = row + a + t;
    WFT_UNROLL
    for (int q = 0; q < P; ++q) {
      v[q] = Cf{sample_f32(x, q * TH), sample_f32(x, hop + q * TH)};
    }
    return;
  }
  WFT_UNROLL
  for (int q = 0; q < P; ++q) {
    const long long i = a + t + q * TH, j = i + hop;
    v[q] = Cf{i >= 0 && i < tx ? sample_f32(row, i) : 0.0f,
              j >= 0 && j < tx ? sample_f32(row, j) : 0.0f};
  }
}

template <typename U>
WFT_INLINE void stream_store_t(const Cf* v, U* row, long long out_len,
                               long long q0, int hop, int t) {
  constexpr int P = StreamRows::P, TH = StreamRows::T;
  const int skip = StreamRows::n - hop;
  WFT_UNROLL
  for (int q = 0; q < P; ++q) {
    const int p = t + q * TH;
    if (p < skip) continue;
    const long long o = q0 + p;
    if (o < out_len) store_sample(row, o, v[q].re);
    if (o + hop < out_len) store_sample(row, o + hop, v[q].im);
  }
}

// Window pair (w, w + 1) of the channel whose samples start at element
// `row0` of x; u8 samples when u8, else f32.
WFT_INLINE void stream_load(const void* x, bool u8, long long row0,
                            long long tx, long long w, int hop, int start,
                            int t, Cf* v) {
  const long long a = w * hop + start;
  if (u8) {
    stream_load_t(static_cast<const uint8_t*>(x) + row0, tx, a, hop, t, v);
  } else {
    stream_load_t(static_cast<const float*>(x) + row0, tx, a, hop, t, v);
  }
}

WFT_INLINE void stream_store(const Cf* v, void* y, bool u8, long long row0,
                             long long out_len, long long w, int hop, int t) {
  const long long q0 = w * hop - (StreamRows::n - hop);
  if (u8) {
    stream_store_t(v, static_cast<uint8_t*>(y) + row0, out_len, q0, hop, t);
  } else {
    stream_store_t(v, static_cast<float*>(y) + row0, out_len, q0, hop, t);
  }
}

}  // namespace wft
