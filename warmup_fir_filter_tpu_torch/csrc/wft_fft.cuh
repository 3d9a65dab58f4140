// Per-thread cores of kernel L (osfilt.cu) and kernel M (osfilt_stream.cu):
// a shared-memory power-of-two complex f32 FFT, the spectral multiply, and
// the loads and stores around them.  Kernel K's row FFT has its own core,
// wft_fft_rows.cuh (Stockham passes in registers).
//
// Like wft_chain.cuh, this header also compiles as plain C++: the CPU tests
// build it with g++, run every CTA and thread of the two kernels in a host
// loop (the steps of a CTA one after another, where the kernels put a
// __syncthreads()) and hold the result against the plain PyTorch versions.
//
// The transform.  An n-point FFT (n = 2^log_n, 2 <= n <= 16,384) runs in
// place in shared memory as radix-2 stages fused in pairs (radix 2^2): a
// thread loads four points, runs two stages on them in registers and stores
// them back, so an n-point transform is ceil(log_n / 2) passes over shared
// memory with a barrier after each.  Decimation in frequency (DIF) takes
// natural order to bit-reversed order; decimation in time (DIT) takes
// bit-reversed order back to natural.  The filters (kernels L and M) run DIF
// forward, multiply by the filter spectrum stored in bit-reversed order, and
// DIT inverse: no permutation pass at all.  The inverse transform is the
// same with conjugated twiddles.
//
// Twiddles: tw[k] = exp(-2 pi i k / n), k < n / 2, computed in float64 on
// the host and stored as f32 (kernels/fft.py::fft_twiddles); a stage of half
// h uses W_2h^j = tw[j n / 2h].  No fast-math sine: the kernels must meet
// the JAX package's SNR bounds, which need about 1e-6 relative error.
//
// Layout: point i of an FFT lives at slot i + i / 32 of its buffer: one
// spare slot every 32 points.  A CTA transforms `count` FFTs, buffer f at
// f * fft_slots(n).
#pragma once

#include <math.h>

#include <cstdint>

#include "wft_chain.cuh"

namespace wft {

struct alignas(8) Cf {
  float re, im;
};

// Threads of a CTA of kernels L and M.
constexpr int kFftThreads = 512;
// Complex points a CTA transforms: several FFTs when n is small.
constexpr int kFftCtaPoints = 4096;
constexpr int kFftMaxLog2 = 14;
// Kernel M's transform: 512 points, 4 lane tiles of 128.
constexpr int kStreamLog2 = 9;
constexpr int kStreamN = 1 << kStreamLog2;

WFT_INLINE int fft_slot(int i) { return i + (i >> 5); }
WFT_INLINE int fft_slots(int n) { return n + (n >> 5); }
WFT_INLINE int fft_per_cta(int log_n) {
  return (1 << log_n) >= kFftCtaPoints ? 1 : kFftCtaPoints >> log_n;
}
// Shared bytes of a CTA: `count` buffers and the n / 2 twiddles.
WFT_INLINE int fft_shared_bytes(int log_n) {
  return static_cast<int>(sizeof(Cf)) *
         (fft_per_cta(log_n) * fft_slots(1 << log_n) + ((1 << log_n) >> 1));
}

WFT_INLINE Cf cadd(Cf a, Cf b) { return {a.re + b.re, a.im + b.im}; }
WFT_INLINE Cf csub(Cf a, Cf b) { return {a.re - b.re, a.im - b.im}; }
WFT_INLINE Cf cmul(Cf a, Cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
WFT_INLINE Cf twiddle(const Cf* tw, int k, bool inverse) {
  const Cf w = tw[k];
  return inverse ? Cf{w.re, -w.im} : w;
}

// tw_s[k] = tw[k] for k < n / 2.
WFT_INLINE void fft_stage_twiddles(const Cf* tw, Cf* tw_s, int log_n, int t,
                                   int threads) {
  for (int k = t; k < ((1 << log_n) >> 1); k += threads) tw_s[k] = tw[k];
}

// Steps of a transform: radix-2^2 pairs of stages, and one radix-2 stage
// when log_n is odd.  Step s runs the stages of half h = 2^(log_n - 1 - 2s)
// and h / 2 (DIF order; DIT runs the steps in reverse).
WFT_INLINE int fft_steps(int log_n) { return (log_n + 1) / 2; }

// Group g < count * n / 4 of a radix-2^2 step over stages 2q and q: the
// points i, i + q, i + 2q, i + 3q of FFT f with i = block * 4q + j, j < q.
struct Quad {
  Cf* b;
  int i, j;
};

WFT_INLINE Quad fft_quad(Cf* buf, int log_n, int log_q, int g) {
  const int f = g >> (log_n - 2);
  const int r = g & ((1 << (log_n - 2)) - 1);
  const int j = r & ((1 << log_q) - 1);
  return {buf + f * fft_slots(1 << log_n), ((r >> log_q) << (log_q + 2)) + j,
          j};
}

// The stage of half h = 1 (twiddle 1), the same in DIF and DIT: the last
// DIF stage and the first DIT stage when log_n is odd.
WFT_INLINE void fft_unit_stage(Cf* buf, int log_n, int count, int t,
                               int threads) {
  for (int g = t; g < (count << (log_n - 1)); g += threads) {
    Cf* b = buf + (g >> (log_n - 1)) * fft_slots(1 << log_n);
    const int i = (g & ((1 << (log_n - 1)) - 1)) << 1;
    const Cf a = b[fft_slot(i)], c = b[fft_slot(i + 1)];
    b[fft_slot(i)] = cadd(a, c);
    b[fft_slot(i + 1)] = csub(a, c);
  }
}

// One DIF step (stages h = 2q then q on the four points of each group).
WFT_INLINE void fft_dif_step(Cf* buf, int log_n, int s, const Cf* tw,
                             bool inverse, int count, int t, int threads) {
  const int log_h = log_n - 1 - 2 * s;
  if (log_h == 0) {
    fft_unit_stage(buf, log_n, count, t, threads);
    return;
  }
  const int log_q = log_h - 1, q = 1 << log_q;
  const int sh = log_n - log_q - 2;  // tw index of W_4q^j is j << sh
  for (int g = t; g < (count << (log_n - 2)); g += threads) {
    const Quad p = fft_quad(buf, log_n, log_q, g);
    const Cf a0 = p.b[fft_slot(p.i)], a1 = p.b[fft_slot(p.i + q)];
    const Cf a2 = p.b[fft_slot(p.i + 2 * q)], a3 = p.b[fft_slot(p.i + 3 * q)];
    const Cf w0 = twiddle(tw, p.j << sh, inverse);
    const Cf w1 = twiddle(tw, (p.j + q) << sh, inverse);
    const Cf w2 = twiddle(tw, p.j << (sh + 1), inverse);
    const Cf b0 = cadd(a0, a2), b2 = cmul(csub(a0, a2), w0);
    const Cf b1 = cadd(a1, a3), b3 = cmul(csub(a1, a3), w1);
    p.b[fft_slot(p.i)] = cadd(b0, b1);
    p.b[fft_slot(p.i + q)] = cmul(csub(b0, b1), w2);
    p.b[fft_slot(p.i + 2 * q)] = cadd(b2, b3);
    p.b[fft_slot(p.i + 3 * q)] = cmul(csub(b2, b3), w2);
  }
}

// One DIT step (stages q then 2q): the inverse of fft_dif_step's data flow;
// run s = fft_steps(log_n) - 1 down to 0.
WFT_INLINE void fft_dit_step(Cf* buf, int log_n, int s, const Cf* tw,
                             bool inverse, int count, int t, int threads) {
  const int log_h = log_n - 1 - 2 * s;
  if (log_h == 0) {
    fft_unit_stage(buf, log_n, count, t, threads);
    return;
  }
  const int log_q = log_h - 1, q = 1 << log_q;
  const int sh = log_n - log_q - 2;
  for (int g = t; g < (count << (log_n - 2)); g += threads) {
    const Quad p = fft_quad(buf, log_n, log_q, g);
    const Cf a0 = p.b[fft_slot(p.i)], a1 = p.b[fft_slot(p.i + q)];
    const Cf a2 = p.b[fft_slot(p.i + 2 * q)], a3 = p.b[fft_slot(p.i + 3 * q)];
    const Cf w0 = twiddle(tw, p.j << sh, inverse);
    const Cf w1 = twiddle(tw, (p.j + q) << sh, inverse);
    const Cf w2 = twiddle(tw, p.j << (sh + 1), inverse);
    const Cf c1 = cmul(a1, w2), c3 = cmul(a3, w2);
    const Cf b0 = cadd(a0, c1), b1 = csub(a0, c1);
    const Cf b2 = cadd(a2, c3), b3 = csub(a2, c3);
    const Cf d2 = cmul(b2, w0), d3 = cmul(b3, w1);
    p.b[fft_slot(p.i)] = cadd(b0, d2);
    p.b[fft_slot(p.i + 2 * q)] = csub(b0, d2);
    p.b[fft_slot(p.i + q)] = cadd(b1, d3);
    p.b[fft_slot(p.i + 3 * q)] = csub(b1, d3);
  }
}

// Point k of every FFT times spec[k]: the filter spectrum in the DIF's
// bit-reversed order, with the inverse's 1 / n folded in.
WFT_INLINE void fft_filter_thread(Cf* buf, int log_n, const Cf* spec,
                                  int count, int t, int threads) {
  const int n = 1 << log_n;
  for (int i = t; i < (count << log_n); i += threads) {
    Cf* b = buf + (i >> log_n) * fft_slots(n);
    const int k = i & (n - 1);
    b[fft_slot(k)] = cmul(b[fft_slot(k)], spec[k]);
  }
}

// The filter of kernels L and M between their load and store: the DIF
// forward, the product with the spectrum and the DIT inverse, as
// fft_filter_phases(log_n) phases with a barrier before each.  Phase ph of
// thread t.
WFT_INLINE int fft_filter_phases(int log_n) {
  return 2 * fft_steps(log_n) + 1;
}
WFT_INLINE void fft_filter_phase(Cf* buf, int log_n, int ph, const Cf* tw,
                                 const Cf* spec, int count, int t,
                                 int threads) {
  const int steps = fft_steps(log_n);
  if (ph < steps) {
    fft_dif_step(buf, log_n, ph, tw, false, count, t, threads);
  } else if (ph == steps) {
    fft_filter_thread(buf, log_n, spec, count, t, threads);
  } else {
    fft_dit_step(buf, log_n, 2 * steps - ph, tw, true, count, t, threads);
  }
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

// ---------------------------------------------------------------- kernel L
// CTA s0 filters the framed segments s0 .. s0 + 2 count - 1 of (batch, n):
// FFT f carries segment s0 + 2f as its real part and s0 + 2f + 1 as its
// imaginary part.  The filter is real, so the circular convolution of the
// pair is the pair of circular convolutions: one complex transform filters
// two segments.
template <typename T>
WFT_INLINE void osfilt_load_thread(const T* seg, long long batch, int log_n,
                                   long long s0, Cf* buf, int count, int t,
                                   int threads) {
  const int n = 1 << log_n;
  for (int i = t; i < (count << log_n); i += threads) {
    const long long s = s0 + 2 * (i >> log_n);
    const int k = i & (n - 1);
    Cf v{0.0f, 0.0f};
    if (s < batch) v.re = sample_f32(seg, s * n + k);
    if (s + 1 < batch) v.im = sample_f32(seg, (s + 1) * n + k);
    buf[(i >> log_n) * fft_slots(n) + fft_slot(k)] = v;
  }
}

template <typename U>
WFT_INLINE void osfilt_store_thread(const Cf* buf, long long batch, int log_n,
                                    long long s0, U* y, int count, int t,
                                    int threads) {
  const int n = 1 << log_n;
  for (int i = t; i < (count << log_n); i += threads) {
    const long long s = s0 + 2 * (i >> log_n);
    const int k = i & (n - 1);
    const Cf v = buf[(i >> log_n) * fft_slots(n) + fft_slot(k)];
    if (s < batch) store_sample(y, s * n + k, v.re);
    if (s + 1 < batch) store_sample(y, (s + 1) * n + k, v.im);
  }
}

// ---------------------------------------------------------------- kernel M
// Overlap-save straight off a (C, tx) stream, the geometry of
// fft_pallas.py::_stream_geometry: window w of a channel is the 512 samples
// from w * hop + base (zero outside [0, tx)), with hop = 128 * hop_tiles and
// base = 128 * (m_shift - c0), c0 = 4 - hop_tiles; its last `hop` circular
// outputs, p in [512 - hop, 512), are outputs q = w * hop + p - (512 - hop)
// of the call, written where q < out_len.  The filter spectrum carries the
// alignment shift d.  FFT f of CTA w0 carries windows w0 + 2f (real part)
// and w0 + 2f + 1 (imaginary part).
struct StreamPlan {
  long long tx, out_len;
  int hop, base;
};

template <typename T>
WFT_INLINE void stream_load_thread(const T* x_row, const StreamPlan& p,
                                   long long w0, Cf* buf, int count, int t,
                                   int threads) {
  for (int i = t; i < (count << kStreamLog2); i += threads) {
    const int f = i >> kStreamLog2;
    const int m = i & (kStreamN - 1);
    const long long pos = (w0 + 2 * f) * p.hop + p.base + m;
    Cf v{0.0f, 0.0f};
    if (pos >= 0 && pos < p.tx) v.re = sample_f32(x_row, pos);
    if (pos + p.hop >= 0 && pos + p.hop < p.tx) {
      v.im = sample_f32(x_row, pos + p.hop);
    }
    buf[f * fft_slots(kStreamN) + fft_slot(m)] = v;
  }
}

template <typename U>
WFT_INLINE void stream_store_thread(const Cf* buf, const StreamPlan& p,
                                    long long w0, U* y_row, int count, int t,
                                    int threads) {
  for (int i = t; i < count * p.hop; i += threads) {
    const int f = i / p.hop;
    const int u = i - f * p.hop;  // q - w * hop
    const Cf v =
        buf[f * fft_slots(kStreamN) + fft_slot(kStreamN - p.hop + u)];
    const long long q = (w0 + 2 * f) * p.hop + u;
    if (q < p.out_len) store_sample(y_row, q, v.re);
    if (q + p.hop < p.out_len) store_sample(y_row, q + p.hop, v.im);
  }
}

}  // namespace wft
