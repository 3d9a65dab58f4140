"""The DSP chain of the port (BASELINE config 5) against the JAX package's.

- ``chain_fused_plain`` (kernel J's plain version) against the JAX
  ``chain_forward_fused(precision="highest")``, run in interpret mode, over
  the six geometries of ``tests/test_chain_fused.py:122-129`` at ragged
  lengths: SNR > 95 dB (the JAX fused-vs-staged bound, ``:92``);
- ``rs_bounds`` windows, the first-sample rule and the ``"bf16"`` storage
  mode (> 40 dB against the f32 chain, ``tests/test_demod_chain.py:214``);
- the port's ``chain_forward`` against the JAX one for every backend
  (SNR > 90 dB: f32 paths against the JAX package's bf16x3 ones, ~114 dB
  against f64; ``"pallas"`` in ``tests/test_torch_fft.py``), and an
  unknown backend raising;
- ``ops/fftfilt.py`` at the bounds of ``tests/test_fftfilt.py:23-33`` and
  ``ops/demod.py`` at those of ``tests/test_demod_chain.py``;
- the per-thread cores of kernels H, I and J (``csrc/wft_chain.cuh``)
  built with g++ and run CTA by CTA on the host against the plain
  versions: H and I at >= 120 dB, J at > 95 dB (f32 sums and CUDA's
  atan2f against float64).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import chain_fused as jax_fused
from warmup_fir_filter_tpu.models import chain as jax_chain
from warmup_fir_filter_tpu.ops import demod as jax_demod
from warmup_fir_filter_tpu.ops import fftfilt as jax_fftfilt
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import chain_fused, fir_float
from warmup_fir_filter_tpu_torch.kernels import resample as rs_kernel
from warmup_fir_filter_tpu_torch.models.chain import ChainConfig, chain_forward
from warmup_fir_filter_tpu_torch.ops import demod, fftfilt
from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

#: (up, down, rs_taps, ch_taps, channels) of tests/test_chain_fused.py:122-129.
GEOMETRIES = [
    (2, 3, 63, 63, 8),      # flagship geometry
    (4, 3, 47, 31, 8),      # larger upsample, shorter filters
    (2, 1, 33, 97, 8),      # pure upsample, long channelizer
    (8, 5, 63, 129, 16),    # deep polyphase, max merged channelizer
    (1, 2, 31, 63, 8),      # pure decimation
    (2, 3, 95, 63, 24),     # longer resampler branches, 24 channels
]
GEOMETRY_IDS = [f"{g[0]}-{g[1]}-{g[2]}-{g[3]}-{g[4]}" for g in GEOMETRIES]


def _config(up, down, rs_taps, ch_taps, **kwargs) -> ChainConfig:
    return ChainConfig(resample_up=up, resample_down=down,
                       resample_taps=rs_taps, channelizer_taps=ch_taps,
                       **kwargs)


def _jax_seg_tiles(up, down, rs_taps) -> int:
    """The smallest superblock (output tiles) the JAX kernel takes for this
    geometry: fewer tiles per program keep interpret mode quick, and the
    function computed is the same."""
    h = np.zeros(rs_taps)
    h[rs_taps // 2] = 1.0
    _, k_rows, ds, beta0, j_count = jax_fused.build_resample_band(h, up, down)
    for seg in (8, 16, 32, 64):
        if (seg * ds) % 128 == 0 and jax_fused._halo_tiles_for(
                ds, beta0 - (j_count - 1), k_rows, seg * ds // 128):
            return seg
    raise AssertionError("no superblock fits")


def _fm(rng, channels, time_len, k_f=0.05):
    msg = rng.standard_normal((channels, time_len)) * 0.3
    re, im = demod.fm_modulate(msg, k_f)
    return re.astype(np.float32), im.astype(np.float32)


def _planes(re, im):
    return torch.from_numpy(re), torch.from_numpy(im)


def _plain(re, im, cfg: ChainConfig, precision="highest", rs_bounds=None):
    chain = chain_fused.FusedChain(
        cfg.resample_filter(), cfg.channelizer_filter(), cfg.resample_up,
        cfg.resample_down, cfg.demod_k_f, precision=precision)
    return chain_fused.chain_fused_plain(*_planes(re, im), chain,
                                         rs_bounds).numpy()


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_plain_matches_jax_fused(rng, geometry):
    up, down, rs_taps, ch_taps, channels = geometry
    cfg = _config(up, down, rs_taps, ch_taps)
    seg = _jax_seg_tiles(up, down, rs_taps)
    re, im = _fm(rng, channels, 2 * seg * 128 * down // up + 333)
    want = np.asarray(jax_fused.chain_forward_fused(
        re, im, cfg.resample_filter(), cfg.channelizer_filter(), up, down,
        cfg.demod_k_f, precision="highest", seg_tiles=seg), np.float64)
    got = _plain(re, im, cfg)
    assert got.shape == want.shape
    assert snr_db(got, want) > 95.0, geometry


@pytest.mark.parametrize("bounds", [(37, -50), (-300, 200), (500, -700)])
def test_rs_bounds_windows(rng, bounds):
    """A window of the resampled stream (``lo``, ``out_len + hi_off``), as
    the time-sharded chain passes it: inside, at and past both ends."""
    cfg = ChainConfig()
    seg = _jax_seg_tiles(2, 3, 63)
    re, im = _fm(rng, 8, 2 * seg * 192 + 333)
    out_len = -(-re.shape[1] * 2 // 3)
    rs_bounds = (bounds[0], out_len + bounds[1])
    want = np.asarray(jax_fused.chain_forward_fused(
        re, im, cfg.resample_filter(), cfg.channelizer_filter(), 2, 3,
        cfg.demod_k_f, precision="highest", seg_tiles=seg,
        rs_bounds=np.asarray(rs_bounds, np.int32)), np.float64)
    got = _plain(re, im, cfg, rs_bounds=rs_bounds)
    # Where the window leaves the channelized stream exactly zero at both
    # samples of a message, atan2(+-0, -0) is +-pi by numpy's rule (and
    # CUDA's atan2f), 0 by the JAX kernel's polynomial: a few messages at
    # the window's edges, left out here.
    pi_message = np.float32(np.pi) * np.float32(1 / (2 * np.pi * 0.05))
    degenerate = (want == 0.0) & np.isclose(np.abs(got), pi_message)
    assert degenerate.sum() <= 4 * got.shape[0]
    assert snr_db(got[~degenerate], want[~degenerate]) > 95.0
    assert snr_db(got, _plain(re, im, cfg)) < 60.0  # the window matters


def test_first_sample_zero(rng):
    cfg = ChainConfig()
    re, im = _fm(rng, 8, 3000)
    for precision in ("highest", "bf16"):
        got = _plain(re, im, cfg, precision=precision)
        np.testing.assert_array_equal(got[:, 0], 0.0)
        assert np.all(got[:, 1:] != 0.0)


def test_bf16_mode(rng):
    """bf16 storage against the f32 chain on a band-limited FM signal."""
    cfg = ChainConfig()
    msg = rng.standard_normal((8, 20_000)).astype(np.float32)
    msg = fftfilt.fir_overlap_save(torch.from_numpy(msg),
                                   design_lowpass(63, 0.05)).numpy()
    msg = msg / np.abs(msg).max()
    re, im = demod.fm_modulate(msg, cfg.demod_k_f)
    re, im = re.astype(np.float32), im.astype(np.float32)
    ref = _plain(re, im, cfg)
    got = _plain(re, im, cfg, precision="bf16")
    assert snr_db(ref, got) > 40.0
    chain = chain_fused.FusedChain(cfg.resample_filter(),
                                   cfg.channelizer_filter(), 2, 3,
                                   cfg.demod_k_f, precision="bf16")
    taps = chain.resampler.taps.numpy()
    assert np.array_equal(taps, torch.from_numpy(taps).to(torch.bfloat16)
                          .to(torch.float32).numpy())


BACKENDS = [dict(channelizer_backend="auto"),
            dict(channelizer_backend="fused"),
            dict(channelizer_backend="mxu"),
            dict(channelizer_backend="jnp"),
            dict(use_fft_channelizer=False)]


@pytest.mark.parametrize("kwargs", BACKENDS,
                         ids=[next(iter(k.values())).__str__()
                              for k in BACKENDS])
def test_chain_forward_matches_jax(rng, kwargs):
    re, im = _fm(rng, 8, 3000)
    got = chain_forward(*_planes(re, im), ChainConfig(**kwargs))
    want = np.asarray(jax_chain.chain_forward(
        re, im, jax_chain.ChainConfig(**kwargs)), np.float64)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert snr_db(want, got.numpy()) > 90.0


def test_chain_forward_long_channelizer_takes_fft(monkeypatch, rng):
    """``"auto"`` above 257 channelizer taps: ``torch.fft``."""
    def refuse(*args, **kwargs):
        raise AssertionError("band channelizer taken above 257 taps")

    import warmup_fir_filter_tpu_torch.models.chain as port_chain

    monkeypatch.setattr(port_chain, "fir1d_ideal_rows_band", refuse)
    re, im = _fm(rng, 2, 4000)
    cfg = ChainConfig(channelizer_taps=301)
    got = chain_forward(*_planes(re, im), cfg)
    want = np.asarray(jax_chain.chain_forward(
        re, im, jax_chain.ChainConfig(channelizer_taps=301,
                                      channelizer_backend="jnp")))
    assert snr_db(want, got.numpy()) > 90.0


def test_chain_recovers_lowpass_message():
    """``tests/test_demod_chain.py:53-68``: correlation > 0.99."""
    config = ChainConfig()
    t = np.arange(6000)
    message = 0.5 * np.cos(2 * np.pi * 0.002 * t)[None, :].repeat(2, 0)
    re, im = demod.fm_modulate(message, config.demod_k_f)
    out = chain_forward(torch.from_numpy(re), torch.from_numpy(im),
                        config).numpy().astype(np.float64)
    assert out.shape == (2, -(-6000 * 2 // 3))
    expected = 0.5 * np.cos(2 * np.pi * 0.002 * np.arange(out.shape[1]) * 1.5)
    core = slice(200, -200)
    assert np.corrcoef(out[0, core], expected[core])[0, 1] > 0.99


def test_unknown_backend_raises(rng):
    re, im = _planes(*_fm(rng, 8, 3000))
    with pytest.raises(ValueError, match="channelizer_backend"):
        chain_forward(re, im, ChainConfig(channelizer_backend="cuda"))


def test_forced_fused_raises_where_unsupported(rng):
    re, im = _planes(*_fm(rng, 8, 3000))
    with pytest.raises(ValueError, match="fused"):
        chain_forward(re, im, ChainConfig(channelizer_backend="fused",
                                          resample_up=3, resample_down=2))
    with pytest.raises(ValueError, match="use_fft_channelizer"):
        chain_forward(re, im, ChainConfig(channelizer_backend="fused",
                                          use_fft_channelizer=False))
    with pytest.raises(ValueError, match="not supported"):
        chain_fused.chain_forward_fused(re[:4], im[:4], design_lowpass(63, .3),
                                        design_lowpass(63, .25), 2, 3, 0.05)


def test_supported_gives_the_jax_answers():
    for channels in (1, 8, 12, 16, 24, 128, 136):
        for up, down in ((2, 3), (3, 2), (1, 2), (8, 5), (2, 1), (1, 7),
                         (16, 3), (128, 1), (4, 9)):
            for rs_taps, ch_taps in ((63, 63), (31, 257), (95, 258),
                                     (401, 63), (3, 5)):
                args = (channels, up, down, rs_taps, ch_taps)
                assert (chain_fused.chain_fused_supported(*args)
                        == jax_fused.chain_fused_supported(*args)), args


def test_validation(rng):
    re, im = _planes(*_fm(rng, 8, 3000))
    h_rs, h_ch = design_lowpass(63, 0.3), design_lowpass(63, 0.25)
    with pytest.raises(ValueError, match="precision"):
        chain_fused.chain_forward_fused(re, im, h_rs, h_ch, 2, 3, 0.05,
                                        precision="fast")
    with pytest.raises(ValueError, match="k_f"):
        chain_fused.chain_forward_fused(re, im, h_rs, h_ch, 2, 3, -1.0)
    with pytest.raises(ValueError, match="matching"):
        chain_fused.chain_forward_fused(re[:, :-1], im, h_rs, h_ch, 2, 3,
                                        0.05)


def test_cpu_planes_launch_no_kernel(rng):
    counters = (chain_fused.chain_fused, fir_float.fir_float,
                rs_kernel.resample)
    before = [k.launches for k in counters]
    re, im = _planes(*_fm(rng, 8, 2000))
    for backend in ("auto", "fused", "mxu"):
        chain_forward(re, im, ChainConfig(channelizer_backend=backend))
    assert [k.launches for k in counters] == before


# ------------------------------------------------------------- fftfilt, demod


def test_fftfilt_matches_ideal_small(rng):
    h = rng.uniform(-0.5, 0.5, 7)
    x = rng.integers(0, 256, size=(3, 500), dtype=np.uint8)
    ideal = fir1d_ideal_golden_rows(x, h)
    got = fftfilt.fir_overlap_save(torch.from_numpy(x), h).numpy()
    np.testing.assert_allclose(got, ideal, atol=2e-2)
    assert snr_db(ideal, got) > 80.0


def test_fftfilt_63tap_snr_contract(rng):
    h = rng.uniform(-0.1, 0.1, 63)
    x = rng.integers(0, 256, size=(4, 10_000), dtype=np.uint8)
    got = fftfilt.fir_overlap_save(torch.from_numpy(x), h).numpy()
    assert snr_db(fir1d_ideal_golden_rows(x, h), got) > 70.0
    want = np.asarray(jax_fftfilt.fir_overlap_save(x, h))
    assert snr_db(want, got) > 100.0


def test_fftfilt_block_boundaries_and_quantized(rng):
    h = np.zeros(9)
    h[2] = 1.0
    x = rng.integers(0, 256, size=(2, 1000), dtype=np.uint8)
    got = fftfilt.fir_overlap_save(torch.from_numpy(x), h, nfft=16).numpy()
    np.testing.assert_allclose(got, fir1d_ideal_golden_rows(x, h), atol=1e-3)
    h = rng.uniform(-0.2, 0.4, 5)
    q = fftfilt.fir_overlap_save_quantized(torch.from_numpy(x), h)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax_fftfilt.fir_overlap_save_quantized(x, h)))
    assert snr_db(fir1d_fixed_golden_rows(x, h), q.numpy()) > 40.0
    assert fftfilt.pick_nfft(63) == jax_fftfilt.pick_nfft(63) == 512
    with pytest.raises(ValueError, match="nfft"):
        fftfilt.fir_overlap_save(torch.from_numpy(x), np.ones(20), nfft=16)


def test_demod_matches_golden_and_jax(rng):
    k_f = 0.08
    message = rng.uniform(-1, 1, size=(2, 300))
    re, im = demod.fm_modulate(message, k_f)
    np.testing.assert_array_equal(
        np.stack(jax_demod.fm_modulate(message, k_f)), np.stack((re, im)))
    got = demod.fm_demodulate(torch.from_numpy(re), torch.from_numpy(im),
                              k_f).numpy()
    np.testing.assert_allclose(got, demod.fm_demodulate_golden(re, im, k_f),
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_demod.fm_demodulate(
        re, im, k_f)), atol=1e-5)
    np.testing.assert_array_equal(got[:, 0], 0.0)
    np.testing.assert_allclose(got[:, 1:], message[:, 1:], atol=1e-3)
    with pytest.raises(ValueError, match="k_f"):
        demod.fm_demodulate(torch.ones((1, 4)), torch.ones((1, 4)), 0.0)


# ------------------------------------------------------------ the host cores

_HARNESS = r"""
#include <cstdint>
#include <cstring>
#include <vector>

#include "wft_chain.cuh"

using wft::kChainThreads;
using wft::kChainTile;
using wft::kTileR;

extern "C" void fir_float_host(const void* x, int x_is_u8, float* y,
                               long long rows, long long n, const float* h,
                               int taps) {
  std::vector<float> w(wft::fir_float_window(taps));
  const int width = static_cast<int>(w.size());
  for (long long row = 0; row < rows; ++row) {
    for (long long o0 = 0; o0 < n; o0 += kChainTile) {
      const long long base = wft::fir_float_base(o0, taps);
      for (int t = 0; t < kChainThreads; ++t) {
        if (x_is_u8) {
          wft::stage_window(static_cast<const uint8_t*>(x) + row * n, n, base,
                            w.data(), width, t, kChainThreads);
        } else {
          wft::stage_window(static_cast<const float*>(x) + row * n, n, base,
                            w.data(), width, t, kChainThreads);
        }
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::fir_float_thread(w.data(), h, taps, t, y + row * n, n, o0);
      }
    }
  }
}

// The per-thread core of down-rate q's route on one window, and poly_dot
// for each of its outputs a + q u: the tiled core's group of kTileR outputs
// where q has one, else the compact route's poly_dot4 over four.  Returns
// the outputs written.
extern "C" int core_dot_host(const float* w, int a, int q, const float* taps,
                             int len, float* got, float* want) {
  const int count = wft::with_core(
      q <= wft::kMaxTiledDown ? q : 0, [&](auto core) {
        constexpr int Q = decltype(core)::value;
        if constexpr (Q > 0) {
          const wft::TapLayout l = wft::tap_layout(Q, len);
          std::vector<float> table(l.row);
          wft::stage_taps(taps, 1, len, len, l, table.data(), 0, 1);
          float acc[kTileR];
          wft::group_dot<Q>(w, a, table.data(), len, l, acc);
          std::memcpy(got, acc, sizeof acc);
          return kTileR;
        } else {
          float acc[wft::kChainPerThread];
          wft::poly_dot4(w, a, q, taps, len, acc);
          std::memcpy(got, acc, sizeof acc);
          return wft::kChainPerThread;
        }
      });
  for (int u = 0; u < count; ++u) want[u] = wft::poly_dot(w, a + q * u, taps, len);
  return count;
}

// The route of kernel I (kind 0) or J (kind 1) for a shape: its core and
// *bytes of shared memory, as the launches pick them.
extern "C" int route_host(int kind, int up, int down, int center, int len,
                          int stride, int ch_len, long long* bytes) {
  const wft::PolyPlan p{up, down, center, len, stride};
  wft::ChainPlan c;
  c.rs = p;
  c.ch_taps = ch_len;
  const wft::Route r = kind ? wft::chain_route(c) : wft::resample_route(p);
  *bytes = r.shared_bytes;
  return r.core;
}

// Kernel I's CTAs in order, each stage a loop over the threads.  The tiled
// route: three CTAs, each walking every third item of the (rows, tiles)
// grid, as the card's CTAs walk theirs.
template <int Q>
void resample_rows(const float* x, float* y, long long rows, long long n,
                   long long out_len, const float* taps,
                   const wft::PolyPlan& p) {
  const wft::ResampleLayout l = wft::resample_layout(p);
  std::vector<float> smem(l.total);
  float* ys = smem.data() + l.out_at;
  for (int t = 0; t < kChainThreads; ++t) {
    wft::stage_taps(taps, p.up, p.tap_stride, p.len, l.taps, smem.data(), t,
                    kChainThreads);
  }
  const long long tiles =
      (out_len + wft::kResampleTile - 1) / wft::kResampleTile;
  const long long ctas = rows * tiles < 3 ? rows * tiles : 3;
  for (long long b = 0; b < ctas; ++b) {
    wft::TileWalk item = wft::walk_start(b, tiles);
    for (int t = 0; t < kChainThreads; ++t) {
      wft::resample_prefetch(x, n, p, item, smem.data() + l.stage_at, l.stage,
                             t, kChainThreads);
    }
    for (int k = 0; item.row < rows; ++k) {
      const wft::TileWalk next = wft::walk_next(item, ctas, tiles);
      if (next.row < rows) {
        for (int t = 0; t < kChainThreads; ++t) {
          wft::resample_prefetch(
              x, n, p, next, smem.data() + l.stage_at + ((k + 1) & 1) * l.stage,
              l.stage, t, kChainThreads);
        }
      }
      const long long m0 = item.tile * wft::kResampleTile;
      const wft::PolyRun r = wft::poly_run(m0, p);
      const int count = static_cast<int>(
          out_len - m0 < wft::kResampleTile ? out_len - m0
                                            : wft::kResampleTile);
      for (int t = 0; t < kChainThreads; ++t) {
        float acc[kTileR];
        wft::resample_thread<Q>(smem.data() + l.stage_at + (k & 1) * l.stage,
                                wft::run_x0(r, p), smem.data(), l, p, r, t,
                                acc);
        wft::resample_put(acc, p, r, t, ys);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::store_run(ys, y + item.row * out_len + m0, count, t,
                       kChainThreads);
      }
      item = next;
    }
  }
}

// The compact route: CTA (row, m0) after CTA.
template <>
void resample_rows<0>(const float* x, float* y, long long rows, long long n,
                      long long out_len, const float* taps,
                      const wft::PolyPlan& p) {
  std::vector<float> w(wft::resample_compact_window(p));
  const int width = static_cast<int>(w.size());
  for (long long row = 0; row < rows; ++row) {
    for (long long m0 = 0; m0 < out_len; m0 += kChainTile) {
      for (int t = 0; t < kChainThreads; ++t) {
        wft::stage_window(x + row * n, n, wft::resample_compact_base(m0, p),
                          w.data(), width, t, kChainThreads);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::resample_compact_thread(w.data(), taps, p, t, y + row * out_len,
                                     out_len, m0);
      }
    }
  }
}

// Kernel I on the host by the route the launch picks; returns its core.
extern "C" int resample_host(const float* x, float* y, long long rows,
                             long long n, long long out_len,
                             const float* taps, int up, int down,
                             int center, int len, int stride) {
  const wft::PolyPlan p{up, down, center, len, stride};
  const wft::Route route = wft::resample_route(p);
  if (route.core < 0) return route.core;
  wft::with_core(route.core, [&](auto core) {
    resample_rows<decltype(core)::value>(x, y, rows, n, out_len, taps, p);
  });
  return route.core;
}

// Output m of one row by poly_dot over the zero-extended row.
float resample_ref(const float* x, long long n, long long m,
                   const float* taps, const wft::PolyPlan& p,
                   std::vector<float>& w) {
  const long long b = wft::poly_anchor(m, p);
  w.resize(p.len);
  for (int j = 0; j < p.len; ++j) {
    const long long i = b - (p.len - 1) + j;
    w[j] = (i >= 0 && i < n) ? x[i] : 0.0f;
  }
  return wft::poly_dot(w.data(), p.len - 1,
                       taps + wft::poly_branch(m, p) * p.tap_stride, p.len);
}

extern "C" void resample_ref_host(const float* x, float* y, long long rows,
                                  long long n, long long out_len,
                                  const float* taps, int up, int down,
                                  int center, int len, int stride) {
  const wft::PolyPlan p{up, down, center, len, stride};
  std::vector<float> w;
  for (long long row = 0; row < rows; ++row) {
    for (long long m = 0; m < out_len; ++m) {
      y[row * out_len + m] = resample_ref(x + row * n, n, m, taps, p, w);
    }
  }
}

wft::ChainPlan chain_plan(int up, int down, int center, int len, int stride,
                          int ch_len, long long lo, long long hi,
                          float inv_gain, int bf16) {
  wft::ChainPlan c;
  c.rs = wft::PolyPlan{up, down, center, len, stride};
  c.ch_taps = ch_len;
  c.lo = lo;
  c.hi = hi;
  c.inv_gain = inv_gain;
  c.bf16 = bf16 != 0;
  return c;
}

// Kernel J's CTAs in order, each stage a loop over the threads.  The tiled
// route: three CTAs, each walking every third item (channel, tile), as the
// card's CTAs walk theirs.
template <typename T, int Q>
void chain_rows(const T* re, const T* im, float* y, long long channels,
                long long n, long long out_len, const float* rs_taps,
                const float* ch_taps, const wft::ChainPlan& c) {
  const wft::ChainLayout l = wft::chain_layout(c);
  std::vector<float> smem(l.total);
  float* rs = smem.data() + l.rs_at;
  for (int t = 0; t < kChainThreads; ++t) {
    wft::stage_taps(rs_taps, c.rs.up, c.rs.tap_stride, c.rs.len, l.rs_taps,
                    smem.data(), t, kChainThreads);
    wft::stage_taps(ch_taps, 1, c.ch_taps, c.ch_taps, l.ch_taps,
                    smem.data() + l.ch_taps_at, t, kChainThreads);
  }
  const long long tiles = (out_len + c.tile - 1) / c.tile;
  const long long ctas = channels * tiles < 3 ? channels * tiles : 3;
  for (long long b = 0; b < ctas; ++b) {
    wft::TileWalk item = wft::walk_start(b, tiles);
    for (int t = 0; t < kChainThreads; ++t) {
      wft::chain_prefetch(re, im, n, c, l, item, 0, smem.data(), t,
                          kChainThreads);
    }
    for (int k = 0; item.row < channels; ++k) {
      const wft::TileWalk next = wft::walk_next(item, ctas, tiles);
      if (next.row < channels) {
        for (int t = 0; t < kChainThreads; ++t) {
          wft::chain_prefetch(re, im, n, c, l, next, k + 1, smem.data(), t,
                              kChainThreads);
        }
      }
      if (c.bf16) {
        for (int t = 0; t < kChainThreads; ++t) {
          wft::chain_widen(smem.data(), l, c, k, t, kChainThreads);
        }
      }
      float* windows = wft::chain_windows(smem.data(), l, c, k);
      const long long m0 = item.tile * c.tile;
      const wft::PolyRun r = wft::chain_run(m0, c);
      for (int t = 0; t < kChainThreads; ++t) {
        wft::chain_resample_thread<Q>(smem.data(), windows, l, c, r,
                                      wft::run_x0(r, c.rs), t, kChainThreads,
                                      rs, m0);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::chain_channelize_thread(smem.data(), rs, l, c, t, kChainThreads,
                                     windows);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::chain_demod_thread(windows, windows + l.plane, c, t,
                                kChainThreads, rs, m0);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::store_run(rs, y + item.row * out_len + m0,
                       static_cast<int>(out_len - m0 < c.tile ? out_len - m0
                                                              : c.tile),
                       t, kChainThreads);
      }
      item = next;
    }
  }
}

// The compact route: CTA (channel, m0) after CTA.
template <typename T>
void chain_compact_rows(const T* re, const T* im, float* y,
                        long long channels, long long n, long long out_len,
                        const float* rs_taps, const float* ch_taps,
                        const wft::ChainPlan& c) {
  const int in_w = static_cast<int>(wft::chain_compact_window(c));
  std::vector<float> xs(2 * in_w), rs(2 * c.rs_count),
      ch(2 * (kChainTile + 1));
  for (long long row = 0; row < channels; ++row) {
    for (long long m0 = 0; m0 < out_len; m0 += kChainTile) {
      const long long in0 = wft::chain_compact_base(m0, c);
      for (int t = 0; t < kChainThreads; ++t) {
        for (int plane = 0; plane < 2; ++plane) {
          wft::stage_window((plane ? im : re) + row * n, n, in0,
                            xs.data() + plane * in_w, in_w, t, kChainThreads);
        }
      }
      for (int t = 0; t < kChainThreads; ++t) {
        for (int plane = 0; plane < 2; ++plane) {
          wft::chain_compact_resample(xs.data() + plane * in_w, rs_taps, c, t,
                                      rs.data() + plane * c.rs_count, m0);
        }
      }
      for (int t = 0; t < kChainThreads; ++t) {
        for (int plane = 0; plane < 2; ++plane) {
          wft::chain_compact_channelize(rs.data() + plane * c.rs_count,
                                        ch_taps, c, t,
                                        ch.data() + plane * (kChainTile + 1));
        }
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::chain_compact_demod(ch.data(), ch.data() + kChainTile + 1, c, t,
                                 y + row * out_len, out_len, m0);
      }
    }
  }
}

template <typename T>
void chain_by_route(const void* re, const void* im, float* y,
                    long long channels, long long n, long long out_len,
                    const float* rs_taps, const float* ch_taps,
                    const wft::ChainPlan& c, int core) {
  const T* r = static_cast<const T*>(re);
  const T* i = static_cast<const T*>(im);
  wft::with_core(core, [&](auto q) {
    constexpr int Q = decltype(q)::value;
    if constexpr (Q > 0) {
      chain_rows<T, Q>(r, i, y, channels, n, out_len, rs_taps, ch_taps, c);
    } else {
      chain_compact_rows<T>(r, i, y, channels, n, out_len, rs_taps, ch_taps,
                            c);
    }
  });
}

extern "C" void demod_host(const float* ch_re, const float* ch_im, float* y,
                           long long m0, float inv_gain) {
  wft::ChainPlan c;
  c.inv_gain = inv_gain;
  c.tile = kChainTile;
  std::vector<float> out(kChainTile);
  for (int t = 0; t < kChainThreads; ++t) {
    wft::chain_demod_thread(ch_re, ch_im, c, t, kChainThreads, out.data(), m0);
  }
  std::memcpy(y + m0, out.data(), kChainTile * sizeof(float));
}

// Kernel J on the host by the route the launch picks; returns its core.
extern "C" int chain_host(const void* re, const void* im, int bf16,
                          float* y, long long channels, long long n,
                          long long out_len, const float* rs_taps, int up,
                          int down, int center, int len, int stride,
                          const float* ch_taps, int ch_len, long long lo,
                          long long hi, float inv_gain) {
  wft::ChainPlan c = chain_plan(up, down, center, len, stride, ch_len, lo, hi,
                                inv_gain, bf16);
  const wft::Route route = wft::chain_route(c);
  if (route.core < 0) return route.core;
  if (c.bf16) {
    chain_by_route<uint16_t>(re, im, y, channels, n, out_len, rs_taps,
                             ch_taps, c, route.core);
  } else {
    chain_by_route<float>(re, im, y, channels, n, out_len, rs_taps, ch_taps,
                          c, route.core);
  }
  return route.core;
}

// The chain of one row by poly_dot, stage after stage over the whole row:
// the resampled samples -1 - left .. out_len - 1 + center, the channelized
// samples -1 .. out_len - 1, the messages.
template <typename T>
void chain_ref_row(const T* re, const T* im, float* y, long long n,
                   long long out_len, const float* rs_taps,
                   const float* ch_taps, const wft::ChainPlan& c) {
  const long long qa = -1 - wft::chain_ch_left(c);
  const long long count = out_len + c.ch_taps;
  std::vector<float> rs[2], ch[2], x(n), w;
  for (int plane = 0; plane < 2; ++plane) {
    for (long long i = 0; i < n; ++i) x[i] = wft::sample_f32(plane ? im : re, i);
    rs[plane].resize(count);
    for (long long k = 0; k < count; ++k) {
      const float v = resample_ref(x.data(), n, qa + k, rs_taps, c.rs, w);
      rs[plane][k] = wft::chain_rs_value(v, qa + k, c);
    }
    ch[plane].resize(out_len + 1);
    for (long long m = -1; m < out_len; ++m) {
      ch[plane][m + 1] = wft::poly_dot(rs[plane].data(),
                                       static_cast<int>(m + c.ch_taps - 1 - wft::chain_ch_left(c) - qa),
                                       ch_taps, c.ch_taps);
    }
  }
  for (long long m = 0; m < out_len; ++m) {
    y[m] = wft::fm_message(ch[0][m + 1], ch[1][m + 1], ch[0][m], ch[1][m], m,
                           c.inv_gain);
  }
}

extern "C" void chain_ref_host(const void* re, const void* im, int bf16,
                               float* y, long long channels, long long n,
                               long long out_len, const float* rs_taps, int up,
                               int down, int center, int len, int stride,
                               const float* ch_taps, int ch_len, long long lo,
                               long long hi, float inv_gain) {
  const wft::ChainPlan c = chain_plan(up, down, center, len, stride, ch_len,
                                      lo, hi, inv_gain, bf16);
  for (long long row = 0; row < channels; ++row) {
    if (c.bf16) {
      chain_ref_row(static_cast<const uint16_t*>(re) + row * n,
                    static_cast<const uint16_t*>(im) + row * n,
                    y + row * out_len, n, out_len, rs_taps, ch_taps, c);
    } else {
      chain_ref_row(static_cast<const float*>(re) + row * n,
                    static_cast<const float*>(im) + row * n,
                    y + row * out_len, n, out_len, rs_taps, ch_taps, c);
    }
  }
}
"""


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    """Kernels H, I and J's cores (``csrc/wft_chain.cuh``) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("chain_cores")
    (work / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fir_float_host.argtypes = [vp, i32, vp, ll, ll, vp, i32]
    lib.resample_host.argtypes = [vp, vp, ll, ll, ll, vp, i32, i32, i32, i32,
                                  i32]
    lib.chain_host.argtypes = [vp, vp, i32, vp, ll, ll, ll, vp, i32, i32, i32,
                               i32, i32, vp, i32, ll, ll, ctypes.c_float]
    lib.chain_ref_host.argtypes = lib.chain_host.argtypes
    lib.resample_ref_host.argtypes = lib.resample_host.argtypes
    lib.core_dot_host.argtypes = [vp, i32, i32, vp, i32, vp, vp]
    lib.route_host.argtypes = [i32, i32, i32, i32, i32, i32, i32,
                               ctypes.POINTER(ll)]
    lib.demod_host.argtypes = [vp, vp, vp, ll, ctypes.c_float]
    return lib


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


def _run_fir(lib, x: np.ndarray, fir) -> np.ndarray:
    x = np.ascontiguousarray(x)
    y = np.empty(x.shape, np.float32)
    taps = _np(fir.taps)
    lib.fir_float_host(x.ctypes.data, int(x.dtype == np.uint8), y.ctypes.data,
                       x.shape[0], x.shape[1], taps.ctypes.data, fir.num_taps)
    return y


def _route(lib, rs, ch_taps=None) -> int:
    """The core of the route kernel I (kernel J with a channelizer of
    ``ch_taps``) takes for the resampler ``rs``: Q for a tiled core, 0 for
    the compact route."""
    bytes_ = ctypes.c_longlong()
    return lib.route_host(int(ch_taps is not None), rs.up, rs.down, rs.center,
                          rs.branch_len, rs.tap_stride, ch_taps or 0,
                          ctypes.byref(bytes_))


def _run_resample(lib, x: np.ndarray, rs, ref=False) -> np.ndarray:
    """Kernel I's CTAs on the host by the launch's route; with ``ref``,
    every output by ``poly_dot`` over the zero-extended row."""
    x = np.ascontiguousarray(x, np.float32)
    out_len = rs.out_len(x.shape[1])
    y = np.full((x.shape[0], out_len), np.nan, np.float32)
    taps = _np(rs.taps)
    (lib.resample_ref_host if ref else lib.resample_host)(x.ctypes.data, y.ctypes.data, x.shape[0], x.shape[1],
                      out_len, taps.ctypes.data, rs.up, rs.down, rs.center,
                      rs.branch_len, rs.tap_stride)
    return y


def _run_chain(lib, re: np.ndarray, im: np.ndarray, chain,
               rs_bounds=None, ref=False) -> np.ndarray:
    """Kernel J's CTAs on the host by the launch's route; with ``ref``, the
    chain of each row stage by stage through ``poly_dot``."""
    if chain.bf16:
        re, im = (_np(torch.from_numpy(p).to(torch.bfloat16)
                      .view(torch.int16)).view(np.uint16) for p in (re, im))
    re, im = np.ascontiguousarray(re), np.ascontiguousarray(im)
    rs, fir = chain.resampler, chain.channelizer
    out_len = rs.out_len(re.shape[1])
    lo, hi = (0, out_len) if rs_bounds is None else rs_bounds
    y = np.full((re.shape[0], out_len), np.nan, np.float32)
    rs_taps, ch_taps = _np(rs.taps), _np(fir.taps)
    (lib.chain_ref_host if ref else lib.chain_host)(
                   re.ctypes.data, im.ctypes.data, int(chain.bf16),
                   y.ctypes.data, re.shape[0], re.shape[1], out_len,
                   rs_taps.ctypes.data, rs.up, rs.down, rs.center,
                   rs.branch_len, rs.tap_stride, ch_taps.ctypes.data,
                   fir.num_taps, lo, hi, chain.inv_gain)
    return y


#: Down-rates of the tiled core: P/Q 1/1, 3/2, 2/3, 1/4 and 4/5 (the
#: compiled cores), and 2/9 (the compact route's poly_dot4).
TILED_DOWN = [1, 2, 3, 4, 5, 9]


@pytest.mark.parametrize("down", TILED_DOWN)
def test_tiled_core_equals_poly_dot(cores, rng, down):
    """Each of a group's nine outputs (the compact route's four) equals
    ``poly_dot`` on the same window bit for bit: branch lengths 1, 31, 32
    and 129 and channelizer lengths 1, 2, 63 and 257 (whole groups of the
    window's width and ragged tails), at random anchors, with samples and
    taps of mixed scales."""
    for length in (1, 2, 31, 32, 63, 129, 257):
        width = length + down * (wft_tile_r() - 1) + 5
        for _ in range(3):
            w = (rng.standard_normal(width)
                 * 10.0 ** rng.integers(-3, 4, width)).astype(np.float32)
            taps = rng.standard_normal(length).astype(np.float32)
            a = int(rng.integers(length - 1, width - down * 8))
            got = np.full(9, np.nan, np.float32)
            want = np.full(9, np.nan, np.float32)
            count = cores.core_dot_host(w.ctypes.data, a, down,
                                        taps.ctypes.data, length,
                                        got.ctypes.data, want.ctypes.data)
            assert count == (9 if down <= 5 else 4)
            assert np.isfinite(want[:count]).all()
            np.testing.assert_array_equal(got, want, err_msg=f"{length}")


def wft_tile_r() -> int:
    """Outputs a group of the tiled cores (``kTileR``)."""
    return 9


def _width_for(out_len: int, up: int, down: int) -> int:
    """An input width whose ``ceil(n P / Q)`` is ``out_len`` where one is."""
    guess = max(1, out_len * down // up)
    for n in range(max(1, guess - 3), guess + 4):
        if -(-n * up // down) == out_len:
            return n
    return guess


#: P/Q with P | 256, as kernel I takes them: tiled cores, and on the
#: compact route 2/9, 1/16 and 1/56 (past the tiled cores).
RESAMPLE_EXACT_RATES = [(1, 1), (2, 3), (4, 5), (1, 4), (8, 5), (128, 3),
                        (2, 9), (1, 16), (1, 56)]


@pytest.mark.parametrize("up,down", RESAMPLE_EXACT_RATES)
def test_resample_core_equals_poly_dot(cores, rng, up, down):
    """Kernel I's CTAs, bit for bit against ``poly_dot`` per output: branch
    lengths 1, 31, 32 and 129; outputs 1, 8 and 10 (a group and one either
    side), ragged, and past one and two 2,304-output tiles, so that groups
    straddle a tile's end (the compact route's 1,024-output tiles too)."""
    for branch in (1, 31, 32, 129):
        h = rng.standard_normal(up * branch - (up > 1)).astype(np.float32)
        rs = rs_kernel.PolyphaseResampler(h, up, down)
        for out_len in (1, 8, 10, 777, 2309, 4700):
            x = rng.standard_normal((2, _width_for(out_len, up, down)))
            got = _run_resample(cores, x, rs)
            assert np.isfinite(got).all()
            np.testing.assert_array_equal(got, _run_resample(cores, x, rs,
                                                             ref=True))


#: (up, down, rs_taps, ch_taps, precision, rs_bounds offsets or None).
#: 2/9, 1/8 and the 20,001-tap 2/1 take the compact route.
CHAIN_EXACT_CASES = [
    (2, 3, 63, 63, "highest", None),
    (2, 3, 63, 63, "bf16", None),
    (2, 3, 63, 63, "highest", (37, -50)),
    (2, 3, 63, 63, "bf16", (-300, 200)),
    (2, 3, 63, 63, "highest", (2500, -2600)),
    (4, 3, 47, 31, "highest", None),
    (2, 1, 33, 97, "bf16", None),
    (8, 5, 63, 129, "highest", None),
    (1, 2, 31, 63, "highest", None),
    (2, 3, 95, 257, "highest", None),
    (4, 5, 63, 2, "highest", None),
    (1, 4, 31, 1, "bf16", None),
    (1, 1, 1, 63, "highest", None),
    (2, 9, 63, 63, "highest", (11, -7)),
    (1, 3, 63, 63, "highest", None),
    (1, 8, 63, 63, "highest", None),
    (1, 8, 63, 63, "bf16", (37, -50)),
    (2, 1, 20001, 63, "highest", None),
]


@pytest.mark.parametrize("case", CHAIN_EXACT_CASES, ids=str)
def test_chain_core_equals_poly_dot(cores, rng, case):
    """Kernel J's CTAs, bit for bit against the chain computed stage by
    stage with ``poly_dot`` over whole rows: the resampled stream zeroed
    outside ``rs_bounds`` (and rounded to bf16 in "bf16" mode), the
    channelizer, the discriminator.  Lengths run past two tiles."""
    up, down, rs_taps, ch_taps, precision, bounds = case
    cfg = _config(up, down, rs_taps, ch_taps)
    # A one-tap design is 0/0 (design_lowpass's window): one tap of 0.8.
    h_rs = cfg.resample_filter() if rs_taps > 1 else np.array([0.8])
    h_ch = cfg.channelizer_filter() if ch_taps > 1 else np.array([0.8])
    chain = chain_fused.FusedChain(h_rs, h_ch, up, down, cfg.demod_k_f,
                                   precision=precision)
    out_len = 2 * (2304 - ch_taps) + 333
    re, im = _fm(rng, 2, _width_for(out_len, up, down))
    out_len = chain.resampler.out_len(re.shape[1])
    rs_bounds = None if bounds is None else (bounds[0], out_len + bounds[1])
    got = _run_chain(cores, re, im, chain, rs_bounds)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, _run_chain(cores, re, im, chain, rs_bounds, ref=True))


#: Long branches at Q = 1 (J = 20,000 and 15,000), whose tiled tap table
#: and windows would not fit 227 KB.
LONG_BRANCHES = [(1, 1, 20000), (2, 1, 15000)]


@pytest.mark.parametrize("up,down,branch", LONG_BRANCHES)
def test_resample_long_branch_takes_compact_route(cores, rng, up, down,
                                                  branch):
    """Bit for bit against ``poly_dot`` per output, on the compact route."""
    h = rng.standard_normal(up * branch - (up > 1)).astype(np.float32)
    rs = rs_kernel.PolyphaseResampler(h, up, down)
    assert _route(cores, rs) == 0
    x = rng.standard_normal((2, _width_for(2309, up, down)))
    got = _run_resample(cores, x, rs)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, _run_resample(cores, x, rs, ref=True))


def _first_form_bytes(up, down, center, branch, ch_taps=None) -> int:
    """Shared memory of kernel I's (with ``ch_taps``, kernel J's) first
    form, computed here from its layout: the taps as given, one input window
    a plane for 1,024 outputs, and for J 1,024 + Lc resampled and 1,025
    channelized samples a plane."""
    def anchor(m):
        return (m * down + center) // up

    if ch_taps is None:
        return 4 * (up * branch + anchor(1023) - anchor(0) + branch)
    q0 = -1 - (ch_taps - 1 - ch_taps // 2)
    window = anchor(q0 + 1024 + ch_taps - 1) - anchor(q0) + branch
    return 4 * (up * branch + ch_taps + 2 * window + 2 * (1024 + ch_taps)
                + 2 * 1025)


def test_routes_take_every_shape_the_first_form_took(cores):
    """Over P | 256, Q from 1 to 4,096, branches of 1 to 29,000 taps and
    channelizers of 1 to 17,000: every shape whose first-form kernel fitted
    227 KB has a route, a tiled one only for Q <= 5, and the compact route
    in the first form's bytes."""
    limit = 227 * 1024
    seen = {"tiled": 0, "compact": 0}
    for up in (1, 2, 4, 8, 32, 128, 256):
        for down in (1, 2, 3, 4, 5, 6, 8, 9, 16, 56, 57, 255, 4096):
            for branch in (1, 9, 32, 129, 500, 2000, 7000, 20000, 29000):
                center = up * branch // 2
                for ch_taps in (None, 1, 63, 257, 4097, 17000):
                    want = _first_form_bytes(up, down, center, branch,
                                             ch_taps)
                    got = ctypes.c_longlong()
                    core = cores.route_host(
                        int(ch_taps is not None), up, down, center, branch,
                        branch, ch_taps or 0, ctypes.byref(got))
                    shape = (up, down, branch, ch_taps, core, got.value, want)
                    if core > 0:
                        assert core == down <= 5, shape
                        assert got.value <= limit, shape
                        seen["tiled"] += 1
                    elif core == 0:
                        assert got.value == want <= limit, shape
                        seen["compact"] += 1
                    else:
                        assert want > limit, shape
    assert min(seen.values()) > 100, seen
    cfg = ChainConfig()
    rs = rs_kernel.PolyphaseResampler(cfg.resample_filter(), 2, 3)
    assert _route(cores, rs) == 3
    assert _route(cores, rs, cfg.channelizer_taps) == 3


@pytest.mark.parametrize("num_taps", [1, 2, 5, 63, 64, 257])
def test_fir_float_core(cores, rng, num_taps):
    """Widths around the 1,024-output tile, u8 and f32 rows."""
    fir = fir_float.FloatFir1d(rng.standard_normal(num_taps)
                               / np.sqrt(num_taps))
    for width in (1, 100, 1024, 1025, 2500):
        for x in (rng.integers(0, 256, size=(3, width), dtype=np.uint8),
                  rng.standard_normal((3, width)).astype(np.float32)):
            want = fir_float.fir_float_plain(torch.from_numpy(x), fir)
            got = _run_fir(cores, x, fir)
            assert snr_db(want.numpy(), got) >= 120.0, (num_taps, width)


@pytest.mark.parametrize("up,down", [(2, 3), (4, 3), (2, 1), (8, 5), (1, 2),
                                     (1, 1), (128, 3), (2, 9)])
def test_resample_core(cores, rng, up, down):
    """Every rate shape, a long branch (J = 80) and ragged lengths."""
    for num_taps in (31, 63, 160):
        rs = rs_kernel.PolyphaseResampler(
            design_lowpass(num_taps, 0.9 / max(up, down), gain=up), up, down)
        for n in (1, 700, 1536, 4001):
            x = rng.standard_normal((2, n)).astype(np.float32)
            want = rs_kernel.resample_plain(torch.from_numpy(x), rs).numpy()
            got = _run_resample(cores, x, rs)
            assert got.shape == want.shape
            assert snr_db(want, got) >= 120.0, (num_taps, n)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_chain_core(cores, rng, geometry):
    """f32 modes > 95 dB against the plain version; "bf16" > 60 dB against
    its plain version (a resampled sample whose f32 and f64 sums round to
    neighbouring bf16 values differs by a bf16 step) and > 40 dB against
    the f32 chain."""
    up, down, rs_taps, ch_taps, channels = geometry
    cfg = _config(up, down, rs_taps, ch_taps)
    re, im = _fm(rng, channels, 3 * 1024 * down // up + 333)
    wants = {}
    for precision, bound in (("highest", 95.0), ("bf16", 60.0)):
        chain = chain_fused.FusedChain(
            cfg.resample_filter(), cfg.channelizer_filter(), up, down,
            cfg.demod_k_f, precision=precision)
        wants[precision] = chain_fused.chain_fused_plain(
            *_planes(re, im), chain).numpy()
        got = _run_chain(cores, re, im, chain)
        np.testing.assert_array_equal(got[:, 0], 0.0)
        assert snr_db(wants[precision], got) > bound, precision
    assert snr_db(wants["highest"], got) > 40.0


@pytest.mark.parametrize("bounds", [(37, -50), (-300, 200), (1500, -1700)])
def test_chain_core_rs_bounds(cores, rng, bounds):
    cfg = ChainConfig()
    re, im = _fm(rng, 8, 4000)
    chain = chain_fused.FusedChain(cfg.resample_filter(),
                                   cfg.channelizer_filter(), 2, 3,
                                   cfg.demod_k_f)
    out_len = chain.resampler.out_len(4000)
    rs_bounds = (bounds[0], out_len + bounds[1])
    want = chain_fused.chain_fused_plain(*_planes(re, im), chain,
                                         rs_bounds).numpy()
    got = _run_chain(cores, re, im, chain, rs_bounds)
    assert snr_db(want, got) > 95.0


def test_chain_core_discriminator_edge_cases(cores):
    """CUDA's atan2f where numpy's quadrant rules matter: atan2(-0.0, -1)
    is -pi, atan2(+0.0, -0.0) is +pi, atan2(0, 0) is 0."""
    ch_re = np.zeros(1025, np.float32)
    ch_im = np.zeros(1025, np.float32)
    ch_re[:2] = (1.0, -1.0)
    ch_im[:2] = -0.0
    y = np.full(2 * 1024, np.nan, np.float32)
    cores.demod_host(ch_re.ctypes.data, ch_im.ctypes.data, y.ctypes.data,
                     1024, 1.0)
    pi = np.float32(np.pi)
    np.testing.assert_array_equal(y[1024:1027], [-pi, pi, 0.0])
    assert np.all(y[1027:] == 0.0)
    np.testing.assert_array_equal(
        np.arctan2(np.float32([-0.0, 0.0, 0.0]), np.float32([-1.0, -0.0, 0.0])),
        [-pi, pi, 0.0])
