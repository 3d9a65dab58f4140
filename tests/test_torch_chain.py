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
#include <vector>

#include "wft_chain.cuh"

using wft::kChainThreads;
using wft::kChainTile;

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

extern "C" void resample_host(const float* x, float* y, long long rows,
                              long long n, long long out_len,
                              const float* taps, int up, int down,
                              int center, int len, int stride) {
  const wft::PolyPlan p{up, down, center, len, stride};
  std::vector<float> w(wft::resample_window(p));
  const int width = static_cast<int>(w.size());
  for (long long row = 0; row < rows; ++row) {
    for (long long m0 = 0; m0 < out_len; m0 += kChainTile) {
      for (int t = 0; t < kChainThreads; ++t) {
        wft::stage_window(x + row * n, n, wft::resample_base(m0, p), w.data(),
                          width, t, kChainThreads);
      }
      for (int t = 0; t < kChainThreads; ++t) {
        wft::resample_thread(w.data(), taps, p, t, y + row * out_len,
                             out_len, m0);
      }
    }
  }
}

template <typename T>
void chain_cta(const T* re, const T* im, const wft::ChainPlan& c,
               long long row, long long n, long long m0, float* xs,
               float* rs, float* ch, const float* rs_taps,
               const float* ch_taps, float* y, long long out_len) {
  const int in_w = wft::chain_in_window(c);
  const int rs_n = wft::chain_rs_count(c);
  const long long in0 = wft::chain_in_base(m0, c);
  for (int t = 0; t < kChainThreads; ++t) {
    for (int plane = 0; plane < 2; ++plane) {
      wft::stage_window((plane ? im : re) + row * n, n, in0, xs + plane * in_w,
                        in_w, t, kChainThreads);
    }
  }
  for (int t = 0; t < kChainThreads; ++t) {
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_resample_thread(xs + plane * in_w, rs_taps, c, t,
                                 rs + plane * rs_n, m0);
    }
  }
  for (int t = 0; t < kChainThreads; ++t) {
    for (int plane = 0; plane < 2; ++plane) {
      wft::chain_channelize_thread(rs + plane * rs_n, ch_taps, c, t,
                                   ch + plane * (kChainTile + 1));
    }
  }
  for (int t = 0; t < kChainThreads; ++t) {
    wft::chain_demod_thread(ch, ch + kChainTile + 1, c, t, y + row * out_len,
                            out_len, m0);
  }
}

extern "C" void demod_host(const float* ch_re, const float* ch_im, float* y,
                           long long m0, float inv_gain) {
  wft::ChainPlan c;
  c.inv_gain = inv_gain;
  for (int t = 0; t < kChainThreads; ++t) {
    wft::chain_demod_thread(ch_re, ch_im, c, t, y, m0 + kChainTile, m0);
  }
}

extern "C" void chain_host(const void* re, const void* im, int bf16,
                           float* y, long long channels, long long n,
                           long long out_len, const float* rs_taps, int up,
                           int down, int center, int len, int stride,
                           const float* ch_taps, int ch_len, long long lo,
                           long long hi, float inv_gain) {
  wft::ChainPlan c;
  c.rs = wft::PolyPlan{up, down, center, len, stride};
  c.ch_taps = ch_len;
  c.lo = lo;
  c.hi = hi;
  c.inv_gain = inv_gain;
  c.bf16 = bf16 != 0;
  std::vector<float> xs(2 * wft::chain_in_window(c));
  std::vector<float> rs(2 * wft::chain_rs_count(c));
  std::vector<float> ch(2 * (kChainTile + 1));
  for (long long row = 0; row < channels; ++row) {
    for (long long m0 = 0; m0 < out_len; m0 += kChainTile) {
      if (c.bf16) {
        chain_cta(static_cast<const uint16_t*>(re),
                  static_cast<const uint16_t*>(im), c, row, n, m0, xs.data(),
                  rs.data(), ch.data(), rs_taps, ch_taps, y, out_len);
      } else {
        chain_cta(static_cast<const float*>(re), static_cast<const float*>(im),
                  c, row, n, m0, xs.data(), rs.data(), ch.data(), rs_taps,
                  ch_taps, y, out_len);
      }
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


def _run_resample(lib, x: np.ndarray, rs) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    out_len = rs.out_len(x.shape[1])
    y = np.empty((x.shape[0], out_len), np.float32)
    taps = _np(rs.taps)
    lib.resample_host(x.ctypes.data, y.ctypes.data, x.shape[0], x.shape[1],
                      out_len, taps.ctypes.data, rs.up, rs.down, rs.center,
                      rs.branch_len, rs.tap_stride)
    return y


def _run_chain(lib, re: np.ndarray, im: np.ndarray, chain,
               rs_bounds=None) -> np.ndarray:
    if chain.bf16:
        re, im = (_np(torch.from_numpy(p).to(torch.bfloat16)
                      .view(torch.int16)).view(np.uint16) for p in (re, im))
    re, im = np.ascontiguousarray(re), np.ascontiguousarray(im)
    rs, fir = chain.resampler, chain.channelizer
    out_len = rs.out_len(re.shape[1])
    lo, hi = (0, out_len) if rs_bounds is None else rs_bounds
    y = np.full((re.shape[0], out_len), np.nan, np.float32)
    rs_taps, ch_taps = _np(rs.taps), _np(fir.taps)
    lib.chain_host(re.ctypes.data, im.ctypes.data, int(chain.bf16),
                   y.ctypes.data, re.shape[0], re.shape[1], out_len,
                   rs_taps.ctypes.data, rs.up, rs.down, rs.center,
                   rs.branch_len, rs.tap_stride, ch_taps.ctypes.data,
                   fir.num_taps, lo, hi, chain.inv_gain)
    return y


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
