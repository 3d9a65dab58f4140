"""The FFT path of the port (kernels K, L and M) against the JAX package's.

- The gates, the stream geometry and the table builders of
  ``kernels/fft.py`` equal the JAX ``kernels/fft_pallas.py`` ones
  (``np.array_equal``; the fold tables, f32 here, against the JAX bf16
  hi + lo sum within the lo part's rounding, 2^-16 relative).
- The plain versions, through the entries on CPU tensors, against numpy,
  the f64 golden and the JAX functions, which run their Pallas kernels in
  interpret mode, at the bounds of ``tests/test_fft_pallas.py``: the row FFT
  ``|got - want| <= 2e-4 max|want|`` (``:45-49``), the framed filter SNR >
  80 dB (``:101``, ``:108``) and 1e-2 at the alignment cases
  (``:110-123``), the quantized path within 1 of the fixed golden on under
  2% of samples (``:130-132``), the stream filter SNR > 90 dB (``:194``)
  and its u8 output equal on more than 99.9% (``:209``).
- The kernels' per-thread cores (``csrc/wft_fft_rows.cuh``) built with g++
  and run CTA by CTA on the host, against the plain versions: SNR >= 120
  dB (f32 transforms against float64); u8 outputs within 1, on rounding
  ties.  Kernel M places its windows at the full hop of 512 − L + 1
  (``stream_plan``) where the plain version keeps the TPU kernel's, so
  its agreement shows the function unchanged; a float64 numpy model of
  that plan meets the same-mode FIR to 1e-9.
- The chain's ``"pallas"`` channelizer against the JAX chain with that
  backend, SNR > 90 dB (the staged bound of ``tests/test_torch_chain.py``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import fft_pallas as jax_fft
from warmup_fir_filter_tpu.models import chain as jax_chain
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import fft
from warmup_fir_filter_tpu_torch.models.chain import ChainConfig, chain_forward
from warmup_fir_filter_tpu_torch.ops import demod, fftfilt
from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

#: (C, T, L, off) of tests/test_fft_pallas.py:166-176.
STREAM_CASES = [
    (3, 2000, 63, 0),
    (2, 1111, 63, 31),      # the sharded-path offset contract
    (1, 700, 5, 0),
    (4, 4096, 129, 64),
    (2, 900, 257, 128),     # L at the kernel cap, d = 0
    (2, 513, 63, 62),
    (3, 300, 63, 0),        # single partial window run
    (2, 257, 1, 0),         # identity filter, m_shift = 0
]
STREAM_IDS = ["-".join(map(str, c)) for c in STREAM_CASES]
#: Kernel M's window plan at its edges: hop 512 (L = 1), an even L, hop
#: 384 and 256 (L = 129, 257), T one short of, at and one past a hop of
#: 450 at 63 taps, and the offsets 31 and 62.
HOP_EDGE_CASES = [
    (2, 3000, 1, 0),
    (2, 3000, 2, 0),
    (2, 3000, 129, 0),
    (2, 3000, 257, 0),
    (2, 449, 63, 0),
    (2, 450, 63, 0),
    (2, 451, 63, 0),
    (2, 3000, 63, 31),
    (2, 3000, 63, 62),
]
HOP_EDGE_IDS = ["-".join(map(str, c)) for c in HOP_EDGE_CASES]
#: Windows a program of the JAX stream kernel takes here: the function
#: computed is the same, and interpret mode traces 2 windows quickly.
JAX_R_WINDOWS = 2


def _cplx(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _snr_complex(want, got) -> float:
    err = np.sum(np.abs(np.asarray(got) - want) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(np.abs(want) ** 2) / err))


def _taps(taps: int, cutoff: float = 0.2) -> np.ndarray:
    """A low-pass; one tap passes through, and two are an irrational pair:
    a symmetric one halves the sum of two integers, so half its u8
    outputs would sit on rounding ties."""
    if taps == 1:
        return np.array([1.0])
    if taps == 2:
        golden = (np.sqrt(5.0) - 1.0) / 2.0
        return np.array([golden, 1.0 - golden])
    return design_lowpass(taps, cutoff)


# ------------------------------------------------------- gates and geometry


@pytest.mark.parametrize("nfft", [0, 1, 2, 3, 96, 128, 256, 500, 512, 16384,
                                  32768])
def test_factor_nfft_matches_jax(nfft):
    try:
        want = jax_fft.factor_nfft(nfft)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            fft.factor_nfft(nfft)
        assert str(got.value) == str(err)
        return
    assert fft.factor_nfft(nfft) == want


@pytest.mark.parametrize("nfft,taps", [(32, 63), (32768, 63), (32768, 3000),
                                       (16384, 3000), (512, 63)])
def test_check_nfft_for_taps_messages(nfft, taps):
    try:
        jax_fft._check_nfft_for_taps(nfft, taps)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            fft._check_nfft_for_taps(nfft, taps)
        assert str(got.value) == str(err)
        return
    fft._check_nfft_for_taps(nfft, taps)


def test_stream_gate_and_geometry_match_jax():
    """L = 1-257 at the offsets of tests/test_fft_pallas.py:232-246 and a
    few past the gate."""
    for taps in range(1, 259):
        center = taps // 2
        for off in (0, max(0, taps - 1 - center), 31, 64, 128, 200, 300, -1):
            assert (fft.stream_kernel_supported(taps, off)
                    == jax_fft.stream_kernel_supported(taps, off)), (taps, off)
            assert (fft._stream_geometry(taps, off)
                    == jax_fft._stream_geometry(taps, off)), (taps, off)
    assert not fft.stream_kernel_supported(63, nfft=1024)


# ------------------------------------------------------------------- tables


@pytest.mark.parametrize("nfft", [2, 64, 128, 256, 512, 4096, 16384])
def test_dft_tables_equal_jax(nfft):
    got, want = fft._dft_tables(nfft), jax_fft._dft_tables(nfft)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("nfft,taps,d", [(128, 9, 0), (512, 63, 0),
                                         (512, 63, 97), (512, 129, 0),
                                         (2048, 63, 5), (4096, 259, 0)])
def test_spectra_equal_jax(rng, nfft, taps, d):
    h = rng.standard_normal(taps)
    for got, want in zip(fft._osfilt_spectrum_shifted(h, nfft, d),
                         jax_fft._osfilt_spectrum_shifted(h, nfft, d)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(fft._osfilt_spectrum(h, nfft),
                         jax_fft._osfilt_spectrum(h, nfft)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nfft,d", [(256, 0), (512, 97), (1024, 0)])
def test_fold_tables_match_jax_split(rng, nfft, d):
    """f32 tables against the JAX bf16 hi + lo sum: the lo part rounds at
    2^-9 of a residue below 2^-9 of the value."""
    n1, n2 = fft.factor_nfft(nfft)
    hc, hs = fft._osfilt_spectrum_shifted(design_lowpass(63, 0.25), nfft, d)
    got = fft._osfilt_fold_tables(hc, hs, fft._dft_tables(nfft), n1, n2)
    want = jax_fft._osfilt_fold_tables(hc, hs, jax_fft._dft_tables(nfft),
                                       n1, n2)
    for key in ("t2fc", "t2fs", "hg2c", "hg2s"):
        split = (np.asarray(want[key + "h"], np.float32)
                 + np.asarray(want[key + "l"], np.float32))
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], split, rtol=2.0 ** -16,
                                   atol=1e-12, err_msg=key)


def test_kernel_tables():
    """The twiddles and the natural-order, scaled spectrum the kernels
    read: h's own, whatever shift the plain versions' spectrum carries."""
    tw = fft.fft_twiddles(512)
    assert tw.shape == (256, 2) and tw.dtype == np.float32
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1],
                               np.exp(-2j * np.pi * np.arange(256) / 512),
                               atol=6e-8)
    h = design_lowpass(63, 0.25)
    spec = fft.FilterSpectrum(h, 512, d=97)
    want = np.fft.fft(h, 512) / 512
    got = spec.spectrum.numpy()
    assert got.shape == (512, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, atol=1e-9)
    np.testing.assert_array_equal(
        got, fft.FilterSpectrum(h, 512).spectrum.numpy())
    for mine, jax_part in zip((spec.hc, spec.hs),
                              jax_fft._osfilt_spectrum_shifted(h, 512, 97)):
        np.testing.assert_array_equal(mine, jax_part)
    assert spec.twiddles.dtype == torch.float32


# ------------------------------------------------------ K12: the row FFT


@pytest.mark.parametrize("nfft", [128, 256, 512, 2048])
def test_fft_rows_complex(rng, nfft):
    x = rng.normal(size=(5, nfft)) + 1j * rng.normal(size=(5, nfft))
    re, im = fft.fft_rows_pallas(torch.from_numpy(x.real),
                                 torch.from_numpy(x.imag))
    assert re.dtype == im.dtype == torch.float32
    got = _cplx(re, im)
    want = np.fft.fft(x, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=0)
    np.testing.assert_allclose(
        got, _cplx(*jax_fft.fft_rows_pallas(x.real, x.imag)),
        atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("nfft", [128, 512, 4096])
def test_fft_rows_real_input(rng, nfft):
    x = rng.normal(size=(3, nfft))
    got = _cplx(*fft.fft_rows_pallas(torch.from_numpy(x)))
    want = np.fft.fft(x, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=0)
    np.testing.assert_allclose(got, _cplx(*jax_fft.fft_rows_pallas(x)),
                               atol=2e-4 * scale, rtol=0)


def test_fft_rows_single_row(rng):
    x = rng.normal(size=(1, 256))
    np.testing.assert_allclose(_cplx(*fft.fft_rows_pallas(torch.from_numpy(x))),
                               np.fft.fft(x, axis=-1), atol=1e-3, rtol=0)


@pytest.mark.parametrize("nfft", [2, 128, 512])
def test_fft_rows_roundtrip(rng, nfft):
    x = rng.normal(size=(4, nfft)) + 1j * rng.normal(size=(4, nfft))
    fr, fi = fft.fft_rows_pallas(torch.from_numpy(x.real),
                                 torch.from_numpy(x.imag))
    br, bi = fft.fft_rows_pallas(fr, fi, inverse=True)
    np.testing.assert_allclose(_cplx(br, bi), x, atol=5e-4 * np.abs(x).max(),
                               rtol=0)


def test_fft_rows_inverse_matches_numpy_and_jax(rng):
    spec = rng.normal(size=(2, 256)) + 1j * rng.normal(size=(2, 256))
    got = _cplx(*fft.fft_rows_pallas(torch.from_numpy(spec.real),
                                     torch.from_numpy(spec.imag),
                                     inverse=True))
    np.testing.assert_allclose(got, np.fft.ifft(spec, axis=-1), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        got, _cplx(*jax_fft.fft_rows_pallas(spec.real, spec.imag,
                                            inverse=True)), atol=1e-5, rtol=0)


def test_fft_rows_plain_is_float64(rng):
    x = rng.normal(size=(3, 4096)) + 1j * rng.normal(size=(3, 4096))
    re, im = fft.fft_rows_plain(torch.from_numpy(x.real),
                                torch.from_numpy(x.imag), inverse=False)
    assert re.dtype == torch.float64
    assert _snr_complex(np.fft.fft(x, axis=-1), _cplx(re, im)) > 140.0


def test_fft_rows_validation():
    with pytest.raises(ValueError, match="inverse"):
        fft.fft_rows_pallas(torch.zeros((1, 128)), inverse=True)
    with pytest.raises(ValueError, match="inverse"):
        fft.fft_rows(torch.zeros((1, 128)), None, inverse=True)
    with pytest.raises(ValueError, match="power of two"):
        fft.fft_rows_pallas(torch.zeros((1, 96)))
    with pytest.raises(ValueError, match="unsupported"):
        fft.fft_rows_pallas(torch.zeros((1, 32768)))
    with pytest.raises(TypeError, match="samples"):
        fft.fft_rows(torch.zeros((1, 128), dtype=torch.float64), None,
                     inverse=False)
    with pytest.raises(ValueError, match="matching"):
        fft.fft_rows(torch.zeros((1, 128)), torch.zeros((2, 128)),
                     inverse=False)


# ------------------------------------------------ K13: the framed filter


@pytest.mark.parametrize("nfft", [128, 512, 2048])  # N1 = 1, 4, 16
def test_framed_matches_jax_and_ideal(rng, nfft):
    h = rng.uniform(-0.1, 0.1, 63)
    x = rng.integers(0, 256, size=(3, 3000), dtype=np.uint8)
    got = fft.fir_overlap_save_pallas(torch.from_numpy(x), h, nfft=nfft)
    assert got.dtype == torch.float32 and got.shape == x.shape
    got = got.numpy()
    assert snr_db(fir1d_ideal_golden_rows(x, h), got) > 80.0
    want = np.asarray(jax_fft.fir_overlap_save_pallas(x, h, nfft=nfft))
    assert snr_db(want, got) > 80.0


def test_framed_259_taps_auto(rng):
    """Past the stream gate: nfft = pick_nfft(259) = 4,096 (N1 = 32)."""
    h = design_lowpass(259, 0.25)
    x = rng.integers(0, 256, size=(2, 5000), dtype=np.uint8)
    got = fft.fir_overlap_save_pallas(torch.from_numpy(x), h).numpy()
    assert snr_db(fir1d_ideal_golden_rows(x, h), got) > 80.0
    assert snr_db(np.asarray(jax_fft.fir_overlap_save_pallas(x, h)),
                  got) > 80.0


def test_block_boundary_alignment(rng):
    h = np.zeros(9)
    h[4] = 1.0
    x = rng.integers(0, 256, size=(2, 700), dtype=np.uint8)
    out = fft.fir_overlap_save_pallas(torch.from_numpy(x), h, nfft=128)
    np.testing.assert_allclose(out.numpy(), x.astype(np.float32), atol=1e-2)


def test_even_tap_alignment(rng):
    h = np.array([1.0, 0.0])  # L=2, center=1 → y[n] = x[n+1]
    x = rng.integers(0, 256, size=(1, 300), dtype=np.uint8)
    out = fft.fir_overlap_save_pallas(torch.from_numpy(x), h, nfft=128)
    np.testing.assert_allclose(out.numpy(), fir1d_ideal_golden_rows(x, h),
                               atol=1e-2)


@pytest.mark.parametrize("nfft,taps", [(None, 63), (1024, 63),
                                       (None, 259)])
def test_quantized_vs_fixed_sim(rng, nfft, taps):
    """Auto nfft at 63 taps is kernel M; pinned, or 259 taps (nfft 4,096),
    the framed kernel L.  Within 1 of the bit-exact sim on under 2%."""
    h = rng.uniform(-0.05, 0.05, taps) * (63 / taps)
    x = rng.integers(0, 256, size=(2, 4_000), dtype=np.uint8)
    got = fft.fir_overlap_save_quantized_pallas(torch.from_numpy(x), h,
                                                nfft=nfft)
    assert got.dtype == torch.uint8
    diff = got.numpy().astype(np.int32) - fir1d_fixed_golden_rows(
        x, h).astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert float(np.mean(diff != 0)) < 0.02
    want = np.asarray(jax_fft.fir_overlap_save_quantized_pallas(x, h,
                                                                nfft=nfft))
    assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1


def test_nfft_errors():
    x = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="nfft"):
        fft.fir_overlap_save_pallas(torch.zeros((1, 10), dtype=torch.uint8),
                                    np.ones(63), nfft=32)
    with pytest.raises(ValueError, match="16384-point cap"):
        fft.fir_overlap_save_pallas(x, np.ones(3000))
    with pytest.raises(ValueError, match="16384-point cap"):
        fft.fir_overlap_save_quantized_pallas(x, np.full(3000, 1e-4))
    with pytest.raises(ValueError, match="16384-point cap"):
        fft.fir_overlap_save_pallas(x, np.ones(63), nfft=32768)
    with pytest.raises(ValueError, match="power of two"):
        fft.fir_overlap_save_pallas(x, np.ones(63), nfft=1000)


def test_osfilt_validation(rng):
    spec = fft.FilterSpectrum(np.ones(9), 256)
    with pytest.raises(ValueError, match="points"):
        fft.osfilt(torch.zeros((2, 512)), spec, out_u8=False)
    with pytest.raises(TypeError, match="samples"):
        fft.osfilt(torch.zeros((2, 256), dtype=torch.int32), spec,
                   out_u8=False)
    seg = torch.from_numpy(rng.integers(0, 256, size=(3, 256),
                                        dtype=np.uint8))
    got = fft.osfilt(seg, spec, out_u8=True)
    assert got.dtype == torch.uint8
    assert torch.equal(got, fft._u8_stage(fft.osfilt(seg, spec,
                                                     out_u8=False)))


# ------------------------------------------------ K14: the stream filter


@pytest.mark.parametrize("case", STREAM_CASES, ids=STREAM_IDS)
def test_stream_matches_jax_and_reference(rng, case):
    channels, time, taps, off = case
    assert fft.stream_kernel_supported(taps, off)
    x = rng.standard_normal((channels, time + off)).astype(np.float32)
    h = _taps(taps)
    ref = fftfilt.fir_overlap_save(torch.from_numpy(x), h).numpy()
    ref = ref[:, off:off + time]
    got = fft.fir_overlap_save_stream(torch.from_numpy(x), h, off=off,
                                      out_len=time)
    assert got.dtype == torch.float32 and got.shape == (channels, time)
    assert snr_db(ref, got.numpy()) > 90.0
    want = np.asarray(jax_fft.fir_overlap_save_stream(
        x, h, off=off, out_len=time, r_windows=JAX_R_WINDOWS))
    assert snr_db(want, got.numpy()) > 90.0


def test_stream_u8_output(rng):
    h = design_lowpass(63, 0.25)
    x = rng.integers(0, 256, size=(2, 3000), dtype=np.uint8)
    got = fft.fir_overlap_save_stream(torch.from_numpy(x), h, out_u8=True)
    reff = fftfilt.fir_overlap_save(torch.from_numpy(x.astype(np.float32)),
                                    h).numpy().astype(np.float64)
    ref = np.clip(np.floor(reff + 0.5), 0, 255).astype(np.uint8)
    assert got.dtype == torch.uint8
    assert float((got.numpy() == ref).mean()) > 0.999  # float-rounding ties


def test_stream_auto_path_and_default_out_len(rng):
    """63 taps, nfft automatic: the stream path, as the JAX entry takes it;
    ``out_len`` defaults to T − off."""
    h = design_lowpass(63, 0.25)
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    got = fft.fir_overlap_save_pallas(torch.from_numpy(x), h)
    assert torch.equal(got, fft.fir_overlap_save_stream(torch.from_numpy(x),
                                                        h))
    tail = fft.fir_overlap_save_stream(torch.from_numpy(x), h, off=31)
    assert tail.shape == (2, 1469)
    assert snr_db(got[:, 31:].numpy(), tail.numpy()) > 120.0


@pytest.mark.parametrize("case", STREAM_CASES + HOP_EDGE_CASES,
                         ids=STREAM_IDS + HOP_EDGE_IDS)
def test_stream_plan_model_matches_fir(rng, case):
    """Kernel M's windows in float64 numpy, off :func:`stream_plan` alone:
    window w is ``x[w·hop + start :][:512]`` (zero outside the stream),
    circularly filtered by ``np.fft``; its outputs ``[L − 1, 512)`` are
    ``q = w·hop + p − (L − 1)``.  Equal to the same-mode FIR within 1e-9:
    an off-by-one in the plan fails here with no core."""
    channels, time, taps, off = case
    hop, start = fft.stream_plan(taps, off)
    assert hop == 512 - taps + 1
    h = _taps(taps)
    x = rng.standard_normal((channels, time + off))
    windows = -(-time // hop)
    got = np.zeros((channels, windows * hop))
    h_freq = np.fft.fft(h, 512)
    for w in range(windows):
        a = w * hop + start
        seg = fft._zero_extended(torch.from_numpy(x), a, 512).numpy()
        y = np.fft.ifft(np.fft.fft(seg, axis=-1) * h_freq, axis=-1).real
        got[:, w * hop:(w + 1) * hop] = y[:, taps - 1:]
    want = fir1d_ideal_golden_rows(x, h)[:, off:off + time]
    np.testing.assert_allclose(got[:, :time], want, rtol=0, atol=1e-9)


def test_stream_rejections():
    assert not fft.stream_kernel_supported(259)
    assert not fft.stream_kernel_supported(63, off=300)
    with pytest.raises(ValueError, match="stream kernel"):
        fft.fir_overlap_save_stream(torch.zeros((1, 512)), np.ones(259))
    with pytest.raises(ValueError, match="invalid off"):
        fft.fir_overlap_save_stream(torch.zeros((1, 10)), np.ones(5), off=20)
    tables = fft.FilterSpectrum(np.ones(63), 512, d=97)
    with pytest.raises(ValueError, match="shift"):
        fft.osfilt_stream(torch.zeros((1, 600)), tables, off=31,
                          out_len=100, out_u8=False)


def test_cpu_tensors_launch_no_kernel(rng):
    counters = (fft.fft_rows, fft.osfilt, fft.osfilt_stream)
    before = [k.launches for k in counters]
    x = torch.from_numpy(rng.standard_normal((2, 1000)).astype(np.float32))
    fft.fft_rows_pallas(x[:, :512])
    fft.fir_overlap_save_pallas(x, design_lowpass(63, 0.25))
    fft.fir_overlap_save_pallas(x, design_lowpass(63, 0.25), nfft=256)
    assert [k.launches for k in counters] == before


# ----------------------------------------------------------------- the chain


def _fm(rng, channels, time_len, k_f=0.05):
    msg = rng.standard_normal((channels, time_len)) * 0.3
    re, im = demod.fm_modulate(msg, k_f)
    return re.astype(np.float32), im.astype(np.float32)


@pytest.mark.parametrize("taps", [63, 259])
def test_chain_pallas_matches_jax(rng, taps):
    """63 taps through kernel M's plain version, 259 through kernel L's.

    Against the JAX chain with the same backend, the JAX package's own
    bound for it (``tests/test_demod_chain.py:121``, atol 2e-4): its
    bf16x3 matmul split puts that chain at about 88 dB from its f32
    ``"mxu"`` one.  Against the JAX ``"jnp"`` chain (``jnp.fft``, f32) the
    staged bound, SNR > 90 dB."""
    channels = 8 if taps == 63 else 2
    re, im = _fm(rng, channels, 3000)
    kwargs = dict(channelizer_backend="pallas", channelizer_taps=taps)
    got = chain_forward(torch.from_numpy(re), torch.from_numpy(im),
                        ChainConfig(**kwargs))
    want = np.asarray(jax_chain.chain_forward(
        re, im, jax_chain.ChainConfig(**kwargs)), np.float64)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    kwargs["channelizer_backend"] = "jnp"
    want = np.asarray(jax_chain.chain_forward(
        re, im, jax_chain.ChainConfig(**kwargs)), np.float64)
    assert snr_db(want, got.numpy()) > 90.0


def test_chain_auto_long_channelizer_on_cpu_takes_torch_fft(monkeypatch, rng):
    """``"auto"`` above 257 taps on CPU planes: ``torch.fft``, not the
    ``"pallas"`` channelizer (which it takes on CUDA planes)."""
    import warmup_fir_filter_tpu_torch.models.chain as port_chain

    def refuse(*args, **kwargs):
        raise AssertionError("pallas channelizer taken on CPU planes")

    monkeypatch.setattr(port_chain, "fir_overlap_save_pallas", refuse)
    re, im = _fm(rng, 2, 3000)
    got = chain_forward(torch.from_numpy(re), torch.from_numpy(im),
                        ChainConfig(channelizer_taps=259))
    want = np.asarray(jax_chain.chain_forward(
        re, im, jax_chain.ChainConfig(channelizer_taps=259,
                                      channelizer_backend="jnp")))
    assert snr_db(want, got.numpy()) > 90.0


# ------------------------------------------------------------ the host cores

_HARNESS = r"""
#include <cstdint>
#include <vector>

#include "wft_fft_rows.cuh"

using wft::Cf;

namespace {

// A CTA's registers, thread by thread, and its shared planes: thread tid
// works on row tid / T as thread tid % T of it.
template <int LOG_N>
struct HostCta {
  using Plan = wft::RowsPlan<LOG_N>;
  std::vector<Cf> v = std::vector<Cf>(Plan::threads * Plan::P);
  std::vector<float> smem = std::vector<float>(2 * Plan::rows * Plan::stride);
  Cf* regs(int tid) { return v.data() + tid * Plan::P; }
  float* sre(int tid) { return smem.data() + (tid / Plan::T) * Plan::stride; }
  float* sim(int tid) {
    return smem.data() + (Plan::rows + tid / Plan::T) * Plan::stride;
  }
};

// fft_rows.cu's kernel: every thread of a CTA, phase by phase.
template <int LOG_N, bool INV, int I>
void rows_passes(HostCta<LOG_N>& cta, const Cf* tw) {
  using Plan = wft::RowsPlan<LOG_N>;
  if constexpr (I > 0) {
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::rows_read<LOG_N>(cta.regs(tid), cta.sre(tid), cta.sim(tid),
                            tid % Plan::T);
  }
  for (int tid = 0; tid < Plan::threads; ++tid)
    wft::rows_pass<LOG_N, I, INV>(cta.regs(tid), tw, tid % Plan::T);
  if constexpr (I + 1 < Plan::passes) {
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::rows_write<LOG_N, I>(cta.regs(tid), cta.sre(tid), cta.sim(tid),
                                tid % Plan::T);
    rows_passes<LOG_N, INV, I + 1>(cta, tw);
  }
}

template <int LOG_N, bool INV>
void rows_ctas(const float* xr, const float* xi, float* yr, float* yi,
               long long rows, const Cf* tw) {
  using Plan = wft::RowsPlan<LOG_N>;
  HostCta<LOG_N> cta;
  const float scale = INV ? 1.0f / static_cast<float>(Plan::n) : 1.0f;
  for (long long r0 = 0; r0 < rows; r0 += Plan::rows) {
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::rows_load<LOG_N>(xr, xi, rows, r0 + tid / Plan::T, tid % Plan::T,
                            cta.regs(tid));
    rows_passes<LOG_N, INV, 0>(cta, tw);
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::rows_store<LOG_N>(cta.regs(tid), rows, r0 + tid / Plan::T,
                             tid % Plan::T, scale, yr, yi);
  }
}

// The filter's phases, every thread of a phase before the next: where the
// kernels put a __syncthreads() (wft::filter_cta).
template <int LOG_N, int PH = 0>
void filter_phases(HostCta<LOG_N>& cta, const Cf* tw, const Cf* spec) {
  using Plan = wft::RowsPlan<LOG_N>;
  for (int tid = 0; tid < Plan::threads; ++tid)
    wft::filter_phase<LOG_N, PH>(cta.regs(tid), tw, spec, cta.sre(tid),
                                 cta.sim(tid), tid % Plan::T);
  if constexpr (PH + 1 < wft::FilterPlan<LOG_N>::phases)
    filter_phases<LOG_N, PH + 1>(cta, tw, spec);
}

// osfilt.cu's kernel over every CTA.
template <int LOG_N>
void osfilt_ctas(const void* seg, bool seg_u8, void* y, bool out_u8,
                 long long batch, const Cf* tw, const Cf* spec) {
  using Plan = wft::RowsPlan<LOG_N>;
  HostCta<LOG_N> cta;
  for (long long c = 0; c < wft::osfilt_ctas(batch, Plan::rows); ++c) {
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::osfilt_load<LOG_N>(seg, seg_u8, batch,
                              2 * (c * Plan::rows + tid / Plan::T),
                              tid % Plan::T, cta.regs(tid));
    filter_phases<LOG_N>(cta, tw, spec);
    for (int tid = 0; tid < Plan::threads; ++tid)
      wft::osfilt_store<LOG_N>(cta.regs(tid), y, out_u8, batch,
                               2 * (c * Plan::rows + tid / Plan::T),
                               tid % Plan::T);
  }
}

// osfilt_stream.cu's kernel over every CTA of every channel.
void stream_ctas(const void* x, bool x_u8, void* y, bool out_u8,
                 long long channels, long long tx, long long out_len, int hop,
                 int start, const Cf* tw, const Cf* spec) {
  using Plan = wft::StreamRows;
  HostCta<wft::kStreamLog2> cta;
  const long long per_channel = wft::stream_ctas_per_channel(out_len, hop);
  for (long long ch = 0; ch < channels; ++ch) {
    for (long long c = 0; c < per_channel; ++c) {
      for (int tid = 0; tid < Plan::threads; ++tid)
        wft::stream_load(x, x_u8, ch * tx, tx,
                         2 * (c * Plan::rows + tid / Plan::T), hop, start,
                         tid % Plan::T, cta.regs(tid));
      filter_phases<wft::kStreamLog2>(cta, tw, spec);
      for (int tid = 0; tid < Plan::threads; ++tid)
        wft::stream_store(cta.regs(tid), y, out_u8, ch * out_len, out_len,
                          2 * (c * Plan::rows + tid / Plan::T), hop,
                          tid % Plan::T);
    }
  }
}

template <int LOG_N>
void rows_size(int log_n, bool inverse, const float* xr, const float* xi,
               float* yr, float* yi, long long rows, const Cf* tw) {
  if (log_n != LOG_N) {
    if constexpr (LOG_N < wft::kFftMaxLog2)
      rows_size<LOG_N + 1>(log_n, inverse, xr, xi, yr, yi, rows, tw);
    return;
  }
  inverse ? rows_ctas<LOG_N, true>(xr, xi, yr, yi, rows, tw)
          : rows_ctas<LOG_N, false>(xr, xi, yr, yi, rows, tw);
}

template <int LOG_N>
void osfilt_size(int log_n, const void* seg, bool seg_u8, void* y,
                 bool out_u8, long long batch, const Cf* tw, const Cf* spec) {
  if (log_n != LOG_N) {
    if constexpr (LOG_N < wft::kFftMaxLog2)
      osfilt_size<LOG_N + 1>(log_n, seg, seg_u8, y, out_u8, batch, tw, spec);
    return;
  }
  osfilt_ctas<LOG_N>(seg, seg_u8, y, out_u8, batch, tw, spec);
}

}  // namespace

extern "C" void fft_rows_host(const float* xr, const float* xi, float* yr,
                              float* yi, long long rows, int log_n,
                              const Cf* tw, int inverse) {
  rows_size<1>(log_n, inverse != 0, xr, xi, yr, yi, rows, tw);
}

extern "C" void osfilt_host(const void* seg, void* y, long long batch,
                            int log_n, const Cf* tw, const Cf* spec,
                            int seg_is_u8, int out_u8) {
  osfilt_size<1>(log_n, seg, seg_is_u8 != 0, y, out_u8 != 0, batch, tw, spec);
}

extern "C" void stream_host(const void* x, void* y, long long channels,
                            long long tx, long long out_len, int hop,
                            int start, const Cf* tw, const Cf* spec,
                            int x_is_u8, int out_u8) {
  stream_ctas(x, x_is_u8 != 0, y, out_u8 != 0, channels, tx, out_len, hop,
              start, tw, spec);
}
"""


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    """The FFT kernels' cores (``csrc/wft_fft_rows.cuh``: kernel K's row
    FFT and kernels L and M's filter) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("fft_cores")
    (work / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=240)
    lib = ctypes.CDLL(str(work / "lib.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fft_rows_host.argtypes = [vp, vp, vp, vp, ll, i32, vp, i32]
    lib.osfilt_host.argtypes = [vp, vp, ll, i32, vp, vp, i32, i32]
    lib.stream_host.argtypes = [vp, vp, ll, ll, ll, i32, i32, vp, vp, i32,
                                i32]
    return lib


@pytest.mark.parametrize("nfft", [1 << b for b in range(1, 15)])
def test_fft_rows_core(cores, rng, nfft):
    """Complex, real and inverse rows at every size's radix plan; batches
    of 1 and 5 against CTAs of one row (n >= 2,048) or of several."""
    tw = fft.fft_twiddles(nfft)
    for batch in (1, 5):
        for mode in ("complex", "real", "inverse"):
            xr = rng.standard_normal((batch, nfft)).astype(np.float32)
            xi = (None if mode == "real"
                  else rng.standard_normal((batch, nfft)).astype(np.float32))
            yr, yi = np.empty_like(xr), np.empty_like(xr)
            cores.fft_rows_host(xr.ctypes.data,
                                None if xi is None else xi.ctypes.data,
                                yr.ctypes.data, yi.ctypes.data, batch,
                                nfft.bit_length() - 1, tw.ctypes.data,
                                int(mode == "inverse"))
            want = fft.fft_rows_plain(
                torch.from_numpy(xr),
                None if xi is None else torch.from_numpy(xi),
                inverse=mode == "inverse")
            assert _snr_complex(_cplx(*want), _cplx(yr, yi)) >= 120.0, (
                batch, mode)


@pytest.mark.parametrize("nfft,taps", [(2, 2), (16, 9), (32, 9), (128, 2),
                                       (128, 9), (256, 63), (512, 63),
                                       (2048, 63), (4096, 259),
                                       (16384, 2048)])
def test_osfilt_core(cores, rng, nfft, taps):
    """u8 and f32 segments, f32 and u8 out, an odd batch (the last FFT
    carries one segment); a single pass of radix 2 or 16, radix 2 last
    (32, 512), radix 8 (2,048), radix 16 (4,096) and radix 4 on the CTA
    of 1,024 threads (16,384); u8 out within 1 of the plain version's
    where the f32 and f64 sums round to either side of a tie."""
    h = rng.standard_normal(taps) / np.sqrt(taps)
    spec = fft.FilterSpectrum(h, nfft)
    batch = 7
    for seg_u8 in (True, False):
        seg = rng.integers(0, 256, size=(batch, nfft), dtype=np.uint8)
        seg = seg if seg_u8 else seg.astype(np.float32)
        want = fft.osfilt_plain(torch.from_numpy(seg), spec)
        for out_u8 in (False, True):
            y = np.empty((batch, nfft), np.uint8 if out_u8 else np.float32)
            cores.osfilt_host(seg.ctypes.data, y.ctypes.data, batch,
                              nfft.bit_length() - 1,
                              spec.twiddles.data_ptr(),
                              spec.spectrum.data_ptr(),
                              int(seg_u8), int(out_u8))
            if out_u8:
                w8 = fft._u8_stage(want.to(torch.float32)).numpy()
                diff = np.abs(y.astype(np.int32) - w8.astype(np.int32))
                assert diff.max() <= 1 and float(np.mean(diff != 0)) < 1e-3
            else:
                assert snr_db(want.numpy(), y) >= 120.0, (seg_u8, out_u8)


@pytest.mark.parametrize(
    "case", STREAM_CASES + HOP_EDGE_CASES + [(2, 1, 63, 0), (1, 40001, 63, 0)],
    ids=STREAM_IDS + HOP_EDGE_IDS + ["2-1-63-0", "1-40001-63-0"])
def test_stream_core(cores, rng, case):
    """The eight stream cases, the window plan's edges, a one-sample
    stream and one of 40,001 samples (many CTAs); f32 and u8 in and out,
    against the plain version in the TPU kernel's window geometry."""
    channels, time, taps, off = case
    d = fft._stream_geometry(taps, off)[1]
    hop, start = fft.stream_plan(taps, off)
    tables = fft.FilterSpectrum(_taps(taps), 512, d=d)
    for x_u8 in (False, True):
        x = rng.integers(0, 256, size=(channels, time + off), dtype=np.uint8)
        x = x if x_u8 else rng.standard_normal(x.shape).astype(np.float32)
        want = fft.osfilt_stream_plain(torch.from_numpy(x), tables, off=off,
                                       out_len=time)
        for out_u8 in (False, True):
            y = np.empty((channels, time), np.uint8 if out_u8 else np.float32)
            cores.stream_host(x.ctypes.data, y.ctypes.data, channels,
                              time + off, time, hop, start,
                              tables.twiddles.data_ptr(),
                              tables.spectrum.data_ptr(),
                              int(x_u8), int(out_u8))
            if out_u8:
                w8 = fft._u8_stage(want.to(torch.float32)).numpy()
                diff = np.abs(y.astype(np.int32) - w8.astype(np.int32))
                assert diff.max() <= 1 and float(np.mean(diff != 0)) < 1e-3
            else:
                assert snr_db(want.numpy(), y) >= 120.0, (x_u8, out_u8)
