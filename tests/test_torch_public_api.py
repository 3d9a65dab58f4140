"""The port's public surface against the JAX package's.

Each package ``__init__`` of the port exports what the JAX one exports,
and each kernel entry under a JAX name equals its JAX namesake on the CPU
(the Pallas kernels in interpret mode, as the JAX tests run them): the
fixed-point entries bit for bit (``np.array_equal``), the float entries at
the bounds of ``tests/test_fir_float_mxu.py`` and
``tests/test_resample_mxu.py``.  On a CPU tensor each entry runs its
kernel's plain version.
"""

import importlib

import numpy as np
import pytest
import torch

import warmup_fir_filter_tpu.kernels as jax_kernels
from warmup_fir_filter_tpu.kernels import fir_mxu as jax_fir_mxu
from warmup_fir_filter_tpu.kernels import resample_mxu as jax_resample_mxu
from warmup_fir_filter_tpu.kernels import window_copy as jax_window_copy
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.ops.fir2d import FILTER_BANK_2D
from warmup_fir_filter_tpu.ops.qformat import QFormat as JaxQFormat
from warmup_fir_filter_tpu_torch import kernels
from warmup_fir_filter_tpu_torch.kernels.fir_window import (
    fir1d_fixed_rows_mxu_window,
)
from warmup_fir_filter_tpu_torch.kernels.resample import resample_poly_mxu
from warmup_fir_filter_tpu_torch.kernels.window_copy import window_rows_pallas
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

PACKAGES = ("", ".kernels", ".ops", ".models", ".pipeline")
#: (coeff_bits, frac_bits, acc_bits): the default, a wrap-needing
#: accumulator and a multi-digit format.
FORMATS = ((16, 12, 32), (16, 12, 20), (32, 24, 32))


@pytest.mark.parametrize("suffix", PACKAGES, ids=lambda s: s or "top")
def test_all_names_what_the_jax_package_names(suffix):
    jax_pkg = importlib.import_module("warmup_fir_filter_tpu" + suffix)
    port_pkg = importlib.import_module("warmup_fir_filter_tpu_torch" + suffix)
    assert port_pkg.__all__ == jax_pkg.__all__
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None


def test_kernel_reexports_are_the_modules_functions():
    """The 2-D, FFT and dispatch entries ported earlier are re-exported,
    not copied."""
    from warmup_fir_filter_tpu_torch.kernels import dispatch, fft, fir2d

    for name in ("fir2d_fixed_mxu", "fir2d_fixed_frame", "pad_frame",
                 "fir2d_fixed_frame_overlap", "crop_frame_overlap",
                 "pad_frame_overlap"):
        assert getattr(kernels, name) is getattr(fir2d, name)
    for name in ("fft_rows_pallas", "fir_overlap_save_pallas",
                 "fir_overlap_save_quantized_pallas"):
        assert getattr(kernels, name) is getattr(fft, name)
    for name in ("fir1d_fixed_rows_auto", "fir2d_fixed_auto"):
        assert getattr(kernels, name) is getattr(dispatch, name)


def _fixed_cases(rng, taps):
    for fmt in FORMATS:
        for n in (1, 127, 300):
            h = rng.uniform(-1.5, 1.5, size=taps)
            x = rng.integers(0, 256, size=(3, n), dtype=np.uint8)
            yield fmt, h, x


@pytest.mark.parametrize("taps", [1, 3, 5, 64, 257])
def test_fir1d_fixed_rows_mxu_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = kernels.fir1d_fixed_rows_mxu(torch.from_numpy(x), h,
                                           QFormat(*fmt))
        want = np.asarray(jax_kernels.fir1d_fixed_rows_mxu(
            x, h, JaxQFormat(*fmt), interpret=True))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


@pytest.mark.parametrize("taps", [1, 5, 40])
def test_fir1d_fixed_rows_pallas_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = kernels.fir1d_fixed_rows_pallas(torch.from_numpy(x), h,
                                              QFormat(*fmt))
        want = np.asarray(jax_kernels.fir1d_fixed_rows_pallas(
            x, h, JaxQFormat(*fmt), interpret=True))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


@pytest.mark.parametrize("taps", [5, 300])
def test_fir1d_fixed_rows_mxu_window_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = fir1d_fixed_rows_mxu_window(torch.from_numpy(x), h,
                                          QFormat(*fmt))
        want = np.asarray(jax_fir_mxu.fir1d_fixed_rows_mxu_window(
            x, h, JaxQFormat(*fmt), interpret=True))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


def test_fixed_entries_raise_as_the_jax_ones():
    x = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="257"):
        kernels.fir1d_fixed_rows_mxu(x, np.ones(258) / 258)
    for entry in (kernels.fir1d_fixed_rows_mxu,
                  kernels.fir1d_fixed_rows_pallas,
                  fir1d_fixed_rows_mxu_window):
        with pytest.raises(ValueError, match="acc_bits"):
            entry(x, [0.5, 0.5], QFormat(16, 12, 40))


@pytest.mark.parametrize("tap", [3, 5])
def test_fir1d_ideal_rows_mxu_equals_jax_bank(rng, tap):
    """``test_fir_float_mxu.py``'s bank case and bound."""
    for name, h in FILTER_BANKS[tap].items():
        x = rng.integers(0, 256, size=(4, 300), dtype=np.uint8)
        got = kernels.fir1d_ideal_rows_mxu(torch.from_numpy(x), h)
        want = np.asarray(jax_kernels.fir1d_ideal_rows_mxu(x, h, block_rows=8))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_fir1d_ideal_rows_mxu_equals_jax_63tap(rng, precision):
    h = design_lowpass(63, 0.25)
    x = rng.uniform(-3, 3, size=(2, 512)).astype(np.float32)
    got = kernels.fir1d_ideal_rows_mxu(torch.from_numpy(x), h,
                                       precision=precision)
    want = np.asarray(jax_kernels.fir1d_ideal_rows_mxu(
        x, h, precision=precision, block_rows=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("up,down", [(2, 3), (1, 2), (4, 3)])
def test_resample_poly_mxu_equals_jax(rng, up, down):
    """``test_resample_mxu.py``'s rate cases and bound."""
    h = design_lowpass(63, 0.8 / max(up, down), gain=up)
    x = rng.integers(0, 256, size=(3, 2000)).astype(np.float32)
    got = resample_poly_mxu(torch.from_numpy(x), h, up, down)
    want = np.asarray(jax_resample_mxu.resample_poly_mxu(x, h, up, down))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0.02)


@pytest.mark.parametrize("channels,total,sub,g", [(2, 1024, 512, 1),
                                                  (3, 2048, 256, 4)])
def test_window_rows_pallas_equals_jax(rng, channels, total, sub, g):
    x = rng.integers(0, 256, size=(channels, total), dtype=np.uint8)
    carry = rng.integers(0, 256, size=(channels, 128), dtype=np.uint8)
    got = window_rows_pallas(torch.from_numpy(x), torch.from_numpy(carry),
                             sub, g)
    want = np.asarray(jax_window_copy.window_rows_pallas(x, carry, sub, g,
                                                         interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def _snr_above(bound):
    def compare(got, want):
        from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db

        assert snr_db(np.asarray(want, np.float64), got) > bound
    return compare


def _close(rtol, atol):
    def compare(got, want):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
    return compare


def _equal(got, want):
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(want))


def _u8_within_one(got, want):
    assert np.abs(got.astype(np.int32) - np.asarray(want, np.int32)).max() <= 1


def _fused_seg_tiles() -> int:
    """The smallest superblock the JAX fused kernel takes at 2/3 x 63 taps
    (a smaller superblock keeps interpret mode quick; the function is the
    same)."""
    from warmup_fir_filter_tpu.kernels import chain_fused as jax_fused

    h = np.zeros(63)
    h[31] = 1.0
    _, k_rows, ds, beta0, count = jax_fused.build_resample_band(h, 2, 3)
    for seg in (8, 16, 32, 64):
        if (seg * ds) % 128 == 0 and jax_fused._halo_tiles_for(
                ds, beta0 - (count - 1), k_rows, seg * ds // 128):
            return seg
    raise AssertionError("no superblock fits")


#: The 2-D frame entries' image: (H, W), taps, the frames' block rows.
FRAME_IMAGE = (24, 150)
FRAME_TAPS = (5, 5)
FRAME_BLOCK_ROWS = 8


def _host_array_cases():
    """(name, input kind, port call, JAX call, comparison at the JAX tests'
    bound: ``np.array_equal`` for the fixed-point entries) for every entry
    that takes samples; each call takes a tuple of numpy arrays."""
    from warmup_fir_filter_tpu.kernels import chain_fused as jax_fused
    from warmup_fir_filter_tpu.kernels import fft_pallas as jax_fft
    from warmup_fir_filter_tpu.kernels import fir_float_mxu as jax_ff
    from warmup_fir_filter_tpu.models import chain as jax_chain
    from warmup_fir_filter_tpu.ops import demod as jax_demod
    from warmup_fir_filter_tpu.ops import fftfilt as jax_fftfilt
    from warmup_fir_filter_tpu.ops import resample as jax_resample
    from warmup_fir_filter_tpu_torch.kernels import chain_fused, fft, fir_float
    from warmup_fir_filter_tpu_torch.kernels import resample as port_rs
    from warmup_fir_filter_tpu_torch.models import chain as port_chain
    from warmup_fir_filter_tpu_torch.ops import demod, fftfilt
    from warmup_fir_filter_tpu_torch.ops import resample as port_resample

    from warmup_fir_filter_tpu.kernels import dispatch as jax_dispatch
    from warmup_fir_filter_tpu.kernels import fir2d_mxu as jax_fir2d
    from warmup_fir_filter_tpu_torch.kernels import dispatch, fir2d

    cfg = port_chain.ChainConfig()
    h_rs, h_ch = cfg.resample_filter(), cfg.channelizer_filter()
    h5 = np.asarray(FILTER_BANKS[5]["sharpen"])
    h300 = design_lowpass(300, 0.2)
    h2d = np.asarray(FILTER_BANK_2D["gauss5"])
    fmt = QFormat(16, 12, 20)
    jfmt = JaxQFormat(16, 12, 20)
    t0, _, _, br = fir2d.frame_geometry(*FRAME_IMAGE, FRAME_TAPS[0],
                                        block_rows=FRAME_BLOCK_ROWS)
    core = (t0, *FRAME_IMAGE)
    ot0, _, _, obr, _ = fir2d.oframe_geometry(*FRAME_IMAGE, *FRAME_TAPS,
                                              block_rows=FRAME_BLOCK_ROWS)
    ocore = (ot0, *FRAME_IMAGE)
    fixed = [
        ("fir1d_fixed_rows_mxu", "u8",
         lambda x: kernels.fir1d_fixed_rows_mxu(x, h5, fmt),
         lambda x: jax_kernels.fir1d_fixed_rows_mxu(x, h5, jfmt,
                                                    interpret=True),
         _equal),
        ("fir1d_fixed_rows_pallas", "u8",
         lambda x: kernels.fir1d_fixed_rows_pallas(x, h300, fmt),
         lambda x: jax_kernels.fir1d_fixed_rows_pallas(x, h300, jfmt,
                                                       interpret=True),
         _equal),
        ("fir1d_fixed_rows_mxu_window", "u8",
         lambda x: fir1d_fixed_rows_mxu_window(x, h300, fmt),
         lambda x: jax_fir_mxu.fir1d_fixed_rows_mxu_window(
             x, h300, jfmt, interpret=True),
         _equal),
        ("fir1d_fixed_rows_auto", "u8",
         lambda x: dispatch.fir1d_fixed_rows_auto(x, h300, fmt),
         lambda x: jax_dispatch.fir1d_fixed_rows_auto(x, h300, jfmt),
         _equal),
        ("window_rows_pallas", "windows",
         lambda x, carry: window_rows_pallas(x, carry, 512, 1),
         lambda x, carry: jax_window_copy.window_rows_pallas(
             x, carry, 512, 1, interpret=True),
         _equal),
        ("fir2d_fixed_frame", "frame",
         lambda x: fir2d.fir2d_fixed_frame(x, h2d, fmt, core=core,
                                           block_rows=br),
         lambda x: jax_fir2d.fir2d_fixed_frame(x, h2d, jfmt, core=core,
                                               block_rows=br),
         _equal),
        ("fir2d_fixed_frame_overlap", "oframe",
         lambda x: fir2d.fir2d_fixed_frame_overlap(x, h2d, fmt, core=ocore,
                                                   block_rows=obr),
         lambda x: jax_fir2d.fir2d_fixed_frame_overlap(
             x, h2d, jfmt, core=ocore, block_rows=obr),
         _equal),
        ("fir2d_frame_overlap_bf16", "oframe",
         lambda x: fir2d.fir2d_frame_overlap_bf16(x, h2d, QFormat(),
                                                  core=ocore, block_rows=obr),
         lambda x: jax_fir2d.fir2d_frame_overlap_bf16(
             x, h2d, JaxQFormat(), core=ocore, block_rows=obr),
         _equal),
    ]
    h_rs_up = design_lowpass(63, 0.3, gain=2)
    h63 = design_lowpass(63, 0.25)
    k_f = cfg.demod_k_f
    seg = _fused_seg_tiles()
    return [
        ("chain_forward", "fm",
         lambda re, im: port_chain.chain_forward(re, im, cfg),
         lambda re, im: jax_chain.chain_forward(re, im,
                                                jax_chain.ChainConfig()),
         _snr_above(90.0)),
        ("chain_forward_fused", "fm",
         lambda re, im: chain_fused.chain_forward_fused(
             re, im, h_rs, h_ch, 2, 3, k_f, precision="highest"),
         lambda re, im: jax_fused.chain_forward_fused(
             re, im, h_rs, h_ch, 2, 3, k_f, precision="highest",
             seg_tiles=seg),
         _snr_above(95.0)),
        ("resample_poly", "rows",
         lambda x: port_resample.resample_poly(x, h_rs_up, 2, 3),
         lambda x: jax_resample.resample_poly(x, h_rs_up, 2, 3),
         _close(1e-5, 1e-5)),
        ("resample_poly_band", "rows",
         lambda x: port_rs.resample_poly_band(x, h_rs_up, 2, 3,
                                              precision="highest"),
         lambda x: resample_mxu_highest(x, h_rs_up),
         _close(1e-6, 1e-3)),
        ("resample_poly_mxu", "rows",
         lambda x: port_rs.resample_poly_mxu(x, h_rs_up, 2, 3),
         lambda x: jax_resample_mxu.resample_poly_mxu(x, h_rs_up, 2, 3),
         _close(1e-4, 0.02)),
        ("fm_demodulate", "fm",
         lambda re, im: demod.fm_demodulate(re, im, k_f),
         lambda re, im: jax_demod.fm_demodulate(re, im, k_f),
         _close(0.0, 1e-5)),
        ("fir1d_ideal_rows_band", "rows",
         lambda x: fir_float.fir1d_ideal_rows_band(x, h63,
                                                   precision="highest"),
         lambda x: jax_ff.fir1d_ideal_rows_mxu(x, h63, precision="highest"),
         _close(1e-5, 1e-5)),
        ("fir1d_ideal_rows_mxu", "rows",
         lambda x: fir_float.fir1d_ideal_rows_mxu(x, h63),
         lambda x: jax_ff.fir1d_ideal_rows_mxu(x, h63, block_rows=8),
         _close(1e-4, 1e-4)),
        ("fir_overlap_save", "u8",
         lambda x: fftfilt.fir_overlap_save(x, h63),
         lambda x: jax_fftfilt.fir_overlap_save(x, h63),
         _snr_above(100.0)),
        ("fft_rows_pallas", "fft",
         lambda x: np.stack([t.numpy() for t in fft.fft_rows_pallas(x)]),
         lambda x: np.stack([np.asarray(t)
                             for t in jax_fft.fft_rows_pallas(x)]),
         _snr_above(90.0)),
        ("fir_overlap_save_pallas", "u8",
         lambda x: fft.fir_overlap_save_pallas(x, h63),
         lambda x: jax_fft.fir_overlap_save_pallas(x, h63),
         _snr_above(80.0)),
        ("fir_overlap_save_quantized_pallas", "u8",
         lambda x: fft.fir_overlap_save_quantized_pallas(x, h63),
         lambda x: jax_fft.fir_overlap_save_quantized_pallas(x, h63),
         _u8_within_one),
        ("fir_overlap_save_stream", "rows",
         lambda x: fft.fir_overlap_save_stream(x, h63),
         lambda x: jax_fft.fir_overlap_save_stream(x, h63, r_windows=2),
         _snr_above(90.0)),
    ] + fixed


def resample_mxu_highest(x, h):
    return jax_resample_mxu.resample_poly_mxu(x, h, 2, 3, precision="highest")


HOST_ARRAY_ENTRIES = [case[0] for case in _host_array_cases()]


def _host_inputs(kind: str, rng) -> tuple:
    if kind == "fm":
        from warmup_fir_filter_tpu_torch.ops import demod

        seg = _fused_seg_tiles()
        msg = rng.standard_normal((8, 2 * seg * 192 + 333)) * 0.3
        return tuple(p.astype(np.float32) for p in demod.fm_modulate(msg, 0.05))
    if kind == "u8":
        return (rng.integers(0, 256, size=(2, 1500), dtype=np.uint8),)
    if kind == "fft":
        return (rng.standard_normal((5, 512)).astype(np.float32),)
    if kind == "windows":
        return (rng.integers(0, 256, size=(2, 1024), dtype=np.uint8),
                rng.integers(0, 256, size=(2, 128), dtype=np.uint8))
    if kind in ("frame", "oframe"):
        from warmup_fir_filter_tpu_torch.kernels import fir2d

        image = torch.from_numpy(rng.integers(0, 256, size=FRAME_IMAGE,
                                              dtype=np.uint8))
        pad = fir2d.pad_frame if kind == "frame" else (
            lambda x, taps_r, block_rows: fir2d.pad_frame_overlap(
                x, taps_r, FRAME_TAPS[1], block_rows=block_rows))
        frame, _ = pad(image, FRAME_TAPS[0], block_rows=FRAME_BLOCK_ROWS)
        return (frame.numpy(),)
    return (rng.standard_normal((3, 3000)).astype(np.float32),)


@pytest.mark.parametrize("name", HOST_ARRAY_ENTRIES)
def test_host_arrays_go_to_the_card(rng, name):
    """Given numpy arrays, each entry puts them on the card: without CUDA it
    raises with ``resolve_device``'s message and runs nothing on the host.
    The same data as CPU tensors gives the JAX function's result within the
    bound its tests use."""
    _, kind, port, jax_fn, compare = next(
        case for case in _host_array_cases() if case[0] == name)
    arrays = _host_inputs(kind, rng)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port(*arrays)
    got = port(*(torch.from_numpy(a) for a in arrays))
    got = got if isinstance(got, np.ndarray) else got.numpy()
    compare(got, np.asarray(jax_fn(*arrays)))


def test_auto_wide_accumulator_host_array_goes_to_the_card(rng):
    """acc_bits > 32 on a numpy array: the array goes to the card first,
    so without CUDA the device error, not an AttributeError of the host
    array; a CPU tensor still takes the golden."""
    from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
    from warmup_fir_filter_tpu_torch.kernels import dispatch

    x = rng.integers(0, 256, size=(2, 64), dtype=np.uint8)
    h = np.array([7.5, -8.0, 7.9])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dispatch.fir1d_fixed_rows_auto(x, h, QFormat(32, 12, 48))
    np.testing.assert_array_equal(
        dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x), h,
                                       QFormat(32, 12, 48)).numpy(),
        fir1d_fixed_golden_rows(x, h, JaxQFormat(32, 12, 48)))
