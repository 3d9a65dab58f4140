"""Kernels E, F and G (``kernels/fir2d.py``) against the JAX K6, K7 and K8.

The port carries the frame layouts and the encodings across, and its
kernels write the whole output frame as the TPU kernels do.  So these tests
hold, at the JAX tests' own sizes (``tests/test_fir2d_mxu.py``, at most
70 × 700):

- ``FixedFir2d``'s planes, plan, bias and ``needs_wrap`` against
  ``fir2d_mxu._quantize_2d`` and the bf16 planes against
  ``build_bf16_band_planes_2d``; the frame geometry and layouts against
  ``frame_geometry`` / ``oframe_geometry`` / ``pad_frame*`` / ``crop``;
- each plain version's **whole output frame** against the JAX kernel's,
  run in interpret mode: pad rows, pad tiles, spill columns and every
  duplicated boundary lane included;
- the kernels' cores (``csrc/wft_fir2d.cuh``, built with g++) against
  the plain versions, every work item with a warp's 32 lanes as one unit
  and ``mma.sync`` (int8 for E and F, bf16 for G) emulated from its PTX
  fragment layout (``csrc/wft_band_mma.cuh``; the bf16 emulation itself
  against a numpy matmul).  The CUDA kernels themselves are held to the
  plain versions on the card by ``chip_smoke.py``;
- a host array given to the image entries goes to the card, as the JAX
  functions put it on their accelerator.

Tolerance: every integer frame is ``np.array_equal`` (tolerance 0).  Kernel
G is too where ``bf16_2d_exact`` holds; elsewhere the bf16 taps cost
precision (SNR > 40 dB against the golden, ``tests/test_fir2d_mxu.py:338``)
and the f32 sums' order may differ between implementations (|diff| ≤ 1).
"""

import ctypes
import shutil
import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import fir2d_mxu
from warmup_fir_filter_tpu.ops.fftfilt import snr_db
from warmup_fir_filter_tpu.ops.fir2d import FILTER_BANK_2D, fir2d_fixed_golden
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import dispatch, fir2d
from warmup_fir_filter_tpu_torch.kernels.fir_band import band_planes_of
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

LANE = 128
BANK = sorted(FILTER_BANK_2D)
LAYOUTS = ["plain", "overlap"]


def _pad(layout: str, x: np.ndarray, taps: tuple[int, int], block_rows=8):
    """The frame of both packages, held equal; ``(jax, port, core)``."""
    if layout == "plain":
        jx, geo = fir2d_mxu.pad_frame(x, taps[0], block_rows=block_rows)
        px, pgeo = fir2d.pad_frame(torch.from_numpy(x), taps[0],
                                   block_rows=block_rows)
    else:
        jx, geo = fir2d_mxu.pad_frame_overlap(x, *taps, block_rows=block_rows)
        px, pgeo = fir2d.pad_frame_overlap(torch.from_numpy(x), *taps,
                                           block_rows=block_rows)
    assert pgeo == geo
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    return np.asarray(jx), px, geo


JAX_APPLY = {"plain": fir2d_mxu.fir2d_fixed_frame,
             "overlap": fir2d_mxu.fir2d_fixed_frame_overlap,
             "bf16": fir2d_mxu.fir2d_frame_overlap_bf16}
PORT_APPLY = {"plain": fir2d.fir2d_fixed_frame,
              "overlap": fir2d.fir2d_fixed_frame_overlap,
              "bf16": fir2d.fir2d_frame_overlap_bf16}


def _frames(kind: str, frame: np.ndarray, h, geo, qf=QFormat(), **kw):
    """One apply of the JAX kernel (interpret mode) and of the port's frame
    function on the same frame; both whole output frames."""
    t0, h_img, w_img, br = geo
    core = (t0, h_img, w_img)
    want = np.asarray(JAX_APPLY[kind](frame, h, qf, core=core, block_rows=br,
                                      **kw))
    got = PORT_APPLY[kind](torch.from_numpy(frame.copy()), h, qf, core=core,
                           block_rows=br, **kw).numpy()
    return got, want


def _check_frame(layout: str, x: np.ndarray, h, qf=QFormat(), block_rows=8):
    h = np.asarray(h)
    frame, _, geo = _pad(layout, x, h.shape, block_rows)
    got, want = _frames(layout, frame, h, geo, qf)
    np.testing.assert_array_equal(got, want)
    return got, geo


# ---------------------------------------------------------------------------
# Encoding and geometry
# ---------------------------------------------------------------------------


def _case_taps(rng, case: str) -> tuple[np.ndarray, QFormat]:
    return {
        "gauss5": lambda: (FILTER_BANK_2D["gauss5"], QFormat()),
        "sharpen5": lambda: (FILTER_BANK_2D["sharpen5"], QFormat()),
        "box3": lambda: (FILTER_BANK_2D["box3"], QFormat()),
        "laplacian": lambda: (FILTER_BANK_2D["laplacian"], QFormat()),
        "zero_row": lambda: (np.array([[0.25, 0.5, 0.25], [0.0] * 3,
                                       [0.25, 0.5, 0.25]]), QFormat()),
        "zeros": lambda: (np.zeros((3, 3)), QFormat()),
        "wide_wrap": lambda: (rng.uniform(-4, 4, (3, 3)), QFormat(acc_bits=18)),
        "q32": lambda: (rng.uniform(-100, 100, (4, 9)), QFormat(32, 24, 32)),
        "tall_257": lambda: (rng.uniform(-0.5, 0.5, (17, 257)), QFormat()),
        "even": lambda: (rng.uniform(-0.5, 0.5, (2, 4)), QFormat(16, 12, 20)),
    }[case]()


CASES = ["gauss5", "sharpen5", "box3", "laplacian", "zero_row", "zeros",
         "wide_wrap", "q32", "tall_257", "even"]


@pytest.mark.parametrize("digit_mode", ["exact", "top"])
@pytest.mark.parametrize("case", CASES)
def test_parameters_match_jax(rng, case, digit_mode):
    h, qf = _case_taps(rng, case)
    fir = fir2d.FixedFir2d.from_numpy(h, qf, digit_mode=digit_mode)
    h_fixed, planes, needs_wrap, bias = fir2d_mxu._quantize_2d(h, qf,
                                                               digit_mode)
    a_prev, a_cur, a_next, plan, left, center = planes
    np.testing.assert_array_equal(fir.h_fixed.numpy(), h_fixed)
    np.testing.assert_array_equal(fir2d.quantize_2d(h, qf, digit_mode),
                                  h_fixed)
    for got, want in ((fir.a_prev, a_prev), (fir.a_cur, a_cur),
                      (fir.a_next, a_next)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    assert fir.plan == plan and (fir.left, fir.center) == (left, center)
    assert fir.wrap == needs_wrap == bool(fir.needs_wrap)
    assert fir.bias_value == int(bias[0, 0]) == int(fir.bias)
    assert fir2d.build_tile_band_planes_2d(h_fixed)[3] == plan
    if fir.taps[1] <= 97:
        jax_bf16, jax_plan2 = fir2d_mxu.build_bf16_band_planes_2d(h_fixed)
        assert fir.plan2 == jax_plan2
        assert fir.a_bf16.dtype == torch.bfloat16
        np.testing.assert_array_equal(fir.a_bf16.float().numpy(),
                                      jax_bf16.astype(np.float32))
        assert fir2d.bf16_2d_exact(h_fixed, qf) == fir2d_mxu.bf16_2d_exact(
            h_fixed, qf)


@pytest.mark.parametrize("case", CASES)
def test_kernel_operands_rebuild_the_planes(rng, case):
    """What kernels E, F and G read (digit rows, the plane table, the bf16
    rows) is the same filter as the bands the plain versions multiply by."""
    h, qf = _case_taps(rng, case)
    fir = fir2d.FixedFir2d.from_numpy(h, qf)
    for got, want in zip(band_planes_of(fir.digits.numpy()),
                         (fir.a_prev, fir.a_cur, fir.a_next)):
        np.testing.assert_array_equal(got, want.numpy())
    table = fir.plane_table.numpy()
    planes = len(fir.plan)
    assert [int(kr) for kr in table[:planes, 0]] == [
        fir.taps[0] - 1 - rs for rs, _, _ in fir.plan]
    rebuilt = np.zeros(fir.h_fixed.shape, np.int64)
    for (kr, exp), digit in zip(table[:planes], fir.digits.numpy()[:planes]):
        rebuilt[kr] += digit.astype(np.int64) << int(exp)
    np.testing.assert_array_equal(rebuilt, fir.h_fixed.numpy())
    rows = fir.bf16_table.numpy()[: len(fir.plan2)]
    np.testing.assert_array_equal(
        fir.bf16_rows.numpy()[: len(fir.plan2)],
        fir.h_fixed.numpy()[rows].astype(np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float32))


def test_bf16_predicate_matches_jax():
    qf = QFormat()
    for name in BANK:
        h_fixed = qf.quantize_coeffs(FILTER_BANK_2D[name]).astype(np.int64)
        assert fir2d.bf16_2d_exact(h_fixed, qf) == fir2d_mxu.bf16_2d_exact(
            h_fixed, qf), name
    assert fir2d.bf16_2d_exact(
        qf.quantize_coeffs(FILTER_BANK_2D["sharpen5"]).astype(np.int64), qf)
    assert not fir2d.bf16_2d_exact(
        qf.quantize_coeffs(FILTER_BANK_2D["box3"]).astype(np.int64), qf)


@pytest.mark.parametrize("block_rows", [None, 8, 16, 40])
@pytest.mark.parametrize("taps", [(1, 2), (2, 4), (5, 5), (9, 3), (3, 97),
                                  (33, 129), (17, 257)])
def test_geometry_matches_jax(taps, block_rows):
    for h_img, w_img in ((1, 1), (20, 40), (70, 700), (300, 4099)):
        assert fir2d.frame_geometry(h_img, w_img, taps[0],
                                    block_rows=block_rows) == \
            fir2d_mxu.frame_geometry(h_img, w_img, taps[0],
                                     block_rows=block_rows)
        if taps[1] <= 97:
            assert fir2d.oframe_geometry(h_img, w_img, *taps,
                                         block_rows=block_rows) == \
                fir2d_mxu.oframe_geometry(h_img, w_img, *taps,
                                          block_rows=block_rows)


@pytest.mark.parametrize("taps", [(1, 2), (5, 5), (9, 3), (3, 97)])
def test_frames_and_crop_match_jax(rng, taps):
    x = rng.integers(0, 256, size=(13, 300), dtype=np.uint8)
    _pad("plain", x, taps, block_rows=16)
    frame, port, (t0, h_img, w_img, _) = _pad("overlap", x, taps,
                                              block_rows=16)
    core = (t0, h_img, w_img)
    np.testing.assert_array_equal(
        fir2d.crop_frame_overlap(port, taps[1], core).numpy(),
        np.asarray(fir2d_mxu.crop_frame_overlap(frame, taps[1], core)))
    np.testing.assert_array_equal(
        fir2d.crop_frame_overlap(port, taps[1], core).numpy(), x)


def test_geometry_refusals_match_jax(rng):
    x = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
    with pytest.raises(ValueError, match="overlapped frame"):
        fir2d.pad_frame_overlap(torch.from_numpy(x), 3, 98)
    frame, geo = fir2d.pad_frame(torch.from_numpy(x), 5, block_rows=8)
    with pytest.raises(ValueError, match="incompatible"):
        fir2d.fir2d_fixed_frame(frame[:-1], FILTER_BANK_2D["gauss5"],
                                core=geo[:3], block_rows=geo[3])
    frame, geo = fir2d.pad_frame_overlap(torch.from_numpy(x), 3, 3)
    with pytest.raises(ValueError, match="overlapped frame"):
        fir2d.fir2d_fixed_frame_overlap(frame, np.ones((3, 98)) / 300,
                                        core=geo[:3], block_rows=geo[3])
    with pytest.raises(ValueError, match="digit_mode"):
        fir2d.fir2d_fixed_frame_overlap(frame, np.ones((3, 3)) / 9,
                                        core=geo[:3], digit_mode="bottom")
    with pytest.raises(ValueError, match="int32 TPU sim path"):
        fir2d.fir2d_fixed_frame_overlap(frame, np.ones((3, 3)) / 9,
                                        QFormat(acc_bits=48), core=geo[:3])
    with pytest.raises(ValueError, match="2-D kernel"):
        fir2d.FixedFir2d.from_numpy(np.ones(5) / 5)
    with pytest.raises(ValueError, match="up to 257"):
        fir2d.FixedFir2d.from_numpy(np.ones((3, 258)) / 774)


# ---------------------------------------------------------------------------
# Plain versions against the JAX kernels (interpret mode), whole frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", BANK)
def test_plain_frame_bank(rng, name, layout):
    x = rng.integers(0, 256, size=(20, 40), dtype=np.uint8)
    h = FILTER_BANK_2D[name]
    got, geo = _check_frame(layout, x, h)
    if layout == "plain":
        t0, h_img, w_img, _ = geo
        crop = got[t0 : t0 + h_img, LANE : LANE + w_img]
    else:
        crop = fir2d.crop_frame_overlap(torch.from_numpy(got), h.shape[1],
                                        geo[:3]).numpy()
    np.testing.assert_array_equal(crop, fir2d_fixed_golden(x, h))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 4), (9, 3), (1, 2), (17, 5), (33, 3)])
def test_plain_frame_even_and_tall(rng, layout, shape):
    x = rng.integers(0, 256, size=(17, 33), dtype=np.uint8)
    _check_frame(layout, x, rng.uniform(-0.5, 0.5, shape))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_frame_multi_block_rows(rng, layout):
    x = rng.integers(0, 256, size=(70, 40), dtype=np.uint8)
    _check_frame(layout, x, FILTER_BANK_2D["gauss5"], block_rows=16)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("qf", [QFormat(acc_bits=18), QFormat(acc_bits=20)],
                         ids=str)
def test_plain_frame_wraparound(rng, layout, qf):
    h = rng.uniform(-4, 4, (3, 3))
    assert fir2d.FixedFir2d.from_numpy(h, qf).wrap
    x = rng.integers(0, 256, size=(12, 24), dtype=np.uint8)
    _check_frame(layout, x, h, qf)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_frame_all_zero_filter(rng, layout):
    x = rng.integers(0, 256, size=(12, 20), dtype=np.uint8)
    got, _ = _check_frame(layout, x, np.zeros((3, 3)))
    assert not got.any()


def test_plain_overlap_700_columns(rng):
    """Many overlapped tiles: the patch hands exact values across seams."""
    x = rng.integers(0, 256, size=(12, 700), dtype=np.uint8)
    got, geo = _check_frame("overlap", x, FILTER_BANK_2D["sharpen5"])
    np.testing.assert_array_equal(
        fir2d.crop_frame_overlap(torch.from_numpy(got), 5, geo[:3]).numpy(),
        fir2d_fixed_golden(x, FILTER_BANK_2D["sharpen5"]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_frame_of_noise(rng, layout):
    """A frame of noise: pad rows and tiles nonzero, the duplicated columns
    of the overlapped frame disagreeing.  Each tile reads its own copy and
    the kernels write the whole frame, as the JAX kernels do."""
    h = FILTER_BANK_2D["sharpen5"]
    x = rng.integers(0, 256, size=(20, 300), dtype=np.uint8)
    frame, _, geo = _pad(layout, x, h.shape)
    noise = rng.integers(0, 256, size=frame.shape, dtype=np.uint8)
    got, want = _frames(layout, noise, h, geo)
    np.testing.assert_array_equal(got, want)


def test_plain_inconsistent_duplicates(rng):
    """Only the duplicated boundary lanes of the interior tiles disagree."""
    h = FILTER_BANK_2D["gauss5"]
    x = rng.integers(0, 256, size=(16, 400), dtype=np.uint8)
    frame, _, geo = _pad("overlap", x, h.shape)
    frame = frame.copy()
    tiles = frame.reshape(frame.shape[0], -1, LANE)
    tiles[:, 1:-1, :2] = rng.integers(0, 256, size=tiles[:, 1:-1, :2].shape)
    tiles[:, 1:-1, -2:] = rng.integers(0, 256, size=tiles[:, 1:-1, -2:].shape)
    got, want = _frames("overlap", frame, h, geo)
    np.testing.assert_array_equal(got, want)
    t0, h_img, w_img, _ = geo
    assert not np.array_equal(
        fir2d.crop_frame_overlap(torch.from_numpy(got), 5,
                                 (t0, h_img, w_img)).numpy(),
        fir2d_fixed_golden(x, h))


@pytest.mark.parametrize("taps_c", [5, 85, 87, 97])
def test_overlap_output_is_a_fixed_point_up_to_85_columns(rng, taps_c):
    """Up to Lc = 85 (stride >= left) every copy of a duplicated column is
    the home tile's exact value, so the output re-embeds to itself.  From
    Lc = 87 on, the patch brings partial sums into the duplicates on the
    TPU, and the port writes the same bytes."""
    h = rng.uniform(0.0, 1.0, (3, taps_c))
    h /= h.sum()  # unit gain: outputs near mid-scale, no saturation
    x = rng.integers(0, 256, size=(12, 300), dtype=np.uint8)
    got, geo = _check_frame("overlap", x, h)
    crop = fir2d.crop_frame_overlap(torch.from_numpy(got), taps_c, geo[:3])
    np.testing.assert_array_equal(crop.numpy(), fir2d_fixed_golden(x, h))
    again, _ = fir2d.pad_frame_overlap(crop, 3, taps_c, block_rows=geo[3])
    assert np.array_equal(again.numpy(), got) == (taps_c <= 85)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chained_applies_through_scratch(rng, layout):
    """Two applies ping-ponging two frames through ``scratch``, as
    ``bench_2d.py:92-94`` chains them, equal the golden applied twice."""
    h = FILTER_BANK_2D["box3"]
    x = rng.integers(0, 256, size=(20, 260), dtype=np.uint8)
    _, frame, (t0, h_img, w_img, br) = _pad(layout, x, (3, 3))
    core = (t0, h_img, w_img)
    apply = PORT_APPLY[layout]
    other = torch.full_like(frame, 0xFF)
    mid = apply(frame, h, core=core, block_rows=br, scratch=other)
    assert mid.data_ptr() == other.data_ptr()
    out = apply(mid, h, core=core, block_rows=br, scratch=frame)
    assert out.data_ptr() == frame.data_ptr()
    crop = (out[t0 : t0 + h_img, LANE : LANE + w_img] if layout == "plain"
            else fir2d.crop_frame_overlap(out, 3, core))
    np.testing.assert_array_equal(
        crop.numpy(), fir2d_fixed_golden(fir2d_fixed_golden(x, h), h))


@pytest.mark.parametrize("kind", ["plain", "overlap", "bf16"])
def test_scratch_prefilled_and_aliasing(rng, kind):
    h = FILTER_BANK_2D["gauss5"]
    x = rng.integers(0, 256, size=(26, 150), dtype=np.uint8)
    _, frame, (t0, h_img, w_img, br) = _pad(
        "plain" if kind == "plain" else "overlap", x, (5, 5), 16)
    core = (t0, h_img, w_img)
    apply = PORT_APPLY[kind]
    fresh = apply(frame, h, core=core, block_rows=br)
    scratch = torch.full_like(frame, 0xFF)
    assert torch.equal(apply(frame, h, core=core, block_rows=br,
                             scratch=scratch), fresh)
    assert torch.equal(scratch, fresh)
    with pytest.raises(ValueError, match="shares memory"):
        apply(frame, h, core=core, block_rows=br, scratch=frame)
    tail = torch.empty(frame.numel() + LANE, dtype=torch.uint8)
    tail[LANE:] = frame.reshape(-1)
    frame_in_tail = tail[LANE:].view(frame.shape)
    with pytest.raises(ValueError, match="shares memory"):
        apply(frame_in_tail, h, core=core, block_rows=br,
              scratch=tail[: frame.numel()].view(frame.shape))
    with pytest.raises(ValueError, match="scratch"):
        apply(frame, h, core=core, block_rows=br, scratch=frame[:-1].clone())


@pytest.mark.parametrize("name", ["sharpen5", "gauss5"])
def test_bf16_exact_where_predicate_holds(rng, name):
    h = FILTER_BANK_2D[name]
    x = rng.integers(0, 256, size=(64, 200), dtype=np.uint8)
    frame, _, geo = _pad("overlap", x, (5, 5), block_rows=16)
    got, want = _frames("bf16", frame, h, geo)
    np.testing.assert_array_equal(got, want)
    exact, _ = _frames("overlap", frame, h, geo)
    np.testing.assert_array_equal(got, exact)


def _large_bf16_taps(rng) -> np.ndarray:
    """5×5 Q4.12 taps that are bf16-exact (multiples of 256 below 2^15)
    but whose f32 sums pass 2^24, so their order can round."""
    return rng.integers(-127, 128, size=(5, 5)) / 16.0


@pytest.mark.parametrize("qf", [QFormat(), QFormat(16, 12, 32)], ids=str)
def test_bf16_snr_gated_otherwise(rng, qf):
    """box3 (455 needs 9 mantissa bits), and large taps whose f32 sums pass
    2^24: SNR > 40 dB against the golden, |diff| <= 1 against the JAX
    kernel's frame."""
    h = FILTER_BANK_2D["box3"] if qf == QFormat() else _large_bf16_taps(rng)
    h_fixed = qf.quantize_coeffs(h).astype(np.int64)
    assert not fir2d.bf16_2d_exact(h_fixed, qf)
    x = rng.integers(0, 256, size=(48, 160), dtype=np.uint8)
    frame, _, geo = _pad("overlap", x, h.shape, block_rows=16)
    got, want = _frames("bf16", frame, h, geo, qf)
    assert np.abs(got.astype(np.int16) - want).max() <= 1
    crop = fir2d.crop_frame_overlap(torch.from_numpy(got), h.shape[1],
                                    geo[:3]).numpy()
    golden = fir2d_fixed_golden(x, h, qf).astype(np.float64)
    assert float(snr_db(golden, crop.astype(np.float64))) > 40.0


def test_top_digit_mode_matches_jax(rng):
    """``digit_mode="top"``: exact for single-digit rows (gauss5), the JAX
    kernel's frame for multi-digit ones (sharpen5's centre row)."""
    x = rng.integers(0, 256, size=(40, 150), dtype=np.uint8)
    for name in ("gauss5", "sharpen5"):
        h = FILTER_BANK_2D[name]
        frame, _, geo = _pad("overlap", x, (5, 5))
        got, want = _frames("overlap", frame, h, geo, digit_mode="top")
        np.testing.assert_array_equal(got, want)
        crop = fir2d.crop_frame_overlap(torch.from_numpy(got), 5, geo[:3])
        assert np.array_equal(crop.numpy(), fir2d_fixed_golden(x, h)) == (
            name == "gauss5")


@pytest.mark.parametrize("layout", ["overlap", "plain", "auto"])
def test_single_shot_matches_jax(rng, layout):
    for shape in ((5, 5), (3, 129), (2, 4)):
        if layout == "overlap" and shape[1] > 97:
            continue
        h = rng.uniform(-0.5, 0.5, shape)
        x = rng.integers(0, 256, size=(17, 150), dtype=np.uint8)
        got = fir2d.fir2d_fixed_mxu(torch.from_numpy(x), h, layout=layout,
                                    block_rows=8)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(fir2d_mxu.fir2d_fixed_mxu(
                x, h, block_rows=8, layout=layout)))
        np.testing.assert_array_equal(got.numpy(), fir2d_fixed_golden(x, h))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _launch_counts():
    return (fir2d.fir2d_frame.launches, fir2d.fir2d_oframe.launches,
            fir2d.fir2d_bf16.launches)


def test_wrappers_on_cpu_run_the_plain_versions(rng):
    before = _launch_counts()
    h = FILTER_BANK_2D["sharpen5"]
    fir = fir2d.FixedFir2d.from_numpy(h)
    x = torch.from_numpy(rng.integers(0, 256, size=(20, 40), dtype=np.uint8))
    frame, geo = fir2d.pad_frame(x, 5)
    assert torch.equal(fir2d.fir2d_frame(frame, fir, geo[:3]),
                       fir2d.fir2d_frame_plain(frame, fir, geo[:3]))
    frame, geo = fir2d.pad_frame_overlap(x, 5, 5)
    assert torch.equal(fir2d.fir2d_oframe(frame, fir, geo[:3]),
                       fir2d.fir2d_oframe_plain(frame, fir, geo[:3]))
    assert torch.equal(fir2d.fir2d_bf16(frame, fir, geo[:3]),
                       fir2d.fir2d_bf16_plain(frame, fir, geo[:3]))
    assert _launch_counts() == before


def test_host_array_goes_to_the_card(rng, monkeypatch):
    """A numpy image goes to the card, as the JAX entries put it on their
    accelerator: without CUDA the image entries raise and name
    ``device="cpu"``; a CPU tensor runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.integers(0, 256, size=(12, 40), dtype=np.uint8)
    h = FILTER_BANK_2D["gauss5"]
    for entry in (lambda: fir2d.pad_frame(x, 5),
                  lambda: fir2d.pad_frame_overlap(x, 5, 5),
                  lambda: fir2d.fir2d_fixed_mxu(x, h),
                  lambda: fir2d.fir2d_fixed_mxu(x, h, layout="plain"),
                  lambda: dispatch.fir2d_fixed_auto(x, h),
                  lambda: dispatch.fir2d_fixed_auto(x, np.ones((3, 258)) / 774)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()
    before = _launch_counts()
    got = dispatch.fir2d_fixed_auto(torch.from_numpy(x), h)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), fir2d_fixed_golden(x, h))
    assert fir2d.pad_frame(torch.from_numpy(x), 5)[0].device.type == "cpu"
    assert _launch_counts() == before


def test_wrappers_reject_bad_inputs(rng):
    fir = fir2d.FixedFir2d.from_numpy(FILTER_BANK_2D["gauss5"])
    frame, geo = fir2d.pad_frame_overlap(
        torch.from_numpy(rng.integers(0, 256, size=(8, 8), dtype=np.uint8)),
        5, 5)
    core = geo[:3]
    with pytest.raises(TypeError, match="uint8"):
        fir2d.fir2d_oframe(frame.to(torch.int32), fir, core)
    with pytest.raises(ValueError, match="multiple of 128"):
        fir2d.fir2d_oframe(frame[:, :-1], fir, core)
    with pytest.raises(ValueError, match="core"):
        fir2d.fir2d_oframe(frame, fir, (2, 8, 8))
    with pytest.raises(ValueError, match="device"):
        fir2d.fir2d_oframe(frame.to("meta"), fir, core)
    with pytest.raises(ValueError, match="overlapped frame"):
        fir2d.fir2d_oframe(frame, fir2d.FixedFir2d.from_numpy(
            np.ones((3, 98)) / 294), core)
    with pytest.raises(ValueError, match="int32 TPU sim path"):
        fir2d.fir2d_frame(frame, fir2d.FixedFir2d.from_numpy(
            FILTER_BANK_2D["gauss5"], QFormat(acc_bits=40)), core)


def test_module_buffers_move_with_the_module():
    fir = fir2d.FixedFir2d.from_numpy(FILTER_BANK_2D["sharpen5"])
    assert set(fir.state_dict()) == {
        "h_fixed", "a_prev", "a_cur", "a_next", "digits", "plane_table",
        "bias", "needs_wrap", "a_bf16", "bf16_rows", "bf16_table"}
    assert len(fir.exponents) == 6  # the plane count fir2d_mxu.py:27 names
    moved = fir.to("meta")
    assert moved.digits.device.type == "meta"
    assert moved.bf16_rows.device.type == "meta"


# ---------------------------------------------------------------------------
# The kernels' cores, built with g++
# ---------------------------------------------------------------------------

_KERNEL_HARNESS = """
#include <cstdint>
#include <vector>
#include "wft_fir2d.cuh"
using namespace wft;
// fir2d_frame.cu's kernel E (plain != 0) or F: every work item in turn, its
// chunks of planes staged and multiplied by each warp (a warp's lanes as
// one unit), then each warp's bytes into the item's tile and the tile
// written out (F's three ways).
extern "C" void frame_host(const uint8_t* x, uint8_t* y, long long hp,
                           long long wp, const int8_t* digits,
                           const int* table, int planes, int taps_r,
                           int taps_c, int t0, int core_h, int core_w,
                           uint32_t bias, int wrap, int frac_bits,
                           int acc_bits, int vec, int plain) {
  const Fir2dGeometry g{hp, wp, t0, core_h, core_w, taps_r, taps_c};
  const int center = taps_c / 2;
  const int left = taps_c - 1 - center;
  const EframeShape es = eframe_shape(taps_c);
  const int copy_words = plain ? es.copy_words : kOframeCopyWords;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long items =
      (hp + kOframeRows - 1) / kOframeRows * (wp / kLane);
  std::vector<uint8_t> buf(kOframeStageRows *
                           (plain ? es.row_bytes : kOframeRowBytes));
  std::vector<uint8_t> tile(kOframeTileBytes);
  std::vector<uint32_t> dc(kOframeMaxChunkPlanes * 4 * copy_words);
  std::vector<uint32_t> acc(kOframeWarps * kOframeNTiles * kLaneSlots * 4);
  const auto warp_acc = [&](int w) {
    return reinterpret_cast<uint32_t (*)[kLaneSlots][4]>(
        &acc[w * kOframeNTiles * kLaneSlots * 4]);
  };
  const auto epi = [&](uint32_t a) {
    return fixed_epilogue(a, wrap != 0, frac_bits, acc_bits);
  };
  // As the kernel: one chunk's copies built once, or each chunk's in turn.
  const bool single = planes > 0 && oframe_chunk_end(table, planes, 0) == planes;
  const auto build = [&](int p0, int p1) {
    for (int i = 0; i < (p1 - p0) * 4 * copy_words; ++i)
      dc[i] = oframe_copy_word(digits, taps_c, p0 + i / (4 * copy_words),
                               i % (4 * copy_words), copy_words);
  };
  if (single) build(0, planes);
  for (long long item = 0; item < items; ++item) {
    const OframeItem it = oframe_item(g, item);
    for (auto& a : acc) a = bias;
    for (int p0 = 0; !it.zero && p0 < planes;) {
      const int p1 = oframe_chunk_end(table, planes, p0);
      const int k0 = table[kFir2dPlaneFields * p0];
      if (plain) {
        eframe_stage(buf.data(), x, g, es, it.c, it.r0, k0, aligned, 0, 1);
      } else {
        oframe_stage(buf.data(), x, g, it.c, it.r0, k0, aligned, 0, 1);
      }
      if (!single) build(p0, p1);
      for (int w = 0; w < kOframeWarps; ++w) {
        if (plain) {
          eframe_warp(buf.data(), es, dc.data(), single ? 0 : p0, table, p0,
                      p1, k0, taps_c, w, warp_acc(w));
        } else {
          oframe_warp(buf.data(), dc.data(), single ? 0 : p0, table, p0, p1,
                      k0, left, center, w, warp_acc(w));
        }
      }
      p0 = p1;
    }
    for (int w = 0; w < kOframeWarps; ++w)
      oframe_tile(g, it, w, warp_acc(w), epi, tile.data());
    if (plain) {
      eframe_write(g, it, tile.data(), vec != 0, y, 0, 1);
    } else {
      oframe_write(g, it, tile.data(), vec != 0, y, 0, 1);
    }
  }
}
// fir2d_bf16.cu's kernel G: every work item in turn, each chunk's rows
// staged, widened to bf16 and multiplied row by row by each warp, then the
// tile written out three ways.
extern "C" void bf16_host(const uint8_t* x, uint8_t* y, long long hp,
                          long long wp, const float* w, const int* table,
                          int rows, int taps_r, int taps_c, int t0,
                          int core_h, int core_w, int frac_bits, int vec) {
  const Fir2dGeometry g{hp, wp, t0, core_h, core_w, taps_r, taps_c};
  const int center = taps_c / 2;
  const int left = taps_c - 1 - center;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const float scale = ldexpf(1.0f, -frac_bits);
  const long long items =
      (hp + kOframeRows - 1) / kOframeRows * (wp / kLane);
  std::vector<uint8_t> raw(kOframeBufBytes);
  std::vector<uint8_t> wide(kBf16BufBytes);
  std::vector<uint8_t> tile(kOframeTileBytes);
  std::vector<uint32_t> wc(kOframeChunk * kBf16RowWords);
  std::vector<float> acc(kOframeWarps * kOframeNTiles * kLaneSlots * 4);
  const auto warp_acc = [&](int v) {
    return reinterpret_cast<float (*)[kLaneSlots][4]>(
        &acc[v * kOframeNTiles * kLaneSlots * 4]);
  };
  const auto epi = [&](float a) { return bf16_epilogue(a, scale); };
  const bool single = rows > 0 && oframe_chunk_end<1>(table, rows, 0) == rows;
  const auto build = [&](int p0, int p1) {
    for (int i = 0; i < (p1 - p0) * kBf16RowWords; ++i)
      wc[i] = bf16_copy_word(w, taps_c, p0 + i / kBf16RowWords,
                             i % kBf16RowWords);
  };
  if (single) build(0, rows);
  for (long long item = 0; item < items; ++item) {
    const OframeItem it = oframe_item(g, item);
    for (auto& a : acc) a = 0.0f;
    for (int p0 = 0; !it.zero && p0 < rows;) {
      const int p1 = oframe_chunk_end<1>(table, rows, p0);
      oframe_stage(raw.data(), x, g, it.c, it.r0, table[p0], aligned, 0, 1);
      bf16_widen(raw.data(), wide.data(), 0, 1);
      if (!single) build(p0, p1);
      for (int v = 0; v < kOframeWarps; ++v)
        bf16_warp(wide.data(), wc.data(), single ? 0 : p0, table, p0, p1,
                  table[p0], left, center, v, warp_acc(v));
      p0 = p1;
    }
    for (int v = 0; v < kOframeWarps; ++v)
      oframe_tile(g, it, v, warp_acc(v), epi, tile.data());
    oframe_write(g, it, tile.data(), vec != 0, y, 0, 1);
  }
}
// One emulated mma.sync m16n8k16 bf16 over a warp's fragments (32 lanes).
extern "C" void mma_bf16_host(uint32_t* a, uint32_t* b, float* d) {
  mma_bf16(reinterpret_cast<float (*)[4]>(d),
           reinterpret_cast<uint32_t (*)[4]>(a),
           reinterpret_cast<uint32_t (*)[2]>(b));
}
"""


@pytest.fixture(scope="module")
def kernel_core(tmp_path_factory):
    """Kernels E, F and G's cores (``csrc/wft_fir2d.cuh``) built with g++;
    ``run(kind, frame, fir, core, vec=True, offset=0)`` with kind plain
    (E), overlap (F) or bf16 (G).  The frame and the output lie ``offset``
    bytes past a 16-byte boundary, so the staging takes the kernels' byte
    path where that is not 0; ``vec=False`` or an offset writes the output
    byte by byte, as for an output that is not 16-byte aligned.  The output
    starts as 0xAB, so an unwritten byte shows.  ``run.mma_bf16`` is the
    emulated bf16 MMA."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("fir2d")
    (work / "harness.cpp").write_text(_KERNEL_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.frame_host.argtypes = [vp, vp, ll, ll, vp, vp, i, i, i, i, i, i,
                               ctypes.c_uint32, i, i, i, i, i]
    lib.bf16_host.argtypes = [vp, vp, ll, ll, vp, vp, i, i, i, i, i, i, i, i]
    lib.mma_bf16_host.argtypes = [vp] * 3

    def at_offset(a: np.ndarray, offset: int) -> np.ndarray:
        """A copy of ``a`` that starts ``offset`` bytes past a 16-byte
        boundary."""
        buf = np.empty(a.size + 32, np.uint8)
        start = (-buf.ctypes.data) % 16 + offset
        view = buf[start : start + a.size].reshape(a.shape)
        view[...] = a
        return view

    def run(kind: str, frame: torch.Tensor, fir: fir2d.FixedFir2d,
            core, vec: bool = True, offset: int = 0) -> np.ndarray:
        x = at_offset(frame.numpy(), offset)
        y = at_offset(np.full(x.shape, 0xAB, np.uint8), offset)
        vec = vec and offset == 0
        geo = (x.ctypes.data, y.ctypes.data, x.shape[0], x.shape[1])
        if kind == "bf16":
            coeffs = np.ascontiguousarray(fir.bf16_rows.numpy())
            table = np.ascontiguousarray(fir.bf16_table.numpy())
            lib.bf16_host(*geo, coeffs.ctypes.data, table.ctypes.data,
                          len(fir.plan2), *fir.taps, *core,
                          fir.qformat.frac_bits, int(vec))
            return y.copy()
        coeffs = np.ascontiguousarray(fir.digits.numpy())
        table = np.ascontiguousarray(fir.plane_table.numpy())
        qf = fir.qformat
        lib.frame_host(*geo, coeffs.ctypes.data, table.ctypes.data,
                       len(fir.plan), *fir.taps, *core,
                       fir.bias_value & 0xFFFFFFFF, int(fir.wrap),
                       qf.frac_bits, qf.acc_bits, int(vec),
                       int(kind == "plain"))
        return y.copy()

    run.mma_bf16 = lib.mma_bf16_host
    return run


PLAIN = {"plain": fir2d.fir2d_frame_plain,
         "overlap": fir2d.fir2d_oframe_plain,
         "bf16": fir2d.fir2d_bf16_plain}


def _core_vs_plain(kernel_core, kind, x, fir, block_rows=16):
    if kind == "plain":
        frame, geo = fir2d.pad_frame(x, fir.taps[0], block_rows=block_rows)
    else:
        frame, geo = fir2d.pad_frame_overlap(x, *fir.taps,
                                             block_rows=block_rows)
    got = kernel_core(kind, frame, fir, geo[:3])
    want = PLAIN[kind](frame, fir, geo[:3]).numpy()
    return got, want


@pytest.mark.parametrize("qf", [QFormat(), QFormat(acc_bits=18),
                                QFormat(16, 12, 20), QFormat(32, 24, 32)],
                         ids=str)
@pytest.mark.parametrize("kind", ["plain", "overlap"])
def test_kernel_core_matches_plain(kernel_core, rng, kind, qf):
    """Even, tall (three and five 8-row chunks of tap rows) and wide
    filters, ragged sizes around the 32-row × 128-lane work item."""
    shapes = [(5, 5), (2, 4), (9, 3), (1, 2), (17, 5), (40, 3), (3, 97)]
    if kind == "plain":
        shapes += [(1, 1), (3, 98), (5, 257)]
    for shape in shapes:
        fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-2, 2, shape), qf)
        for h_img, w_img in ((1, 1), (37, 127), (20, 128), (70, 300)):
            x = torch.from_numpy(rng.integers(0, 256, size=(h_img, w_img),
                                              dtype=np.uint8))
            got, want = _core_vs_plain(kernel_core, kind, x, fir)
            np.testing.assert_array_equal(
                got, want, err_msg=f"{shape} {h_img}x{w_img} {qf}")


@pytest.mark.parametrize("kind", ["plain", "overlap"])
def test_kernel_core_bank_and_zero_filter(kernel_core, rng, kind):
    x = torch.from_numpy(rng.integers(0, 256, size=(70, 700), dtype=np.uint8))
    for h in [*FILTER_BANK_2D.values(), np.zeros((3, 3))]:
        fir = fir2d.FixedFir2d.from_numpy(h)
        got, want = _core_vs_plain(kernel_core, kind, x, fir)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["plain", "overlap", "bf16"])
def test_kernel_core_frame_of_noise(kernel_core, rng, kind):
    """Nonzero pad, disagreeing duplicates: the clamped halos and the
    masks as the plain versions (and so the JAX kernels) have them."""
    fir = fir2d.FixedFir2d.from_numpy(FILTER_BANK_2D["sharpen5"])
    for h_img, w_img in ((20, 300), (3, 130)):
        x = rng.integers(0, 256, size=(h_img, w_img), dtype=np.uint8)
        frame, geo = (fir2d.pad_frame(torch.from_numpy(x), 5) if kind ==
                      "plain" else fir2d.pad_frame_overlap(
                          torch.from_numpy(x), 5, 5))
        noise = torch.from_numpy(rng.integers(0, 256, size=frame.shape,
                                              dtype=np.uint8))
        np.testing.assert_array_equal(
            kernel_core(kind, noise, fir, geo[:3]),
            PLAIN[kind](noise, fir, geo[:3]).numpy())


def test_kernel_core_bf16(kernel_core, rng):
    """Equal to the plain version where every f32 sum is exact; within one
    elsewhere (large taps in Q4.12 with a 32-bit accumulator)."""
    x = torch.from_numpy(rng.integers(0, 256, size=(37, 300), dtype=np.uint8))
    for h in (FILTER_BANK_2D["sharpen5"], FILTER_BANK_2D["gauss5"],
              FILTER_BANK_2D["box3"], rng.uniform(-0.5, 0.5, (17, 5)),
              rng.uniform(-0.5, 0.5, (2, 97))):
        got, want = _core_vs_plain(kernel_core, "bf16",
                                   x, fir2d.FixedFir2d.from_numpy(h))
        np.testing.assert_array_equal(got, want)
    fir = fir2d.FixedFir2d.from_numpy(_large_bf16_taps(rng),
                                      QFormat(16, 12, 32))
    got, want = _core_vs_plain(kernel_core, "bf16", x, fir)
    assert np.abs(got.astype(np.int16) - want).max() <= 1


OFRAME_LC = [2, 3, 5, 33, 85, 86, 87, 97]
OFRAME_LR = [1, 2, 5, 17, 33]
OFRAME_FORMATS = [QFormat(), QFormat(acc_bits=18), QFormat(16, 12, 20),
                  QFormat(32, 24, 32)]


@pytest.mark.parametrize("taps_r", OFRAME_LR)
@pytest.mark.parametrize("taps_c", OFRAME_LC)
def test_oframe_core_grid(kernel_core, rng, taps_c, taps_r):
    """Kernel F's core, whole frames: Lc from 2 to 97 (86-97, where the
    stride is below left + center, among them) × Lr up to 33 (tap rows in
    several staged chunks), the formats in turn (wrapping ones among them),
    rows over two or more 32-row work items."""
    qf = OFRAME_FORMATS[(OFRAME_LC.index(taps_c) + taps_r) % 4]
    fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-2, 2, (taps_r, taps_c)),
                                      qf)
    x = torch.from_numpy(rng.integers(0, 256, size=(37 + taps_r, 300),
                                      dtype=np.uint8))
    got, want = _core_vs_plain(kernel_core, "overlap", x, fir)
    np.testing.assert_array_equal(got, want, err_msg=f"{fir.taps} {qf}")


@pytest.mark.parametrize("taps_c", OFRAME_LC)
def test_oframe_core_three_tiles(kernel_core, rng, taps_c):
    """The narrowest frames with an image: one interior tile between the two
    pad tiles, whose boundary lanes come from the pad tiles' items; and a
    noise frame of that shape."""
    fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-1, 1, (3, taps_c)))
    stride = LANE - (taps_c - 1)
    for w_img in (1, stride):
        x = torch.from_numpy(rng.integers(0, 256, size=(20, w_img),
                                          dtype=np.uint8))
        frame, geo = fir2d.pad_frame_overlap(x, *fir.taps, block_rows=16)
        assert frame.shape[1] == 3 * LANE
        for src in (frame, torch.from_numpy(rng.integers(
                0, 256, size=frame.shape, dtype=np.uint8))):
            want = fir2d.fir2d_oframe_plain(src, fir, geo[:3]).numpy()
            for vec in (True, False):
                np.testing.assert_array_equal(
                    kernel_core("overlap", src, fir, geo[:3], vec), want)


@pytest.mark.parametrize("taps_c", [5, 87, 97])
def test_oframe_core_chained(kernel_core, rng, taps_c):
    """Two applies through kernel F's core, the first's output frame fed
    straight back in, equal two applies of the plain version (for Lc >= 87
    that is the TPU's inexact chain, byte for byte)."""
    h = rng.uniform(0.0, 1.0, (3, taps_c))
    fir = fir2d.FixedFir2d.from_numpy(h / h.sum())
    x = torch.from_numpy(rng.integers(0, 256, size=(30, 400), dtype=np.uint8))
    frame, geo = fir2d.pad_frame_overlap(x, 3, taps_c, block_rows=16)
    core = geo[:3]
    once = kernel_core("overlap", frame, fir, core)
    twice = kernel_core("overlap", torch.from_numpy(once), fir, core)
    want = fir2d.fir2d_oframe_plain(fir2d.fir2d_oframe_plain(frame, fir, core),
                                    fir, core)
    np.testing.assert_array_equal(twice, want.numpy())


def _bf16_fragments(a: np.ndarray, b: np.ndarray, d: np.ndarray):
    """A warp's fragments of mma.sync.aligned.m16n8k16.row.col with bf16
    operands, from the PTX ISA's layout: lane 4g + t holds A rows g and
    g + 8 at k 2t, 2t+1 and 8+2t, 9+2t, B column g at the same k (the lower
    k in the lower half of a word), D (g, 2t), (g, 2t+1), (g+8, 2t),
    (g+8, 2t+1)."""
    bits = (np.ascontiguousarray(a, ml_dtypes.bfloat16).view(np.uint16),
            np.ascontiguousarray(b, ml_dtypes.bfloat16).view(np.uint16))

    def word(v):
        return int(v[0]) | int(v[1]) << 16

    fa = np.zeros((32, 4), np.uint32)
    fb = np.zeros((32, 2), np.uint32)
    fd = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (row, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                        (g, 8 + 2 * t), (g + 8, 8 + 2 * t))):
            fa[lane, reg] = word(bits[0][row, k : k + 2])
        fb[lane, 0] = word(bits[1][2 * t : 2 * t + 2, g])
        fb[lane, 1] = word(bits[1][8 + 2 * t : 10 + 2 * t, g])
        for j in range(4):
            fd[lane, j] = d[g + 8 * (j >> 1), 2 * t + (j & 1)]
    return fa, fb, fd


@pytest.mark.parametrize("case", ["samples", "signed", "accumulate"])
def test_mma_bf16_emulation_matches_matmul(kernel_core, rng, case):
    """The host emulation of mma.sync m16n8k16 bf16 → f32 (what the CPU
    tests run in place of kernel G's tensor cores) against a numpy matmul,
    from fragments packed here by the PTX layout: u8 samples by bf16 taps,
    signed bf16 values of every magnitude, and a nonzero accumulator.  The
    float64 sum of each element is exact here, so the emulation's one
    rounding to f32 gives it to the last bit."""
    a = rng.integers(0, 256, size=(16, 16)).astype(np.float64)
    b = (rng.integers(-255, 256, size=(16, 8)) * 256.0)
    d = np.zeros((16, 8))
    if case == "signed":
        a = rng.integers(-128, 128, size=(16, 16)) * 2.0 ** rng.integers(
            -8, 8, size=(16, 16))
        b = rng.integers(-128, 128, size=(16, 8)) * 2.0 ** rng.integers(
            -8, 8, size=(16, 8))
    elif case == "accumulate":
        d = rng.integers(-2**20, 2**20, size=(16, 8)).astype(np.float64)
    fa, fb, fd = _bf16_fragments(a, b, d)
    kernel_core.mma_bf16(fa.ctypes.data, fb.ctypes.data, fd.ctypes.data)
    want = (d + a @ b).astype(np.float32)
    got = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            got[g + 8 * (j >> 1), 2 * t + (j & 1)] = fd[lane, j]
    np.testing.assert_array_equal(got, want)


EFRAME_LC = [2, 97, 98, 129, 200, 257]
EFRAME_LR = [1, 2, 5, 17, 33]
EFRAME_FORMATS = [QFormat(), QFormat(acc_bits=18), QFormat(acc_bits=20),
                  QFormat(16, 12, 20), QFormat(32, 24, 32)]


@pytest.mark.parametrize("taps_r", EFRAME_LR)
@pytest.mark.parametrize("taps_c", EFRAME_LC)
def test_eframe_core_grid(kernel_core, rng, taps_c, taps_r):
    """Kernel E's core, whole frames: Lc from 2 to 257 (97/98 either side
    of the overlapped frame's reach, 257 the widest band: 9 k32 chunks an
    n8 tile) × Lr up to 33 (tap rows in up to five staged chunks), the
    formats in turn (wrapping at acc_bits 18 and 20 among them), rows over
    two or more 32-row items, three interior tiles."""
    i, k = EFRAME_LC.index(taps_c), EFRAME_LR.index(taps_r)
    qf = EFRAME_FORMATS[(i + k) % len(EFRAME_FORMATS)]
    fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-2, 2, (taps_r, taps_c)),
                                      qf)
    x = torch.from_numpy(rng.integers(0, 256, size=(37 + taps_r, 300),
                                      dtype=np.uint8))
    got, want = _core_vs_plain(kernel_core, "plain", x, fir)
    np.testing.assert_array_equal(got, want, err_msg=f"{fir.taps} {qf}")


@pytest.mark.parametrize("width", [1, 127, 128, 700, 4099])
def test_eframe_core_widths(kernel_core, rng, width):
    """Kernel E's core at config 3's 3 × 129 shape over widths that leave
    the last tile's spill columns 127, 1, 0, 68 and 125 wide, and on a
    noise frame of that width (pad rows and tiles nonzero)."""
    fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-1, 1, (3, 129)))
    x = torch.from_numpy(rng.integers(0, 256, size=(20, width),
                                      dtype=np.uint8))
    got, want = _core_vs_plain(kernel_core, "plain", x, fir)
    np.testing.assert_array_equal(got, want)
    frame, geo = fir2d.pad_frame(x, 3, block_rows=16)
    noise = torch.from_numpy(rng.integers(0, 256, size=frame.shape,
                                          dtype=np.uint8))
    np.testing.assert_array_equal(
        kernel_core("plain", noise, fir, geo[:3]),
        fir2d.fir2d_frame_plain(noise, fir, geo[:3]).numpy())


@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("kind", ["plain", "bf16"])
def test_core_at_byte_offsets(kernel_core, rng, kind, offset):
    """Frames and outputs at a byte offset from a 16-byte boundary: staged
    byte by byte and written byte by byte, as the kernels do for a frame
    or a ``scratch`` that is not 16-byte aligned."""
    taps = (3, 129) if kind == "plain" else (5, 5)
    fir = fir2d.FixedFir2d.from_numpy(rng.uniform(-1, 1, taps) / taps[1])
    x = torch.from_numpy(rng.integers(0, 256, size=(40, 300),
                                      dtype=np.uint8))
    frame, geo = (fir2d.pad_frame(x, taps[0], block_rows=16) if kind ==
                  "plain" else fir2d.pad_frame_overlap(x, *taps,
                                                       block_rows=16))
    np.testing.assert_array_equal(
        kernel_core(kind, frame, fir, geo[:3], offset=offset),
        PLAIN[kind](frame, fir, geo[:3]).numpy())


BF16_LC = [2, 3, 5, 33, 85, 86, 87, 97]
BF16_LR = [1, 2, 5, 17]


@pytest.mark.parametrize("taps_r", BF16_LR)
@pytest.mark.parametrize("taps_c", BF16_LC)
def test_bf16_core_grid(kernel_core, rng, taps_c, taps_r):
    """Kernel G's core, whole frames: Lc from 2 to 97 × Lr up to 17 (tap
    rows in up to three staged chunks), taps scaled so that every f32 sum
    stays an exact integer (then any order of summation gives the same
    frame) and, on the narrowest frame of one interior tile, taps whose
    sums pass 2^24 (within 1)."""
    h = rng.uniform(-2, 2, (taps_r, taps_c))
    fir = fir2d.FixedFir2d.from_numpy(h / (taps_r * taps_c))
    assert 255 * float(fir.bf16_rows.double().abs().sum()) < 2 ** 24
    x = torch.from_numpy(rng.integers(0, 256, size=(37 + taps_r, 300),
                                      dtype=np.uint8))
    got, want = _core_vs_plain(kernel_core, "bf16", x, fir)
    np.testing.assert_array_equal(got, want, err_msg=f"{fir.taps}")
    fir = fir2d.FixedFir2d.from_numpy(h * 8, QFormat(16, 12, 32))
    x = torch.from_numpy(rng.integers(0, 256, size=(20, 129 - taps_c),
                                      dtype=np.uint8))
    got, want = _core_vs_plain(kernel_core, "bf16", x, fir)
    assert np.abs(got.astype(np.int16) - want).max() <= 1
