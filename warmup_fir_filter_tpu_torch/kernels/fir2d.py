"""Kernels E, F and G: the 2-D fixed-point FIR over padded frames (ports K6-K8).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir2d_mxu.py``.  The frame
layouts and the coefficient encodings are carried over exactly, so that a
frame made by either package is a frame of the other:

- the **plain frame** (:func:`pad_frame`, ``:403``): the image at rows
  ``[t0, t0 + H)`` and columns ``[128, 128 + W)`` of an ``(Hp, Wp)`` u8
  buffer, zeros elsewhere;
- the **overlapped frame** (:func:`pad_frame_overlap`, ``:544``): 128-lane
  tiles at a stride of ``128 - (Lc - 1)`` image columns, so adjacent tiles
  duplicate ``Lc - 1`` boundary columns, and a zero tile on each side;
- the quantized ``(Lr, Lc)`` taps split per tap row into signed base-256
  digit planes, the power of two factored **per tap row**
  (:func:`build_tile_band_planes_2d`, ``:95``); samples rebiased to
  ``x ^ 0x80`` and the constant ``128 · Σh`` (plus the rounding bias where
  no wrap is possible) starting the accumulator;
- for K8, one bf16 band per tap row (:func:`build_bf16_band_planes_2d`,
  ``:968``), f32 sums and the float epilogue ``floor(acc · 2^-fb + 0.5)``.

Each kernel writes the whole output frame, as the TPU kernel does: pad
rows, pad tiles and spill columns are zero, and on the overlapped frame
every lane of a tile is the TPU kernel's value for it, including the
boundary lanes it patches from the neighbouring tiles' accumulators.  So
the output frame equals the JAX kernel's byte for byte, and a filtered
frame can be fed straight back in.

:class:`FixedFir2d` holds a prepared filter as buffers.  The wrappers
:func:`fir2d_frame` (kernel E, ``csrc/fir2d_frame.cu``), :func:`fir2d_oframe`
(kernel F, same source) and :func:`fir2d_bf16` (kernel G,
``csrc/fir2d_bf16.cu``) launch their kernel on a CUDA tensor and run the
plain version (:func:`fir2d_frame_plain`, :func:`fir2d_oframe_plain`,
:func:`fir2d_bf16_plain`) on a CPU tensor.  All three kernels run their
band products on the tensor cores (E and F int8, G bf16) and build the
bands' shifted tap copies in shared memory from ``digits`` or
``bf16_rows``.  The image entries (:func:`pad_frame`,
:func:`pad_frame_overlap`, :func:`fir2d_fixed_mxu`) run on a tensor's
device and put a host array on the card (:func:`as_image`).  The frame
functions keep the JAX names: :func:`fir2d_fixed_frame`, :func:`fir2d_fixed_frame_overlap`,
:func:`fir2d_frame_overlap_bf16` and the single-shot
:func:`fir2d_fixed_mxu`.  Their ``scratch`` is the output buffer: written
in place and returned; it may not share memory with the input, because a
CTA reads input rows that another CTA's output rows would overwrite.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch._build import resolve_device
from warmup_fir_filter_tpu_torch.kernels.fir_band import (
    LANE,
    MAX_TAPS,
    band_bias,
    band_planes_of,
    factor_pow2,
    plain_epilogue,
    signed_base256_digits,
)
from warmup_fir_filter_tpu_torch.ops.fir2d import require_int32_format
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

#: Maximum column overlap (Lc - 1) of the overlapped frame
#: (``fir2d_mxu.py:511``).
OFRAME_MAX_OVERLAP = 96
MASK32 = 0xFFFFFFFF


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def tap_row_planes(h_fixed: np.ndarray) -> list[tuple[int, int, np.ndarray]]:
    """``(kr, exponent, digits)`` of every kept (tap-row × digit) plane.

    In the plan order of ``fir2d_mxu.py:144-158``: tap rows top to bottom,
    all-zero rows skipped, the power of two factored per row, all-zero
    digits skipped; the exponent is ``8·digit + row pow2``.
    """
    h_fixed = np.asarray(h_fixed, dtype=np.int64)
    if h_fixed.shape[1] > MAX_TAPS:
        raise ValueError(f"2-D kernel supports up to {MAX_TAPS} column taps, "
                         f"got {h_fixed.shape[1]}.")
    planes = []
    for kr, row in enumerate(h_fixed):
        if not np.any(row):
            continue
        reduced, pow2 = factor_pow2(row)
        for b, digit in enumerate(signed_base256_digits(reduced)):
            if np.any(digit):
                planes.append((kr, 8 * b + pow2, digit))
    return planes


def build_tile_band_planes_2d(h_fixed: np.ndarray):
    """``(a_prev, a_cur, a_next, plan, left, center)`` (``fir2d_mxu.py:95``).

    The tri-tile band planes of every kept plane (``a_cur[p][j, i] =
    digit_p[i + center - j]``, the side bands trimmed to ``left`` and
    ``center`` rows) and the plan of ``(row_shift, exponent, plane)`` with
    ``row_shift = Lr - 1 - kr``.  An all-zero filter has an empty plan and
    one zero plane.
    """
    h_fixed = np.asarray(h_fixed, dtype=np.int64)
    taps_r, taps_c = h_fixed.shape
    planes = tap_row_planes(h_fixed)
    digits = (np.stack([d for _, _, d in planes]) if planes
              else np.zeros((1, taps_c), np.int8))
    a_prev, a_cur, a_next = band_planes_of(digits)
    plan = tuple((taps_r - 1 - kr, exp, p)
                 for p, (kr, exp, _) in enumerate(planes))
    center = taps_c // 2
    return a_prev, a_cur, a_next, plan, taps_c - 1 - center, center


def _top_digit_round(h_fixed: np.ndarray) -> np.ndarray:
    """Each tap row rounded to its top signed base-256 digit
    (``fir2d_mxu.py:341``): single-digit rows stay exact, the others lose
    their low digits (SNR-gated, never chosen silently)."""
    out = np.asarray(h_fixed, np.int64).copy()
    for kr in range(out.shape[0]):
        row = out[kr]
        if not np.any(row):
            continue
        reduced, pow2 = factor_pow2(row)
        d = signed_base256_digits(reduced).shape[0]
        if d <= 1:
            continue
        q = 256 ** (d - 1)
        top = np.clip(np.round(reduced / q), -128, 127).astype(np.int64)
        out[kr] = (top * q) << pow2
    return out


def quantize_2d(h, qformat: QFormat, digit_mode: str = "exact") -> np.ndarray:
    """The quantized 2-D taps as int64, ``fir2d_mxu.py:365-372``: rint and
    clip per tap, then the digit mode (``"exact"`` or ``"top"``)."""
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    if h_fixed.ndim != 2:
        raise ValueError(f"2-D FIR expects a 2-D kernel, got {h_fixed.shape}")
    if digit_mode == "top":
        return _top_digit_round(h_fixed)
    if digit_mode != "exact":
        raise ValueError(f"unknown digit_mode {digit_mode!r}")
    return h_fixed


def _bf16_values(values: np.ndarray) -> torch.Tensor:
    """int64 → f32 → bf16, round to nearest even (``fir2d_mxu.py:991-994``)."""
    return torch.from_numpy(np.asarray(values, np.int64).astype(np.float32)
                            ).to(torch.bfloat16)


def bf16_2d_exact(h_fixed: np.ndarray, qformat: QFormat) -> bool:
    """Whether the bf16 path is provably bit-exact (``fir2d_mxu.py:938``):
    every tap is bf16-exact, ``255·Σ|h| + 2^(fb-1) < 2^24`` (every f32 sum
    is an exact integer) and no accumulator wrap is needed."""
    h_fixed = np.asarray(h_fixed, np.int64)
    as_bf16 = _bf16_values(h_fixed).to(torch.float64).numpy()
    if not np.array_equal(as_bf16, h_fixed.astype(np.float64)):
        return False
    worst = 255 * int(np.abs(h_fixed).sum()) + (1 << (qformat.frac_bits - 1))
    return worst < (1 << 24) and worst < (1 << (qformat.acc_bits - 1))


def build_bf16_band_planes_2d(h_fixed: np.ndarray):
    """``(a_cur, plan2)`` of K8 (``fir2d_mxu.py:968``): one (128, 128) bf16
    band per nonzero tap row, ``a[j, i] = bf16(row[i + center - j])``, and
    ``plan2`` of ``(row_shift, plane)`` with ``row_shift = Lr - 1 - kr``."""
    h_fixed = np.asarray(h_fixed, np.int64)
    taps_r, taps_c = h_fixed.shape
    center = taps_c // 2
    k = np.arange(LANE)[None, :] + center - np.arange(LANE)[:, None]
    valid = (k >= 0) & (k < taps_c)
    planes, plan2 = [], []
    for kr in range(taps_r):
        row = h_fixed[kr]
        if not np.any(row):
            continue
        a = np.zeros((LANE, LANE), np.int64)
        a[valid] = row[k[valid]]
        plan2.append((taps_r - 1 - kr, len(planes)))
        planes.append(_bf16_values(a))
    if not planes:
        planes.append(torch.zeros((LANE, LANE), dtype=torch.bfloat16))
    return torch.stack(planes), tuple(plan2)


# ---------------------------------------------------------------------------
# Frame geometry (fir2d_mxu.py:385-412, :514-568, :1189-1200)
# ---------------------------------------------------------------------------


def frame_geometry(
    h_img: int, w_img: int, taps_r: int, *, block_rows: int | None = None
) -> tuple[int, int, int, int]:
    """Plain-frame geometry ``(t0, hp, wp, block_rows)`` of an image.

    The core sits at rows ``[t0, t0 + h_img)``, columns ``[128, 128 +
    w_img)``.  ``block_rows`` is the TPU kernel's row block; the CUDA
    kernels do not use it, but it sets ``hp`` and so the frame's shape.
    """
    t0 = _round_up(max(taps_r - 1, 1), 8)
    center_r = taps_r // 2
    wp = 2 * LANE + _round_up(max(w_img, 1), LANE)
    if block_rows is None:
        block_rows = max(t0, _round_up(2 * 1024 * 1024 // wp, t0))
    else:
        block_rows = _round_up(block_rows, t0)
    hp = _round_up(t0 + h_img + center_r, block_rows)
    return t0, hp, wp, block_rows


def as_image(x_u8) -> torch.Tensor:
    """``x_u8`` as an (H, W) uint8 tensor.  A torch tensor keeps its device
    (a CPU tensor runs the plain versions); a host array goes to the card,
    as the JAX functions put it on their accelerator, and raises where
    there is no CUDA (:func:`resolve_device`)."""
    device = (x_u8.device if isinstance(x_u8, torch.Tensor)
              else resolve_device("cuda"))
    x = torch.as_tensor(x_u8, dtype=torch.uint8, device=device)
    if x.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got shape {tuple(x.shape)}")
    return x


def pad_frame(x_u8, taps_r: int, *, block_rows: int | None = None):
    """Embed an (H, W) image into the plain frame, on the image's device
    (:func:`as_image`).

    Returns ``(x_ext, (t0, h_img, w_img, block_rows))``.
    """
    x = as_image(x_u8)
    h_img, w_img = x.shape
    t0, hp, wp, block_rows = frame_geometry(h_img, w_img, taps_r,
                                            block_rows=block_rows)
    x_ext = F.pad(x, (LANE, wp - LANE - w_img, t0, hp - t0 - h_img))
    return x_ext, (t0, h_img, w_img, block_rows)


def oframe_geometry(
    h_img: int, w_img: int, taps_r: int, taps_c: int, *,
    block_rows: int | None = None,
) -> tuple[int, int, int, int, int]:
    """Overlapped-frame geometry ``(t0, hp, wp, block_rows, stride)``.

    Rows as :func:`frame_geometry`; ``ceil(w_img / stride)`` interior tiles
    plus a zero tile each side.  Interior tile ``c`` (from 1) holds image
    columns ``[(c-1)·stride - left, (c-1)·stride - left + 128)``.
    """
    overlap = taps_c - 1
    if not 0 < overlap <= OFRAME_MAX_OVERLAP:
        raise ValueError(
            f"overlapped frame needs 1 < taps_c <= {OFRAME_MAX_OVERLAP + 1}, "
            f"got {taps_c}."
        )
    stride = LANE - overlap
    t0 = _round_up(max(taps_r - 1, 1), 8)
    center_r = taps_r // 2
    interior = -(-max(w_img, 1) // stride)
    wp = (interior + 2) * LANE
    if block_rows is None:
        block_rows = max(t0, _round_up(2 * 1024 * 1024 // wp, t0))
    else:
        block_rows = _round_up(block_rows, t0)
    hp = _round_up(t0 + h_img + center_r, block_rows)
    return t0, hp, wp, block_rows, stride


def pad_frame_overlap(
    x_u8, taps_r: int, taps_c: int, *, block_rows: int | None = None
):
    """Embed an (H, W) image into the overlapped frame, on its device
    (:func:`as_image`).

    Returns ``(x_ext, (t0, h_img, w_img, block_rows))``.
    """
    x = as_image(x_u8)
    h_img, w_img = x.shape
    t0, hp, wp, block_rows, stride = oframe_geometry(
        h_img, w_img, taps_r, taps_c, block_rows=block_rows)
    center = taps_c // 2
    left = taps_c - 1 - center
    interior = wp // LANE - 2
    # The logical columns [-left, interior·stride + center), zero outside
    # the image, cut into overlapping 128-column tiles.
    xp = F.pad(x, (left, interior * stride + center - w_img,
                   t0, hp - t0 - h_img))
    tiles = xp.unfold(1, LANE, stride)
    return (F.pad(tiles, (0, 0, 1, 1)).reshape(hp, wp),
            (t0, h_img, w_img, block_rows))


def crop_frame_overlap(out_frame: torch.Tensor, taps_c: int,
                       core: tuple[int, int, int]) -> torch.Tensor:
    """The (h_img, w_img) image of an overlapped frame: each interior
    tile's lanes ``[left, left + stride)``."""
    t0, h_img, w_img = core
    center = taps_c // 2
    left = taps_c - 1 - center
    stride = LANE - (taps_c - 1)
    w_tiles = out_frame.shape[1] // LANE
    y = out_frame[t0 : t0 + h_img].reshape(h_img, w_tiles, LANE)
    y = y[:, 1 : w_tiles - 1, left : left + stride]
    return y.reshape(h_img, (w_tiles - 2) * stride)[:, :w_img]


# ---------------------------------------------------------------------------
# The prepared filter
# ---------------------------------------------------------------------------


class FixedFir2d(nn.Module):
    """A quantized (Lr, Lc) filter prepared for kernels E, F and G, on one
    device.

    Buffers: ``h_fixed`` (int32 taps); ``a_prev`` / ``a_cur`` / ``a_next``
    (the tri-tile int8 band planes of K6 and K7, which the plain versions
    multiply by); ``digits`` (``(P, Lc)`` int8, each plane's digit row) and
    ``plane_table`` (``(P, 2)`` int32: tap row, exponent), which kernels E
    and F read; ``bias`` (int32) and ``needs_wrap`` (bool), from the whole
    filter; ``a_bf16`` (K8's ``(R, 128, 128)`` bf16 bands), and
    ``bf16_rows`` (the same values as ``(R, Lc)`` f32) with ``bf16_table``
    (their tap rows), which kernel G reads.  The plans, exponents and launch
    constants are Python values too, so a launch never reads the device.
    """

    def __init__(self, h_fixed: np.ndarray, qformat: QFormat,
                 device: torch.device | str = "cpu"):
        super().__init__()
        h_fixed = np.asarray(h_fixed, dtype=np.int64)
        if h_fixed.ndim != 2:
            raise ValueError(f"2-D FIR expects a 2-D kernel, got {h_fixed.shape}")
        taps_r, taps_c = h_fixed.shape
        planes = tap_row_planes(h_fixed)
        a_prev, a_cur, a_next, plan, left, center = build_tile_band_planes_2d(
            h_fixed)
        a_bf16, plan2 = build_bf16_band_planes_2d(h_fixed)
        bias, needs_wrap = band_bias(h_fixed, qformat)
        bf16_kr = [taps_r - 1 - rs for rs, _ in plan2]
        self.qformat = qformat
        self.taps = (taps_r, taps_c)
        self.left, self.center = left, center
        self.plan = plan
        self.plan2 = plan2
        self.plane_rows = tuple(kr for kr, _, _ in planes)
        self.exponents = tuple(exp for _, exp, _ in planes)
        self.bias_value = bias
        self.wrap = needs_wrap

        def buf(name: str, value) -> None:
            self.register_buffer(name, torch.as_tensor(value, device=device))

        buf("h_fixed", h_fixed.astype(np.int32))
        buf("a_prev", a_prev)
        buf("a_cur", a_cur)
        buf("a_next", a_next)
        buf("digits", np.ascontiguousarray(
            np.stack([d for _, _, d in planes]) if planes
            else np.zeros((1, taps_c), np.int8)))
        buf("plane_table", np.asarray(
            [[kr, exp] for kr, exp, _ in planes] or [[0, 0]], np.int32))
        buf("bias", np.asarray(bias, dtype=np.int32))
        buf("needs_wrap", np.asarray(needs_wrap))
        buf("a_bf16", a_bf16)
        buf("bf16_rows", _bf16_values(
            h_fixed[bf16_kr] if bf16_kr else np.zeros((1, taps_c), np.int64)
        ).to(torch.float32))
        buf("bf16_table", np.asarray(bf16_kr or [0], np.int32))

    @classmethod
    def from_numpy(cls, h, qformat: QFormat = QFormat(),
                   device: torch.device | str = "cpu",
                   digit_mode: str = "exact") -> "FixedFir2d":
        """Quantize real (Lr, Lc) taps ``h`` (rint, clip, digit mode) and
        prepare them."""
        return cls(quantize_2d(h, qformat, digit_mode), qformat, device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _tap_row_sources(x_ext: torch.Tensor, t0: int) -> torch.Tensor:
    """The frame with the TPU kernel's clamped row halos around it.

    K6-K8 read the ``t0`` rows before and after each row block as two
    operands whose block index is clamped at the frame's edges, so frame
    row ``q < 0`` reads row ``q + t0`` and ``q >= Hp`` reads ``q - t0``
    (only pad rows, which the row mask zeroes, see them in a frame from
    :func:`pad_frame`).  Row ``q`` of the frame is row ``q + t0`` here.
    """
    return torch.cat([x_ext[:t0], x_ext, x_ext[x_ext.shape[0] - t0:]])


def _source_rows(rows: torch.Tensor, kr: int, taps_r: int, t0: int,
                 hp: int) -> torch.Tensor:
    """Rows ``R + Lr//2 - kr`` of the frame, ``R`` over the frame: what tap
    row ``kr`` reads for every output row (``fir2d_mxu.py:445-449``)."""
    start = t0 + taps_r // 2 - kr
    return rows[start : start + hp]


def _rebias(x: torch.Tensor) -> torch.Tensor:
    # x ^ 0x80 as int8 is x - 128.  Band products are taken in float64,
    # where every sum of up to 384 int8 × int8 products (< 2^23) is exact,
    # so the matmul also runs on a GPU; they are int64 after it.
    return (x ^ 0x80).view(torch.int8).to(torch.float64)


def _row_mask(hp: int, t0: int, core_h: int, device) -> torch.Tensor:
    rows = torch.arange(hp, device=device)[:, None, None]
    return (rows >= t0) & (rows < t0 + core_h)


def _frame_of_tiles(tiles: torch.Tensor, wp: int) -> torch.Tensor:
    """(Hp, T, 128) interior tiles → the (Hp, Wp) frame, pad tiles zero."""
    return F.pad(tiles, (0, 0, 1, 1)).reshape(tiles.shape[0], wp)


def fir2d_frame_plain(x_ext: torch.Tensor, fir: FixedFir2d,
                      core: tuple[int, int, int]) -> torch.Tensor:
    """Kernel E's plain version: K6's tri-tile band formulation.

    Per plane, each interior tile of the row-shifted rebiased frame times
    ``a_cur`` plus its previous tile's last ``left`` columns times
    ``a_prev`` plus its next tile's first ``center`` columns times
    ``a_next``, shifted by the plane's exponent and summed mod 2^32 onto the
    bias; the epilogue; pad rows and the spill columns past ``core_w`` of a
    partial last tile zeroed (``fir2d_mxu.py:206-266``).  Runs on the
    device of its inputs.
    """
    hp, wp = x_ext.shape
    t0, core_h, core_w = core
    taps_r, _ = fir.taps
    left, center = fir.left, fir.center
    tiles = wp // LANE - 2
    span = tiles * LANE
    rows = _rebias(_tap_row_sources(x_ext, t0))
    acc = torch.full((hp, tiles, LANE), fir.bias_value & MASK32,
                     dtype=torch.int64, device=x_ext.device)
    for p, (kr, exp) in enumerate(zip(fir.plane_rows, fir.exponents)):
        if exp >= 32:  # nothing is left of it mod 2^32
            continue
        xs = _source_rows(rows, kr, taps_r, t0, hp)
        prod = xs[:, LANE : LANE + span].reshape(hp, tiles, LANE) @ \
            fir.a_cur[p].to(torch.float64)
        if left:
            prod += xs[:, LANE - left : LANE - left + span].reshape(
                hp, tiles, LANE)[..., :left] @ fir.a_prev[p].to(torch.float64)
        if center:
            prod += xs[:, 2 * LANE : 2 * LANE + span].reshape(
                hp, tiles, LANE)[..., :center] @ fir.a_next[p].to(torch.float64)
        acc = (acc + (prod.to(torch.int64) << exp)) & MASK32
    out = plain_epilogue(acc, fir.qformat, fir.wrap)
    tile = torch.arange(1, tiles + 1, device=x_ext.device)[:, None]
    lane = torch.arange(LANE, device=x_ext.device)[None, :]
    limit = LANE + core_w - tile * LANE
    keep_col = (limit <= 0) | (limit >= LANE) | (lane < limit)
    keep = _row_mask(hp, t0, core_h, x_ext.device) & keep_col
    return _frame_of_tiles(torch.where(keep, out, 0).to(torch.uint8), wp)


def _patch_boundaries(raw: torch.Tensor, left: int, center: int,
                      stride: int) -> torch.Tensor:
    """K7's boundary patch (``fir2d_mxu.py:716-726``) on (Hp, T, 128)
    accumulators: lanes ``i < left`` of tile ``c`` take lane ``i + stride``
    of tile ``c - 1``, lanes ``i >= 128 - center`` lane ``i - stride`` of
    tile ``c + 1``; beyond the first and last interior tile the neighbour's
    accumulator is zero."""
    padded = F.pad(raw, (0, 0, 1, 1))
    out = raw.clone()
    tiles = raw.shape[1]
    if left:
        out[..., :left] = padded[:, :tiles, stride : stride + left]
    if center:
        out[..., LANE - center :] = padded[:, 2:, LANE - center - stride :
                                           LANE - stride]
    return out


def _oframe_col_mask(tiles: int, left: int, stride: int, core_w: int,
                     device) -> torch.Tensor:
    """Lane ``i`` of interior tile ``c`` is image column
    ``(c-1)·stride - left + i``; keep it where that lies in the image."""
    tile = torch.arange(tiles, device=device)[:, None]
    col = tile * stride - left + torch.arange(LANE, device=device)[None, :]
    return (col >= 0) & (col < core_w)


def _check_overlap(taps_c: int, hint: str = "") -> int:
    """The overlapped frame's stride, or the JAX package's refusal."""
    if not 0 < taps_c - 1 <= OFRAME_MAX_OVERLAP:
        raise ValueError(
            f"overlapped frame needs 1 < taps_c <= {OFRAME_MAX_OVERLAP + 1}, "
            f"got {taps_c}{hint}.")
    return LANE - (taps_c - 1)


def fir2d_oframe_plain(x_ext: torch.Tensor, fir: FixedFir2d,
                       core: tuple[int, int, int]) -> torch.Tensor:
    """Kernel F's plain version: K7's one aligned band per plane.

    Per plane, every interior tile of the row-shifted rebiased overlapped
    frame times ``a_cur``, shifted and summed mod 2^32 onto the bias: lanes
    ``[left, 128 - center)`` are exact, the boundary lanes partial.  Then
    the boundary patch from the neighbours' accumulators, the epilogue, and
    every lane outside the image rows and columns zeroed
    (``fir2d_mxu.py:571-742``).  Runs on the device of its inputs.
    """
    hp, wp = x_ext.shape
    t0, core_h, core_w = core
    taps_r, taps_c = fir.taps
    stride = _check_overlap(taps_c)
    tiles = wp // LANE - 2
    rows = _rebias(_tap_row_sources(x_ext, t0))
    raw = torch.full((hp, tiles, LANE), fir.bias_value & MASK32,
                     dtype=torch.int64, device=x_ext.device)
    for p, (kr, exp) in enumerate(zip(fir.plane_rows, fir.exponents)):
        if exp >= 32:
            continue
        xs = _source_rows(rows, kr, taps_r, t0, hp)[:, LANE : wp - LANE]
        prod = xs.reshape(hp, tiles, LANE) @ fir.a_cur[p].to(torch.float64)
        raw = (raw + (prod.to(torch.int64) << exp)) & MASK32
    out = plain_epilogue(_patch_boundaries(raw, fir.left, fir.center, stride),
                         fir.qformat, fir.wrap)
    keep = (_row_mask(hp, t0, core_h, x_ext.device)
            & _oframe_col_mask(tiles, fir.left, stride, core_w, x_ext.device))
    return _frame_of_tiles(torch.where(keep, out, 0).to(torch.uint8), wp)


def fir2d_bf16_plain(x_ext: torch.Tensor, fir: FixedFir2d,
                     core: tuple[int, int, int]) -> torch.Tensor:
    """Kernel G's plain version: K8's one bf16 band per tap row.

    The samples as f32 (no rebias), per tap row every interior tile times
    that row's band in f32, the rows summed in order; the boundary patch,
    ``floor(acc · 2^-fb + 0.5)`` clipped to [0, 255], and the same masks as
    K7 (``fir2d_mxu.py:1000-1083``).  Runs on the device of its inputs; on a
    GPU the caller keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32
    = False``), or the products lose bits.
    """
    hp, wp = x_ext.shape
    t0, core_h, core_w = core
    taps_r, taps_c = fir.taps
    stride = _check_overlap(taps_c)
    tiles = wp // LANE - 2
    rows = _tap_row_sources(x_ext, t0).to(torch.float32)
    acc = torch.zeros((hp, tiles, LANE), dtype=torch.float32,
                      device=x_ext.device)
    for row_shift, p in fir.plan2:
        xs = _source_rows(rows, taps_r - 1 - row_shift, taps_r, t0,
                          hp)[:, LANE : wp - LANE]
        acc = acc + xs.reshape(hp, tiles, LANE) @ fir.a_bf16[p].to(
            torch.float32)
    acc = _patch_boundaries(acc, fir.left, fir.center, stride)
    out = torch.floor(acc * 2.0 ** -fir.qformat.frac_bits + 0.5).clamp_(0, 255)
    keep = (_row_mask(hp, t0, core_h, x_ext.device)
            & _oframe_col_mask(tiles, fir.left, stride, core_w, x_ext.device))
    return _frame_of_tiles(torch.where(keep, out, 0).to(torch.uint8), wp)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_frame(x_ext: torch.Tensor, fir: FixedFir2d,
                 core: tuple[int, int, int], out: torch.Tensor | None) -> None:
    """Raise unless ``x_ext`` is a frame the kernels take and ``out`` a
    separate buffer of its shape."""
    _build.check_rows_u8(x_ext)
    hp, wp = x_ext.shape
    if wp % LANE or wp < 2 * LANE:
        raise ValueError(f"frame width {wp} is not a multiple of {LANE} "
                         "with two pad tiles; build frames with pad_frame()")
    t0, core_h, core_w = (int(v) for v in core)
    taps_r = fir.taps[0]
    if t0 < max(taps_r - 1, 1) or t0 > hp or core_h < 0 or core_w < 0:
        raise ValueError(f"core {tuple(core)} does not fit a frame of "
                         f"{hp} rows for {taps_r} tap rows")
    if fir.a_cur.device != x_ext.device:
        raise ValueError(f"filter buffers on {fir.a_cur.device}, frame on "
                         f"{x_ext.device}")
    if out is None:
        return
    _build.check_rows_u8(out)
    if out.shape != x_ext.shape or out.device != x_ext.device:
        raise ValueError(f"scratch {tuple(out.shape)} on {out.device} does "
                         f"not match the frame {tuple(x_ext.shape)} on "
                         f"{x_ext.device}")
    if not out.is_contiguous():
        raise ValueError("scratch must be contiguous")
    lo, hi = x_ext.data_ptr(), x_ext.data_ptr() + x_ext.numel()
    if out.numel() and out.data_ptr() < hi and lo < out.data_ptr() + out.numel():
        raise ValueError("scratch shares memory with the input frame: the "
                         "kernels read rows that other CTAs' output rows "
                         "would overwrite")


def _check_int_format(qformat: QFormat) -> None:
    require_int32_format(qformat)
    if not 1 <= qformat.frac_bits <= 31:
        raise ValueError(f"the 2-D kernels need 1 <= frac_bits <= 31, "
                         f"got {qformat.frac_bits}")


def _launch(entry: str, x_ext: torch.Tensor, fir: FixedFir2d,
            core: tuple[int, int, int], out: torch.Tensor | None,
            table: torch.Tensor, coeffs: torch.Tensor, count: int,
            *constants) -> torch.Tensor:
    _build.check_launchable(x_ext)
    y = torch.empty_like(x_ext) if out is None else out
    if x_ext.numel() == 0:
        return y
    hp, wp = x_ext.shape
    t0, core_h, core_w = (int(v) for v in core)
    lib = _build.load_library()
    with torch.cuda.device(x_ext.device):
        code = getattr(lib, entry)(
            x_ext.data_ptr(), y.data_ptr(), hp, wp, coeffs.data_ptr(),
            table.data_ptr(), count, *fir.taps, t0, core_h, core_w,
            *constants, _build.stream_of(x_ext))
    _build.check_launch(lib, code, entry)
    return y


def fir2d_frame(x_ext: torch.Tensor, fir: FixedFir2d,
                core: tuple[int, int, int], *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel E over a plain frame on a CUDA tensor; :func:`fir2d_frame_plain`
    on a CPU tensor.  ``out`` receives the frame (a new one when None).

    Kernel E multiplies each plane by one band over the columns every lane
    reads (the tile and its neighbours' ``left`` and ``center`` columns) on
    the int8 tensor cores; it reads ``digits`` and ``plane_table``.  Raises
    on a frame the kernels do not take, an ``out`` that is not a separate
    buffer of the frame's shape, ``acc_bits > 32``, a failed build or a
    failed launch.  Counts its launches in ``fir2d_frame.launches``.
    """
    _check_frame(x_ext, fir, core, out)
    _check_int_format(fir.qformat)
    if x_ext.device.type == "cpu":
        y = fir2d_frame_plain(x_ext, fir, core)
        return y if out is None else out.copy_(y)
    qf = fir.qformat
    y = _launch("wft_fir2d_frame", x_ext, fir, core, out, fir.plane_table,
                fir.digits, len(fir.exponents), fir.bias_value & MASK32,
                int(fir.wrap), qf.frac_bits, qf.acc_bits)
    fir2d_frame.launches += 1
    return y


fir2d_frame.launches = 0


def fir2d_oframe(x_ext: torch.Tensor, fir: FixedFir2d,
                 core: tuple[int, int, int], *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F over an overlapped frame on a CUDA tensor;
    :func:`fir2d_oframe_plain` on a CPU tensor.  As :func:`fir2d_frame`,
    with K7's aligned band of the tile's own columns and its boundary
    patch; ``1 < Lc <= 97``.  Counts its launches in
    ``fir2d_oframe.launches``."""
    _check_frame(x_ext, fir, core, out)
    _check_int_format(fir.qformat)
    _check_overlap(fir.taps[1])
    if x_ext.device.type == "cpu":
        y = fir2d_oframe_plain(x_ext, fir, core)
        return y if out is None else out.copy_(y)
    qf = fir.qformat
    y = _launch("wft_fir2d_oframe", x_ext, fir, core, out, fir.plane_table,
                fir.digits, len(fir.exponents), fir.bias_value & MASK32,
                int(fir.wrap), qf.frac_bits, qf.acc_bits)
    fir2d_oframe.launches += 1
    return y


fir2d_oframe.launches = 0


def fir2d_bf16(x_ext: torch.Tensor, fir: FixedFir2d,
               core: tuple[int, int, int], *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel G over an overlapped frame on a CUDA tensor;
    :func:`fir2d_bf16_plain` on a CPU tensor.  As :func:`fir2d_oframe`,
    without the int32 format limits: one band per tap row on the bf16
    tensor cores with f32 sums, added in tap-row order; it reads
    ``bf16_rows`` and ``bf16_table``.  Counts its launches in
    ``fir2d_bf16.launches``."""
    _check_frame(x_ext, fir, core, out)
    _check_overlap(fir.taps[1])
    if x_ext.device.type == "cpu":
        y = fir2d_bf16_plain(x_ext, fir, core)
        return y if out is None else out.copy_(y)
    y = _launch("wft_fir2d_bf16", x_ext, fir, core, out, fir.bf16_table,
                fir.bf16_rows, len(fir.plan2), fir.qformat.frac_bits)
    fir2d_bf16.launches += 1
    return y


fir2d_bf16.launches = 0


# ---------------------------------------------------------------------------
# The frame functions, under the JAX package's names
# ---------------------------------------------------------------------------


def _check_block_rows(block_rows: int | None, default: int, t0: int,
                      hp: int, wp: int, stride: int | None = None,
                      core_w: int = 0) -> None:
    """The TPU kernel's row-block checks (``fir2d_mxu.py:451-458``,
    ``:904-915``): the CUDA kernels take any row count, but a frame the
    JAX package refuses is refused here too."""
    block_rows = default if block_rows is None else block_rows
    block_rows = min(_round_up(block_rows, t0), hp)
    if stride is None:
        if hp % block_rows or wp % LANE or block_rows % t0:
            raise ValueError(
                f"Frame ({hp}, {wp}) incompatible with block_rows="
                f"{block_rows}, t0={t0}; build frames with "
                "pad_frame()/frame_geometry().")
    elif (hp % block_rows or wp % LANE or block_rows % t0
          or (wp // LANE - 2) * stride < core_w):
        raise ValueError(
            f"Overlapped frame ({hp}, {wp}) incompatible with "
            f"block_rows={block_rows}, t0={t0}, stride={stride}; build "
            "frames with pad_frame_overlap()/oframe_geometry().")


def fir2d_fixed_frame(
    x_ext: torch.Tensor,
    h,
    qformat: QFormat = QFormat(),
    *,
    core: tuple[int, int, int],
    block_rows: int | None = None,
    scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """Shape-preserving fixed 2-D FIR over a plain frame (``:415``).

    ``x_ext`` is an (Hp, Wp) frame from :func:`pad_frame` (a host array
    goes to the card, :func:`as_image`), ``core = (t0, h_img, w_img)``.
    The output is a frame again, so chained applies are repeated same-mode
    filtering without re-padding.  ``scratch``, a separate frame of the
    same shape, receives the output.
    """
    x_ext = as_image(x_ext)
    fir = FixedFir2d.from_numpy(h, qformat, x_ext.device)
    require_int32_format(qformat)
    t0, core_h, _ = core
    hp, wp = x_ext.shape
    _check_block_rows(block_rows,
                      frame_geometry(core_h, wp - 2 * LANE, fir.taps[0])[3],
                      t0, hp, wp)
    return fir2d_frame(x_ext, fir, core, out=scratch)


def fir2d_fixed_frame_overlap(
    x_ext: torch.Tensor,
    h,
    qformat: QFormat = QFormat(),
    *,
    core: tuple[int, int, int],
    block_rows: int | None = None,
    scratch: torch.Tensor | None = None,
    digit_mode: str = "exact",
) -> torch.Tensor:
    """Shape-preserving fixed 2-D FIR over an overlapped frame (``:864``).

    The contract of :func:`fir2d_fixed_frame` on the
    :func:`pad_frame_overlap` layout, for ``1 < Lc <= 97`` (a host array
    goes to the card, :func:`as_image`).  ``digit_mode
    ="top"`` rounds each tap row to its top digit (:func:`_top_digit_round`).
    """
    x_ext = as_image(x_ext)
    fir = FixedFir2d.from_numpy(h, qformat, x_ext.device, digit_mode)
    require_int32_format(qformat)
    taps_r, taps_c = fir.taps
    stride = _check_overlap(taps_c, "; use fir2d_fixed_frame")
    t0, core_h, core_w = core
    hp, wp = x_ext.shape
    _check_block_rows(block_rows,
                      oframe_geometry(core_h, core_w, taps_r, taps_c)[3],
                      t0, hp, wp, stride, core_w)
    return fir2d_oframe(x_ext, fir, core, out=scratch)


def fir2d_frame_overlap_bf16(
    x_ext: torch.Tensor,
    h,
    qformat: QFormat = QFormat(),
    *,
    core: tuple[int, int, int],
    block_rows: int | None = None,
    scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """The bf16 2-D FIR over an overlapped frame (``:1137``): bit-exact where
    :func:`bf16_2d_exact` holds, SNR-gated otherwise; never dispatched
    automatically.  A host array goes to the card (:func:`as_image`)."""
    x_ext = as_image(x_ext)
    fir = FixedFir2d.from_numpy(h, qformat, x_ext.device)
    taps_r, taps_c = fir.taps
    stride = _check_overlap(taps_c)
    t0, core_h, core_w = core
    hp, wp = x_ext.shape
    _check_block_rows(block_rows,
                      oframe_geometry(core_h, core_w, taps_r, taps_c)[3],
                      t0, hp, wp, stride, core_w)
    return fir2d_bf16(x_ext, fir, core, out=scratch)


def fir2d_fixed_mxu(
    x_u8: torch.Tensor,
    h,
    qformat: QFormat = QFormat(),
    *,
    block_rows: int | None = None,
    layout: str = "auto",
) -> torch.Tensor:
    """Bit-exact fixed 2-D FIR over an (H, W) image (``:1203``): embed it in
    a frame, filter, crop, on the image's device (a host array goes to the
    card, :func:`as_image`).  ``layout`` is ``"overlap"`` (``Lc <= 97``),
    ``"plain"`` (``Lc <= 257``) or ``"auto"`` (overlap where it fits)."""
    taps_r, taps_c = (int(d) for d in np.asarray(h).shape)
    if layout == "auto":
        layout = ("overlap" if 0 < taps_c - 1 <= OFRAME_MAX_OVERLAP
                  else "plain")
    if layout == "overlap":
        x_ext, (t0, h_img, w_img, block_rows) = pad_frame_overlap(
            x_u8, taps_r, taps_c, block_rows=block_rows)
        out = fir2d_fixed_frame_overlap(
            x_ext, h, qformat, core=(t0, h_img, w_img), block_rows=block_rows)
        return crop_frame_overlap(out, taps_c, (t0, h_img, w_img))
    x_ext, (t0, h_img, w_img, block_rows) = pad_frame(
        x_u8, taps_r, block_rows=block_rows)
    out = fir2d_fixed_frame(x_ext, h, qformat, core=(t0, h_img, w_img),
                            block_rows=block_rows)
    return out[t0 : t0 + h_img, LANE : LANE + w_img]
