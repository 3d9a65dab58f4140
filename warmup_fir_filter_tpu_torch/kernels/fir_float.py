"""Kernel H: the float32 same-mode FIR over (B, N) rows (ports K9).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_float_mxu.py``: the
ideal model contract (raw, unclamped f32, zero-padded same mode with
``center = L // 2`` and ``left = L - 1 - center``) over uint8 or f32 rows,
for up to 257 taps.  The TPU kernels (``:106``, ``:198``, ``:328``) are
blockings of one tri-tile band product; :func:`build_tile_band_planes_f32`
keeps that band encoding, which the plain version multiplies by.

:class:`FloatFir1d` holds the taps as a buffer.  :func:`fir_float`
launches ``csrc/fir_float.cu`` on a CUDA tensor and runs
:func:`fir_float_plain` on a CPU tensor.  :func:`fir1d_ideal_rows_band` is
the entry point with the JAX function's signature
(``fir1d_ideal_rows_mxu``, ``:559``, minus its TPU blocking knobs): above
257 taps it takes ``ops/fir1d.py::fir1d_ideal_rows_torch``, as the JAX
function takes its jnp path (``:587-590``).

``precision`` keeps the JAX names so callers carry over: ``"bf16x3"`` and
``"highest"`` both compute plain f32 FMAs on the card, which has native
f32, and meet the stricter JAX bound (>= 120 dB against the f64 golden).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir_band import LANE, MAX_TAPS
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_ideal_rows_torch

PRECISIONS = ("bf16x3", "highest")
#: Sample types the kernel reads; others are converted to f32 first.
SAMPLE_DTYPES = (torch.uint8, torch.float32)


def build_tile_band_planes_f32(
    h: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tri-tile float band planes ``(a_prev, a_cur, a_next)``.

    Same row mapping as the int kernel's
    ``fir_mxu.build_tile_band_planes`` (same-mode center alignment,
    side operands trimmed to their true band width), one f32 plane.
    """
    h = np.asarray(h, dtype=np.float32)
    num_taps = h.size
    if num_taps > MAX_TAPS:
        raise ValueError(
            f"MXU kernel supports up to {MAX_TAPS} taps, got {num_taps}."
        )
    center = num_taps // 2
    left = num_taps - 1 - center
    i_idx = np.arange(LANE)[None, :]

    def band(rows: int, offset: int) -> np.ndarray:
        j_idx = np.arange(max(rows, 1))[:, None]
        k = i_idx + center + offset - j_idx
        valid = (k >= 0) & (k < num_taps)
        a = np.zeros((max(rows, 1), LANE), np.float32)
        a[valid] = h[k[valid]]
        return a

    return band(left, left), band(LANE, 0), band(center, -LANE)


class FloatFir1d(nn.Module):
    """Float taps prepared for kernel H on one device.

    Buffers: ``taps`` (f32, what the kernel reads) and ``a_prev`` /
    ``a_cur`` / ``a_next`` (the tri-tile band planes of the same f32 taps,
    what the plain version multiplies by).
    """

    def __init__(self, h, device: torch.device | str = "cpu"):
        super().__init__()
        h32 = np.asarray(h, dtype=np.float64).astype(np.float32)
        a_prev, a_cur, a_next = build_tile_band_planes_f32(h32)
        self.num_taps = int(h32.size)
        for name, value in (("taps", h32), ("a_prev", a_prev),
                            ("a_cur", a_cur), ("a_next", a_next)):
            self.register_buffer(name, torch.as_tensor(value, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fir_float(x, self)


def fir_float_plain(x: torch.Tensor, fir: FloatFir1d) -> torch.Tensor:
    """The band formulation in float64 on ``x.device`` (kernel H's plain
    version): zero pad to whole 128-lane tiles, then per tile
    ``cur @ a_cur + prev @ a_prev + next @ a_next``.  Returns float64."""
    batch, n = x.shape
    center = fir.num_taps // 2
    left = fir.num_taps - 1 - center
    tiles = max(1, -(-n // LANE))
    n_pad = tiles * LANE
    # Left halo, then zeros up to one whole tile past the padded row.
    xe = F.pad(x.to(torch.float64), (left, n_pad + LANE - n))
    cur = xe[:, left : left + n_pad].reshape(batch, tiles, LANE)
    acc = cur @ fir.a_cur.to(device=x.device, dtype=torch.float64)
    if left:
        prev = xe[:, :n_pad].reshape(batch, tiles, LANE)[:, :, :left]
        acc = acc + prev @ fir.a_prev.to(device=x.device, dtype=torch.float64)
    if center:
        nxt = xe[:, left + LANE : left + LANE + n_pad].reshape(
            batch, tiles, LANE)[:, :, :center]
        acc = acc + nxt @ fir.a_next.to(device=x.device, dtype=torch.float64)
    return acc.reshape(batch, n_pad)[:, :n]


def fir_float(x: torch.Tensor, fir: FloatFir1d) -> torch.Tensor:
    """Kernel H on a CUDA tensor; :func:`fir_float_plain` (cast to f32) on
    a CPU tensor.

    ``x`` is (B, N) uint8 or f32.  Raises on anything else, a
    non-contiguous CUDA tensor, taps on another device, a failed build or
    a failed launch.  Counts its launches in ``fir_float.launches``.
    """
    _build.check_rows(x, SAMPLE_DTYPES)
    if x.device.type == "cpu":
        return fir_float_plain(x, fir).to(torch.float32)
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    _build.check_same_device(x, fir.taps, "filter taps")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.wft_fir_float(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
            fir.taps.data_ptr(), fir.num_taps, int(x.dtype == torch.uint8),
            _build.stream_of(x),
        )
    _build.check_launch(lib, code, "fir_float")
    fir_float.launches += 1
    return y


fir_float.launches = 0


def fir1d_ideal_rows_band(x: torch.Tensor, h, *,
                          precision: str = "bf16x3") -> torch.Tensor:
    """Float32 same-mode FIR over (B, N) rows on ``x.device``.

    Raw unclamped f32 (the ``fir_1d_ref.py:43-65`` contract); uint8 or
    float input.  Kernel H for up to 257 taps, the plain f32 shifted-MAC
    path beyond.
    """
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    h = np.asarray(h, dtype=np.float64)
    if h.size > MAX_TAPS:
        return fir1d_ideal_rows_torch(x, h)
    if x.dtype not in SAMPLE_DTYPES:
        x = x.to(torch.float32)
    return fir_float(x.contiguous(), FloatFir1d(h, x.device))


def fir1d_ideal_rows_mxu(x: torch.Tensor, h, *,
                         precision: str = "bf16x3") -> torch.Tensor:
    """The JAX ``fir_float_mxu.py::fir1d_ideal_rows_mxu`` entry (its TPU
    blocking knobs dropped): :func:`fir1d_ideal_rows_band`, kernel H."""
    return fir1d_ideal_rows_band(x, h, precision=precision)
