"""Kernel C: the windowed digit-plane FIR for up to 4,096 taps (ports K3).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_mxu.py:691-1012``.  The
coefficients keep the encoding of kernel A (signed base-256 digit planes
after the common power of two, a shift exponent per plane, rebias
``x ^ 0x80`` and the start value ``128 · Σh``), and each plane is trimmed
to its nonzero tap range ``[kmin_b, kmax_b]``, as
:func:`build_window_band_planes` (``fir_mxu.py:691``) trims its band rows.

What differs from the TPU kernel: positions outside a row read u8 0, which
rebiases to −128, exactly as in kernel A.  So the start value is the same
constant for every output, and neither K3's per-tile bias table
(``_window_bias_table``, ``:754``) nor its overlap-save segmentation of
over-wide rows (``_fir_window_segmented``, ``:965``) is needed: one kernel
takes any width.

:class:`FixedFirWindow` holds the filter as buffers and Python values.
:func:`fir_window` launches ``csrc/fir_window.cu`` on a CUDA tensor; on a
CPU tensor it runs :func:`fir_window_plain`, the windowed formulation in
int64 matmuls (one ``window @ band`` per trimmed plane), so the CPU tests
hold the encoding against the JAX kernel and not only the outputs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir_band import (
    LANE,
    band_bias,
    kept_digit_planes,
    plain_epilogue,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

#: ``fir_mxu.MAX_TAPS_WINDOWED``.
MAX_TAPS = 4096
#: Fields of a plane's row in the kernel's plane table
#: (``csrc/wft_window.cuh``): exponent, first quad, quads, first word.
PLANE_FIELDS = 4


def plane_tap_ranges(planes: np.ndarray) -> tuple[tuple[int, int], ...]:
    """``(kmin, kmax)`` of each digit plane's nonzero taps; ``(0, -1)``
    for a zero plane (only the all-zero filter keeps one)."""
    ranges = []
    for digit in planes:
        nz = np.flatnonzero(digit)
        ranges.append((int(nz[0]), int(nz[-1])) if nz.size else (0, -1))
    return tuple(ranges)


def window_band_planes_of(
    planes: np.ndarray, exponents: tuple[int, ...],
) -> tuple[np.ndarray, tuple[tuple[int, int, int, int], ...]]:
    """K3's stacked trimmed band operand of kept digit planes.

    Output tile ``p`` is ``X[:, p·128 - left : p·128 - left + L + 127] @ A``
    with ``A[j, i] = digit[i + L - 1 - j]``; plane ``b`` keeps rows
    ``j ∈ [L-1-kmax_b, L+127-kmin_b)``.  Returns ``(stacked, entries)``,
    each entry ``(exponent, j0, rows, offset)``, as ``fir_mxu.py:691-751``.
    """
    num_taps = planes.shape[1]
    i_idx = np.arange(LANE)[None, :]
    blocks, entries, offset = [], [], 0
    for digit, exp, (kmin, kmax) in zip(planes, exponents,
                                        plane_tap_ranges(planes)):
        if kmax < kmin:  # the all-zero filter's one zero plane
            blocks.append(np.zeros((1, LANE), np.int8))
            entries.append((exp, 0, 1, offset))
            offset += 1
            continue
        j0 = num_taps - 1 - kmax
        rows = kmax - kmin + LANE
        k = i_idx + (num_taps - 1) - (j0 + np.arange(rows)[:, None])
        valid = (k >= 0) & (k < num_taps)
        band = np.zeros((rows, LANE), np.int8)
        band[valid] = digit[k[valid]]
        blocks.append(band)
        entries.append((exp, j0, rows, offset))
        offset += rows
    return np.concatenate(blocks, axis=0), tuple(entries)


def build_window_band_planes(
    h_fixed: np.ndarray,
) -> tuple[np.ndarray, tuple[tuple[int, int, int, int], ...]]:
    """``fir_mxu.build_window_band_planes``: ``(stacked, entries)``."""
    h_fixed = np.asarray(h_fixed, dtype=np.int64)
    if h_fixed.size > MAX_TAPS:
        raise ValueError(f"windowed-band kernel supports up to {MAX_TAPS} "
                         f"taps, got {h_fixed.size}.")
    return window_band_planes_of(*kept_digit_planes(h_fixed))


def kernel_digit_words(
    planes: np.ndarray, exponents: tuple[int, ...],
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Kernel C's operands: reversed digits packed in quads, and the table.

    With ``rd_b[q] = digit_b[L-1-q]``, plane ``b`` reads the quads
    ``a ∈ [q0 // 4, ceil((q1+1) / 4))`` of its trimmed range
    ``q ∈ [L-1-kmax_b, L-1-kmin_b]``; word ``a`` holds ``rd_b[4a .. 4a+3]``
    (zero past the filter).  Returns the int8 words (a multiple of 4
    bytes, at least one word) and the flat table of
    ``(exponent, first quad, quads, first word)`` per plane.
    """
    num_taps = planes.shape[1]
    words, table, offset = [], [], 0
    for digit, exp, (kmin, kmax) in zip(planes, exponents,
                                        plane_tap_ranges(planes)):
        if kmax < kmin:
            table += [exp, 0, 0, offset]
            continue
        a0 = (num_taps - 1 - kmax) // 4
        a1 = -(-(num_taps - kmin) // 4)
        reversed_digits = np.zeros(4 * a1 + num_taps, np.int8)
        reversed_digits[:num_taps] = digit[::-1]
        words.append(reversed_digits[4 * a0 : 4 * a1])
        table += [exp, a0, a1 - a0, offset]
        offset += a1 - a0
    packed = np.concatenate(words) if words else np.zeros(0, np.int8)
    if packed.size == 0:
        packed = np.zeros(4, np.int8)
    return packed, tuple(table)


class FixedFirWindow(nn.Module):
    """A quantized filter prepared for the windowed kernel, on one device.

    Buffers: ``h_fixed`` (int32 taps), ``digits`` (kept digit planes,
    ``(D_kept, L)`` int8), ``kernel_digits`` (the planes' reversed,
    trimmed digits packed in quads for kernel C), ``bias`` (int32) and
    ``needs_wrap`` (bool).  Python values: ``exponents``, ``tap_ranges``
    (``(kmin_b, kmax_b)`` per plane), ``plane_table`` (the kernel's
    per-plane table) and the launch constants, so a launch never reads the
    device.
    """

    def __init__(self, h_fixed: np.ndarray, qformat: QFormat,
                 device: torch.device | str = "cpu"):
        super().__init__()
        h_fixed = np.asarray(h_fixed, dtype=np.int64)
        if not 1 <= h_fixed.size <= MAX_TAPS:
            raise ValueError(f"windowed-band kernel supports up to {MAX_TAPS} "
                             f"taps, got {h_fixed.size}.")
        digits, exponents = kept_digit_planes(h_fixed)
        words, table = kernel_digit_words(digits, exponents)
        bias, needs_wrap = band_bias(h_fixed, qformat)
        self.qformat = qformat
        self.num_taps = int(h_fixed.size)
        self.exponents = exponents
        self.tap_ranges = plane_tap_ranges(digits)
        self.plane_table = table
        self.bias_value = bias
        self.wrap = needs_wrap

        def buf(name: str, value: np.ndarray) -> None:
            self.register_buffer(name, torch.as_tensor(value, device=device))

        buf("h_fixed", h_fixed.astype(np.int32))
        buf("digits", np.ascontiguousarray(digits))
        buf("kernel_digits", words)
        buf("bias", np.asarray(bias, dtype=np.int32))
        buf("needs_wrap", np.asarray(needs_wrap))

    @classmethod
    def from_numpy(cls, h, qformat: QFormat = QFormat(),
                   device: torch.device | str = "cpu") -> "FixedFirWindow":
        """Quantize real taps ``h`` (rint, clip) and prepare them."""
        if not qformat.tpu_native:
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 is not representable in "
                "the int32 windowed kernel; use models.golden."
            )
        return cls(qformat.quantize_coeffs(h).astype(np.int64), qformat,
                   device)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return fir_window(x_u8, self)


def fir_window_plain(x_u8: torch.Tensor, fir: FixedFirWindow) -> torch.Tensor:
    """The windowed formulation in torch int64 on the CPU (kernel C's plain
    version).

    Rebias ``x ^ 0x80`` as int8 over the row zero-padded by ``left`` in
    front and up to whole 128-lane tiles plus ``center`` behind (pads
    rebias to −128), then per trimmed plane one ``window @ band`` over
    every tile, shifted by the plane's exponent and summed mod 2^32 onto
    the bias, then the kernels' epilogue.
    """
    batch, n = x_u8.shape
    center = fir.num_taps // 2
    left = fir.num_taps - 1 - center
    tiles = max(1, -(-n // LANE))
    n_pad = tiles * LANE
    xe = F.pad(x_u8, (left, n_pad - n + center))
    xr = (xe ^ 0x80).view(torch.int8).to(torch.int64)
    bands, entries = window_band_planes_of(fir.digits.cpu().numpy(),
                                           fir.exponents)
    bands = torch.from_numpy(bands).to(torch.int64)
    acc = torch.full((batch, tiles, LANE), fir.bias_value & 0xFFFFFFFF,
                     dtype=torch.int64)
    for exp, j0, rows, off in entries:
        if exp >= 32:  # nothing is left of it mod 2^32
            continue
        window = xr[:, j0 : j0 + (tiles - 1) * LANE + rows].unfold(1, rows, LANE)
        prod = window @ bands[off : off + rows]
        acc = (acc + (prod << exp)) & 0xFFFFFFFF
    out = plain_epilogue(acc, fir.qformat, fir.wrap)
    return out.reshape(batch, n_pad)[:, :n].contiguous()


def fir_window(x_u8: torch.Tensor, fir: FixedFirWindow) -> torch.Tensor:
    """Kernel C on a CUDA tensor; :func:`fir_window_plain` on a CPU tensor.

    Raises on anything else: a tensor that is not 2-D uint8, a
    non-contiguous CUDA tensor, filter buffers on another device, a failed
    build or a failed launch.  Counts its launches in
    ``fir_window.launches``.
    """
    _build.check_rows_u8(x_u8)
    if x_u8.device.type == "cpu":
        return fir_window_plain(x_u8, fir)
    _build.check_launchable(x_u8)
    _build.check_same_device(x_u8, fir.kernel_digits, "filter buffers")
    qf = fir.qformat
    if not 1 <= qf.frac_bits <= 31:
        raise ValueError(f"windowed kernel needs 1 <= frac_bits <= 31, "
                         f"got {qf.frac_bits}")
    y = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return y
    lib = _build.load_library()
    table = (ctypes.c_int * len(fir.plane_table))(*fir.plane_table)
    with torch.cuda.device(x_u8.device):
        code = lib.wft_fir_window(
            x_u8.data_ptr(), y.data_ptr(), x_u8.shape[0], x_u8.shape[1],
            fir.kernel_digits.data_ptr(), fir.kernel_digits.numel() // 4,
            len(fir.exponents), fir.num_taps,
            ctypes.cast(table, ctypes.c_void_p),
            fir.bias_value & 0xFFFFFFFF, int(fir.wrap), qf.frac_bits,
            qf.acc_bits, _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "fir_window")
    fir_window.launches += 1
    return y


fir_window.launches = 0


def fir1d_fixed_rows_mxu_window(x_u8: torch.Tensor, h,
                                qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, L ≤ 4,096, on
    ``x_u8.device`` (a host array goes to the card, ``_build.as_rows``):
    the JAX ``fir_mxu.py::fir1d_fixed_rows_mxu_window`` entry (its TPU
    blocking knobs dropped) over kernel C."""
    x_u8 = _build.as_rows(x_u8)
    return fir_window(x_u8, FixedFirWindow.from_numpy(h, qformat, x_u8.device))
