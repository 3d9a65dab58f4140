"""Kernel A: the fixed band FIR for up to 257 taps (ports K1 and K2).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_mxu.py`` (``:97-130``,
``:183-246``, ``:248-681``).  The coefficient encoding is carried over
exactly, because it is what the kernel's int8 tensor cores consume:

- the quantized taps are split into signed base-256 digit planes after the
  common power of two is factored out (:func:`signed_base256_digits`,
  :func:`factor_pow2`); each kept plane has a bit-shift exponent;
- :func:`build_tile_band_planes` builds the tri-tile band matrices
  ``a_prev`` / ``a_cur`` / ``a_next`` of each plane;
- samples are rebiased to ``x ^ 0x80`` as int8, and the constant
  ``128 · Σh`` (plus the rounding bias on the no-wrap path) starts the
  accumulator (:func:`band_bias`).

:class:`FixedFir1d` holds all of it, with only the digit planes uploaded to
a device the kernel runs on.  :func:`fir_band` launches
``csrc/fir_band.cu`` on a CUDA tensor (up to :data:`SHORT_MAX_TAPS` taps
its short-tap route,
which multiplies the raw samples by ``h_fixed`` and gives the same
accumulator mod 2^32; beyond, each digit plane's band product on int8
tensor cores); on a CPU tensor it runs
:func:`fir_band_plain`, the band formulation itself in int64 matmuls, so
the CPU tests hold the encoding against the JAX kernel and not only the
outputs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fir1d import fixed_epilogue_i32
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.utils.profiling import span

LANE = 128
#: Tri-tile band limit: output tile p reads input tiles p-1, p, p+1 only.
MAX_TAPS = 2 * LANE + 1
#: Signed base-256 digits of an int32 coefficient.
MAX_PLANES = 5
#: Taps of the kernel's short-tap route (``wft_band.cuh``'s
#: ``kBandShortMaxTaps``); the digit planes take longer filters.
SHORT_MAX_TAPS = 6


def signed_base256_digits(values: np.ndarray) -> np.ndarray:
    """Exact signed-digit base-256 decomposition (``fir_mxu.py:97``).

    Returns (D, L) int8 with ``values == Σ_b 256^b · digits[b]``; D is the
    minimal digit count covering all entries.
    """
    rem = np.asarray(values, dtype=np.int64).copy()
    digits = []
    while np.any(rem != 0):
        d = ((rem + 128) & 255) - 128
        digits.append(d.astype(np.int8))
        rem = (rem - d) >> 8
    if not digits:
        digits.append(np.zeros(rem.shape, np.int8))
    return np.stack(digits)


def factor_pow2(values: np.ndarray) -> tuple[np.ndarray, int]:
    """Factor the common power of two: ``values == reduced << s``
    (``fir_mxu.py:114``).  Fewer digit planes, same result mod 2^32."""
    values = np.asarray(values, dtype=np.int64)
    nonzero = values[values != 0]
    if nonzero.size == 0:
        return values, 0
    s = min(int(v & -v).bit_length() - 1 for v in np.abs(nonzero))
    return values >> s, s


def kept_digit_planes(h_fixed: np.ndarray) -> tuple[np.ndarray, tuple[int, ...]]:
    """The non-zero digit planes ``(D_kept, L)`` int8 and their exponents.

    Exponent of plane ``b`` is ``8·b + s`` with ``s`` from
    :func:`factor_pow2`.  An all-zero filter keeps one zero plane with
    exponent 0, as ``fir_mxu.py:235-239`` does.
    """
    reduced, pow2 = factor_pow2(h_fixed)
    digits = signed_base256_digits(reduced)
    kept = [b for b in range(digits.shape[0]) if np.any(digits[b])]
    if not kept:
        return digits[:1] * 0, (0,)
    return digits[kept], tuple(8 * b + pow2 for b in kept)


def build_tile_band_planes(
    h_fixed: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, ...]]:
    """Tri-tile stacked digit band planes, side-trimmed (``fir_mxu.py:183``).

    For each kept plane ``b`` (``center = L // 2``, ``left = L-1-center``):
    ``a_cur[b][j, i] = digit_b[i + center - j]`` (128 rows),
    ``a_prev[b][j, i] = digit_b[i + center + left - j]`` (``left`` rows,
    the previous tile's last columns) and
    ``a_next[b][j, i] = digit_b[i + center - 128 - j]`` (``center`` rows,
    the next tile's first columns), zero outside ``0 ≤ k < L``.  A side
    with no rows keeps one zero row.
    """
    planes, exponents = kept_digit_planes(h_fixed)
    return (*band_planes_of(planes), exponents)


def band_planes_of(
    planes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``a_prev`` / ``a_cur`` / ``a_next`` of kept digit planes ``(D, L)``."""
    num_taps = planes.shape[1]
    if num_taps > MAX_TAPS:
        raise ValueError(
            f"band kernel supports up to {MAX_TAPS} taps, got {num_taps}."
        )
    center = num_taps // 2
    left = num_taps - 1 - center
    i_idx = np.arange(LANE)[None, :]

    def band(rows: int, offset: int, digit: np.ndarray) -> np.ndarray:
        j_idx = np.arange(max(rows, 1))[:, None]
        k = i_idx + center + offset - j_idx
        valid = (k >= 0) & (k < num_taps)
        a = np.zeros((max(rows, 1), LANE), np.int8)
        a[valid] = digit[k[valid]]
        return a

    return (
        np.stack([band(left, left, d) for d in planes]),
        np.stack([band(LANE, 0, d) for d in planes]),
        np.stack([band(center, -LANE, d) for d in planes]),
    )


def band_bias(h_fixed: np.ndarray, qformat: QFormat) -> tuple[int, bool]:
    """Accumulator start value (two's-complement int32) and ``needs_wrap``.

    As ``fir_mxu.py:583-597``: the wrap emulation is needed only when
    ``255·Σ|h| + 2^(fb-1)`` can reach ``2^(acc_bits-1)``; otherwise the
    rounding bias folds into the constant ``128·Σh`` and the epilogue is
    one arithmetic shift.
    """
    h_fixed = np.asarray(h_fixed, dtype=np.int64)
    worst_acc = 255 * int(np.abs(h_fixed).sum()) + (1 << (qformat.frac_bits - 1))
    needs_wrap = worst_acc >= (1 << (qformat.acc_bits - 1))
    bias = 128 * int(h_fixed.sum())
    if not needs_wrap:
        bias += 1 << (qformat.frac_bits - 1)
    bias &= 0xFFFFFFFF
    if bias >= 1 << 31:
        bias -= 1 << 32
    return bias, bool(needs_wrap)


#: The buffers that only the plain version and the tests read: kernel A's
#: launch takes ``digits`` alone, and the rest as host values.
HOST_BUFFERS = ("h_fixed", "a_prev", "a_cur", "a_next", "bias", "needs_wrap")


class FixedFir1d(nn.Module):
    """A quantized filter prepared for the band kernel, on one device.

    ``digits`` (kept digit planes, ``(D_kept, L)`` int8) is a buffer on the
    filter's device: the one tensor kernel A's launch reads there.  The
    exponents and the scalar launch constants are kept as Python values, so
    a launch never reads the device.  :data:`HOST_BUFFERS` (``h_fixed``,
    int32 taps; ``a_prev`` / ``a_cur`` / ``a_next``, tri-tile band planes;
    ``bias``, int32; ``needs_wrap``, bool) are buffers beside it on the CPU,
    where the plain version reads them every call; for any other device
    they stay on the host and are built once, at their first read.
    ``FixedFir1d.uploads`` counts the host-to-device tensors that
    preparations make: one a preparation off the CPU.
    """

    uploads = 0

    def __init__(self, h_fixed: np.ndarray, qformat: QFormat,
                 device: torch.device | str = "cpu"):
        super().__init__()
        h_fixed = np.asarray(h_fixed, dtype=np.int64)
        digits, exponents = kept_digit_planes(h_fixed)
        bias, needs_wrap = band_bias(h_fixed, qformat)
        self.qformat = qformat
        self.num_taps = int(h_fixed.size)
        self.exponents = exponents
        self.bias_value = bias
        self.wrap = needs_wrap
        self._h_fixed = h_fixed.astype(np.int32)
        self._digits = np.ascontiguousarray(digits)
        # The launch's host arrays, built once: the exponents and the int32
        # taps (kernel parameters of the short-tap route).
        self.exponents_c = (ctypes.c_int * len(exponents))(*exponents)
        self.taps_c = (ctypes.c_int32 * h_fixed.size)(
            *self._h_fixed.tolist())
        device = torch.device(device)
        self._host_at_first_read = device.type != "cpu"
        self.register_buffer("digits",
                             torch.as_tensor(self._digits, device=device))
        if self._host_at_first_read:
            FixedFir1d.uploads += 1
        else:
            for name, value in self._host_buffers().items():
                self.register_buffer(name, value)

    def _host_buffers(self) -> dict[str, torch.Tensor]:
        """:data:`HOST_BUFFERS` on the host, from the taps and the digits."""
        a_prev, a_cur, a_next = band_planes_of(self._digits)
        return {
            "h_fixed": torch.from_numpy(self._h_fixed),
            "a_prev": torch.from_numpy(a_prev),
            "a_cur": torch.from_numpy(a_cur),
            "a_next": torch.from_numpy(a_next),
            "bias": torch.tensor(self.bias_value, dtype=torch.int32),
            "needs_wrap": torch.tensor(self.wrap),
        }

    def __getattr__(self, name: str):
        # Reached only for a name that is not yet an attribute: off the CPU
        # the host buffers are built at their first read and kept.
        if name in HOST_BUFFERS and self.__dict__.get("_host_at_first_read"):
            host = self._host_buffers()
            self.__dict__.update(host)
            return host[name]
        return super().__getattr__(name)

    @classmethod
    def from_numpy(cls, h, qformat: QFormat = QFormat(),
                   device: torch.device | str = "cpu") -> "FixedFir1d":
        """Quantize real taps ``h`` (rint, clip) and prepare them."""
        if not qformat.tpu_native:
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 is not representable in "
                "the int32 band kernel; use models.golden."
            )
        return cls(qformat.quantize_coeffs(h).astype(np.int64), qformat,
                   device)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return fir_band(x_u8, self)


def fir_band_plain(x_u8: torch.Tensor, fir: FixedFir1d) -> torch.Tensor:
    """The band formulation in torch int64 on the CPU (kernel A's plain version).

    Rebias ``x ^ 0x80`` as int8, zero pad to whole 128-lane tiles (pads
    rebias to −128), then per plane ``cur @ a_cur + prev @ a_prev +
    next @ a_next`` over every tile, shifted by the plane's exponent and
    summed mod 2^32 onto the bias, then the same epilogue as the kernel.
    """
    batch, n = x_u8.shape
    center = fir.num_taps // 2
    left = fir.num_taps - 1 - center
    tiles = max(1, -(-n // LANE))
    n_pad = tiles * LANE
    # Left halo, then zeros up to one whole tile past the padded row.
    xe = F.pad(x_u8, (left, n_pad + LANE - n))
    xr = (xe ^ 0x80).view(torch.int8).to(torch.int64)
    cur = xr[:, left : left + n_pad].reshape(batch, tiles, LANE)
    prev = xr[:, :n_pad].reshape(batch, tiles, LANE)[:, :, :left]
    nxt = xr[:, left + LANE : left + LANE + n_pad].reshape(
        batch, tiles, LANE)[:, :, :center]
    acc = torch.full((batch, tiles, LANE), fir.bias_value & 0xFFFFFFFF,
                     dtype=torch.int64)
    a_prev, a_cur, a_next = (a.cpu().to(torch.int64)
                             for a in (fir.a_prev, fir.a_cur, fir.a_next))
    for plane, exp in enumerate(fir.exponents):
        prod = cur @ a_cur[plane]
        if left:
            prod = prod + prev @ a_prev[plane]
        if center:
            prod = prod + nxt @ a_next[plane]
        acc = (acc + (prod << exp)) & 0xFFFFFFFF
    out = plain_epilogue(acc, fir.qformat, fir.wrap)
    return out.reshape(batch, n_pad)[:, :n].contiguous()


def plain_epilogue(acc: torch.Tensor, qformat: QFormat,
                   wrap: bool) -> torch.Tensor:
    """The kernels' epilogue on int64 accumulators held mod 2^32.

    Reinterpret as int32, then the wrap path (``fixed_epilogue_i32``) or,
    where the rounding bias was folded into the start value, one
    arithmetic shift and the saturation.
    """
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    if wrap:
        return fixed_epilogue_i32(acc, qformat.frac_bits, qformat.acc_bits)
    return (acc >> qformat.frac_bits).clamp_(0, 255).to(torch.uint8)


def fir_band(x_u8: torch.Tensor, fir: FixedFir1d) -> torch.Tensor:
    """Kernel A on a CUDA tensor; :func:`fir_band_plain` on a CPU tensor.

    Raises on anything else: a tensor that is not 2-D uint8, a
    non-contiguous CUDA tensor, filter buffers on another device, a failed
    build or a failed launch.  Counts its launches in ``fir_band.launches``.
    """
    _build.check_rows_u8(x_u8)
    if x_u8.device.type == "cpu":
        return fir_band_plain(x_u8, fir)
    _build.check_launchable(x_u8)
    _build.check_same_device(x_u8, fir.digits, "filter buffers")
    qf = fir.qformat
    if not 1 <= qf.frac_bits <= 31:
        raise ValueError(f"band kernel needs 1 <= frac_bits <= 31, "
                         f"got {qf.frac_bits}")
    y = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x_u8.device):
        code = lib.wft_fir_band(
            x_u8.data_ptr(), y.data_ptr(), x_u8.shape[0], x_u8.shape[1],
            fir.digits.data_ptr(), len(fir.exponents), fir.num_taps,
            ctypes.addressof(fir.exponents_c), fir.bias_value & 0xFFFFFFFF,
            int(fir.wrap), qf.frac_bits, qf.acc_bits,
            ctypes.addressof(fir.taps_c), _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "fir_band")
    fir_band.launches += 1
    return y


fir_band.launches = 0


def fir1d_fixed_rows_mxu(x_u8: torch.Tensor, h,
                         qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, L ≤ 257, on
    ``x_u8.device`` (a host array goes to the card, ``_build.as_rows``):
    the JAX ``fir_mxu.py::fir1d_fixed_rows_mxu`` entry (its TPU blocking
    knobs dropped) over kernel A."""
    x_u8 = _build.as_rows(x_u8)
    with span("fir.prepare"):
        fir = FixedFir1d.from_numpy(h, qformat, x_u8.device)
    return fir_band(x_u8, fir)
