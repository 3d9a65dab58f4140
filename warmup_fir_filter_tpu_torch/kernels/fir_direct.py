"""Kernel B: the direct-form fixed-point FIR for any tap count (ports K4).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_pallas.py:62-186``: an
int32 multiply-add a tap that wraps mod 2^32, then the wrap / round /
saturate epilogue.  ``csrc/fir_direct.cu`` computes that accumulator mod
2^32 by one of two routes, chosen by tap count:

- up to :data:`SHORT_MAX_TAPS` taps, kernel A's short-tap core: the raw
  samples times the int32 taps in uint32 from ``bias − 128·Σh``
  (:func:`~warmup_fir_filter_tpu_torch.kernels.fir_band.band_bias`), that
  is from the rounding bias on the no-wrap path and from 0 otherwise;
- beyond, kernel C's int8 band products over chunks of the reversed taps
  (at most 4,096 taps each, so that a chunk's digit-plane sums stay exact
  in s32; :func:`pick_chunks` takes the longest that leaves two CTAs an
  SM): the signed base-256 digit planes of kernel C
  (``kept_digit_planes``), each trimmed per chunk to its nonzero quads,
  the chunks' sums folded into the accumulator mod 2^32.

:class:`FixedFirDirect` prepares both encodings once and holds them as
buffers.  :func:`fir_direct_plain` is kernel B's plain version: the same
routes' encodings in float64 products (every partial sum an integer below
2^53, so exact) folded mod 2^32 in int64, on the input's device.
``ops/fir1d.py::fir1d_fixed_rows_torch`` stays the independent reference
the tests hold both against.
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
from warmup_fir_filter_tpu_torch.kernels.fir_window import (
    MAX_TAPS as MAX_CHUNK_TAPS,
    window_band_planes_of,
)
from warmup_fir_filter_tpu_torch.ops.fir1d import require_int32_format
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.utils.profiling import span

#: Taps of the short-tap route (``wft_band.cuh``'s ``kShortMaxTaps``).
SHORT_MAX_TAPS = 32
#: Shared memory a CTA of the long route may take so that two fit an SM
#: (``csrc/fir_direct.cu`` weighs the chunk length): two chunks' digit
#: copies and sixteen windows.
SHARED_TARGET = 227 * 1024 // 2
#: Fields of a chunk's row in the chunk table (``csrc/wft_window.cuh``):
#: first copy word, first reversed tap, then PLANE_FIELDS a plane.
CHUNK_HEADER = 2
#: A plane's fields: exponent, first quad, quads, 0.
PLANE_FIELDS = 4
_MASK = 0xFFFFFFFF


def copy_stride(quads: int) -> int:
    """Words of one shifted copy of a plane of ``quads`` quads, as
    ``wft_window.cuh::window_layout`` lays it out: the k32 chunks an
    8-column sub-tile walks, 8 words each and 2 more, padded to 8 (mod
    32); 0 for a plane with no quads."""
    if quads == 0:
        return 0
    words = 8 * ((4 * quads + 10 + 31) // 32) + 2
    return words + (8 - words % 32) % 32


def plane_copies(rd: np.ndarray, a0: int, quads: int) -> np.ndarray:
    """The four shifted copies of a plane's reversed digits ``rd`` (int8),
    trimmed to the quads ``[a0, a0 + quads)``: copy sigma's word ``w``
    holds the bytes ``rd[4 (a0 − 2 + w) − sigma ..]`` (zero outside the
    quads and past ``rd``), little-endian (``window_copy_word``)."""
    stride = copy_stride(quads)
    lo, hi = 4 * a0, min(4 * (a0 + quads), rd.size)
    words = np.zeros((4, stride), np.uint32)
    at = 4 * (a0 - 2 + np.arange(stride))[:, None] + np.arange(4)[None, :]
    raw = rd.view(np.uint8)
    for sigma in range(4):
        p = at - sigma
        valid = (p >= lo) & (p < hi)
        vals = np.zeros(p.shape, np.uint8)
        vals[valid] = raw[p[valid]]
        words[sigma] = np.ascontiguousarray(vals).view("<u4")[:, 0]
    return words.reshape(-1)


def chunk_operands(digits: np.ndarray, exponents: tuple[int, ...],
                   chunk_taps: int) -> tuple[np.ndarray, np.ndarray]:
    """The long route's operands of kept digit planes ``(D, L)``.

    Chunk ``c`` holds the reversed digits ``rd[q0 .. q0 + chunk_taps)``,
    ``q0 = c·chunk_taps``; each plane is trimmed to its nonzero quads
    within the chunk.  Returns the copy words (uint32: every chunk's
    planes' four shifted copies in shared layout, at least 4) and the
    chunk table (int32, a row a chunk: first copy word, ``q0``, then
    ``(exponent, first quad, quads, 0)`` a plane).
    """
    if not (0 < chunk_taps <= MAX_CHUNK_TAPS and chunk_taps % 4 == 0):
        raise ValueError(f"chunk_taps must be a multiple of 4 in [4, "
                         f"{MAX_CHUNK_TAPS}], got {chunk_taps}")
    num_taps = digits.shape[1]
    reversed_digits = np.ascontiguousarray(digits[:, ::-1])
    words, rows, at = [], [], 0
    for q0 in range(0, num_taps, chunk_taps):
        row = [at, q0]
        for rd, exp in zip(reversed_digits[:, q0 : q0 + chunk_taps],
                           exponents):
            nz = np.flatnonzero(rd)
            if nz.size == 0:
                row += [exp, 0, 0, 0]
                continue
            a0, a1 = int(nz[0]) // 4, int(nz[-1]) // 4 + 1
            copies = plane_copies(np.ascontiguousarray(rd), a0, a1 - a0)
            words.append(copies)
            at += copies.size
            row += [exp, a0, a1 - a0, 0]
        rows.append(row)
    copies = np.concatenate(words) if words else np.zeros(0, np.uint32)
    if copies.size < 4:
        copies = np.zeros(4, np.uint32)
    return copies, np.asarray(rows, np.int32)


def chunk_shared_bytes(table: np.ndarray) -> int:
    """Shared memory of a CTA of the long route for a chunk table: two
    copy buffers and two windows for each of eight warps, each the largest
    chunk's, as ``wft_window.cuh::window_layout`` sizes them."""
    copy_bytes = buf_bytes = 0
    for row in table:
        fields = row[CHUNK_HEADER:].reshape(-1, PLANE_FIELDS)
        words, j0, j1 = 0, None, None
        for _, a0, quads, _ in fields:
            if quads == 0:
                continue
            words += 4 * copy_stride(int(quads))
            lo = 4 * int(a0) - 4
            hi = 4 * int(a0) + 32 * ((4 * int(quads) + 41) // 32) + 512 - 8
            j0 = lo if j0 is None else min(j0, lo)
            j1 = hi if j1 is None else max(j1, hi)
        copy_bytes = max(copy_bytes, 4 * words)
        if j0 is not None:
            buf_bytes = max(buf_bytes, (j1 - j0 + 30) >> 4 << 4)
    return 2 * copy_bytes + 16 * buf_bytes


#: Chunk lengths :func:`pick_chunks` tries, longest first.
CHUNK_LADDER = (4096, 3072, 2048, 1536, 1024, 768, 512, 384, 256, 128, 64)


def pick_chunks(digits: np.ndarray, exponents: tuple[int, ...],
                ) -> tuple[int, np.ndarray, np.ndarray]:
    """The long route's chunk length and operands: the longest of
    CHUNK_LADDER whose CTA fits SHARED_TARGET, so that two CTAs share an
    SM.  Long chunks measured faster than chunks of equal length, even
    where the last one holds a single tap (PERF.md §6)."""
    for chunk in CHUNK_LADDER:
        copies, table = chunk_operands(digits, exponents, chunk)
        if chunk_shared_bytes(table) <= SHARED_TARGET:
            break
    return chunk, copies, table


class FixedFirDirect(nn.Module):
    """Kernel B's filter, quantized and encoded once, on one device.

    Buffers: ``h_fixed`` (int32 taps), ``bias`` (int32) and ``needs_wrap``
    (bool), which with the int32 taps are the short route's parameters
    (the taps also as a host array, ``taps_c``, the kernel's parameters);
    ``digits`` (kept digit planes, ``(D_kept, L)`` int8), ``copies`` (the
    chunks' shifted digit copies, uint32 words as int32) and
    ``chunk_table`` (int32, a row a chunk, also as a host array,
    ``table_c``), the long route's, in chunks of ``chunk_taps`` reversed
    taps (:func:`pick_chunks` where not given).  A filter of up to
    SHORT_MAX_TAPS taps keeps a placeholder copy word and chunk table.
    """

    def __init__(self, h, qformat: QFormat = QFormat(),
                 device: torch.device | str = "cpu", *,
                 chunk_taps: int | None = None):
        super().__init__()
        require_int32_format(qformat)
        self.h = np.asarray(h, dtype=np.float64)
        self.qformat = qformat
        h_fixed = qformat.quantize_coeffs(self.h).astype(np.int64)
        self.num_taps = int(h_fixed.size)
        self.short = self.num_taps <= SHORT_MAX_TAPS
        digits, exponents = kept_digit_planes(h_fixed)
        bias, needs_wrap = band_bias(h_fixed, qformat)
        self.exponents = exponents
        self.bias_value = bias
        self.wrap = needs_wrap
        if self.short:
            chunk_taps = self.num_taps
            copies = np.zeros(4, np.uint32)
            table = np.zeros((1, CHUNK_HEADER + PLANE_FIELDS * len(exponents)),
                             np.int32)
        elif chunk_taps is None:
            chunk_taps, copies, table = pick_chunks(digits, exponents)
        else:
            copies, table = chunk_operands(digits, exponents, chunk_taps)
        self.chunk_taps = chunk_taps
        # The launch's host arrays, built once.
        self.taps_c = (ctypes.c_int32 * h_fixed.size)(
            *h_fixed.astype(np.int32).tolist())
        self.table_c = (ctypes.c_int * table.size)(*table.ravel().tolist())

        def buf(name: str, value: np.ndarray) -> None:
            self.register_buffer(name, torch.as_tensor(value, device=device))

        buf("h_fixed", h_fixed.astype(np.int32))
        buf("bias", np.asarray(bias, dtype=np.int32))
        buf("needs_wrap", np.asarray(needs_wrap))
        buf("digits", np.ascontiguousarray(digits))
        buf("copies", copies.view(np.int32))
        buf("chunk_table", table)

    def chunks(self) -> list[tuple[int, int]]:
        """``(q0, length)`` of each chunk of the reversed taps."""
        return [(q0, min(self.chunk_taps, self.num_taps - q0))
                for q0 in range(0, self.num_taps, self.chunk_taps)]

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        _build.check_rows_u8(x_u8)
        if x_u8.device.type == "cpu":
            return fir_direct_plain(x_u8, self)
        return _launch(x_u8, self)


def fir_direct_plain(x_u8: torch.Tensor, fir: FixedFirDirect) -> torch.Tensor:
    """Kernel B's plain version on ``x_u8.device``, by the filter's route.

    Short route: ``Σ_k h[k]·x[n − k + center]`` over the raw samples
    zero-padded, plus ``bias − 128·Σh``, mod 2^32.  Long route: the row
    rebiased ``x ^ 0x80`` and padded as kernel C's plain version pads it
    (pads read −128), then for each chunk ``q0`` its forward digits
    ``digit[L − q0 − len : L − q0]`` as a band per plane
    (``window_band_planes_of``, trimmed to the chunk's nonzero taps), one
    ``window @ band`` over every 128-lane tile from column ``q0``, shifted
    by the plane's exponent and folded onto the bias mod 2^32.  Both in
    float64 products and sums, exact integers, then the kernels' epilogue.
    """
    batch, n = x_u8.shape
    num_taps = fir.num_taps
    center = num_taps // 2
    left = num_taps - 1 - center
    dev = x_u8.device
    if fir.short:
        xp = F.pad(x_u8, (left, center)).to(torch.float64)
        h = fir.h_fixed.cpu().numpy().astype(np.float64)
        s = torch.zeros((batch, n), dtype=torch.float64, device=dev)
        for k in range(num_taps):
            s += float(h[k]) * xp[:, num_taps - 1 - k : num_taps - 1 - k + n]
        start = (fir.bias_value - 128 * int(h.sum())) & _MASK
        acc = (s.to(torch.int64) + start) & _MASK
        return plain_epilogue(acc, fir.qformat, fir.wrap)
    tiles = max(1, -(-n // LANE))
    n_pad = tiles * LANE
    xe = F.pad(x_u8, (left, n_pad - n + center))
    xr = (xe ^ 0x80).view(torch.int8).to(torch.float64)
    acc = torch.full((batch, tiles, LANE), fir.bias_value & _MASK,
                     dtype=torch.int64, device=dev)
    digits = fir.digits.cpu().numpy()
    for q0, length in fir.chunks():
        part = digits[:, num_taps - q0 - length : num_taps - q0]
        bands, entries = window_band_planes_of(part, fir.exponents)
        bands = torch.from_numpy(bands).to(device=dev, dtype=torch.float64)
        for exp, j0, rows, off in entries:
            if exp >= 32:  # nothing is left of it mod 2^32
                continue
            start = q0 + j0
            window = xr[:, start : start + (tiles - 1) * LANE + rows].unfold(
                1, rows, LANE)
            prod = (window @ bands[off : off + rows]).to(torch.int64)
            acc = (acc + (prod << exp)) & _MASK
    out = plain_epilogue(acc, fir.qformat, fir.wrap)
    return out.reshape(batch, n_pad)[:, :n].contiguous()


def _launch(x_u8: torch.Tensor, fir: FixedFirDirect) -> torch.Tensor:
    """Kernel B over CUDA rows with the filter's buffers on their device."""
    _build.check_launchable(x_u8)
    _build.check_same_device(x_u8, fir.copies, "filter buffers")
    qf = fir.qformat
    if not 1 <= qf.frac_bits <= 31:
        raise ValueError(f"direct kernel needs 1 <= frac_bits <= 31, "
                         f"got {qf.frac_bits}")
    y = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x_u8.device):
        code = lib.wft_fir_direct(
            x_u8.data_ptr(), y.data_ptr(), x_u8.shape[0], x_u8.shape[1],
            fir.num_taps, ctypes.addressof(fir.taps_c),
            fir.bias_value & _MASK, int(fir.wrap), qf.frac_bits, qf.acc_bits,
            fir.copies.data_ptr(), fir.copies.numel(),
            fir.chunk_table.data_ptr(), ctypes.addressof(fir.table_c),
            fir.chunk_table.shape[0], len(fir.exponents),
            _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "fir_direct")
    fir_direct.launches += 1
    return y


def fir_direct(x_u8: torch.Tensor, h, qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, direct form, any L.

    Kernel B on a CUDA tensor; its plain version on a CPU tensor.  Raises
    on a tensor that is not 2-D uint8, a non-contiguous CUDA tensor, an
    ``acc_bits`` above 32, a failed build or a failed launch.  Counts its
    launches in ``fir_direct.launches``.
    """
    _build.check_rows_u8(x_u8)
    with span("fir.prepare"):
        fir = FixedFirDirect(h, qformat, x_u8.device)
    return fir(x_u8)


fir_direct.launches = 0


def fir1d_fixed_rows_pallas(x_u8: torch.Tensor, h,
                            qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, any L, on
    ``x_u8.device`` (a host array goes to the card, ``_build.as_rows``):
    the JAX ``fir_pallas.py::fir1d_fixed_rows_pallas`` entry (its TPU
    blocking knobs dropped) over kernel B."""
    return fir_direct(_build.as_rows(x_u8), h, qformat)
