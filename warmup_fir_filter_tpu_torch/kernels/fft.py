"""Kernels K, L and M: the FFT path (ports K12, K13 and K14).

Counterpart of ``warmup_fir_filter_tpu/kernels/fft_pallas.py``:

- kernel K (``csrc/fft_rows.cu``, ports K12, ``:406``, ``:418``, ``:424``):
  the batched row FFT and scaled inverse, natural order in and out, as
  Stockham passes of radix 16 in registers (``csrc/wft_fft_rows.cuh``);
  wrapper :func:`fft_rows`, entry :func:`fft_rows_pallas`;
- kernel L (``csrc/osfilt.cu``, ports K13, ``:519`` and ``:436``): the fused
  overlap-save filter over framed segments, f32 or u8 in and out; wrapper
  :func:`osfilt`, entries :func:`fir_overlap_save_pallas` and
  :func:`fir_overlap_save_quantized_pallas` with a pinned nfft or more
  than 257 taps;
- kernel M (``csrc/osfilt_stream.cu``, ports K14, ``:622``): the same
  filter by 512-point overlap-save straight off the raw ``(C, T)`` stream,
  its windows at the full hop of 512 − L + 1 valid outputs
  (:func:`stream_plan`) instead of the TPU kernel's lane-aligned hop of
  256 or 384 (:func:`_stream_geometry`); wrapper :func:`osfilt_stream`,
  entry :func:`fir_overlap_save_stream`, and the two entries above when
  nfft is automatic and :func:`stream_kernel_supported` holds (the JAX
  entries' routing).

The bound of L and M on an H100 is their device-memory traffic (about
0.38 ms for config 4's 1.28 GB in f32).  So that trips through shared
memory do not hold them far above it, both keep their points in
registers: they run the filter core of ``csrc/wft_fft_rows.cuh`` on
kernel K's passes, 16 points a thread, the forward, the product with the
natural-order spectrum and the inverse with four exchanges through shared
memory a 512- or 2,048-point filter, two real segments or windows a
complex transform.  The table builders are the JAX module's, as numpy, so
the tests can hold them equal: :func:`factor_nfft`, :func:`_dft_tables`,
:func:`_osfilt_spectrum`, :func:`_osfilt_spectrum_shifted`,
:func:`_stream_geometry` and :func:`_osfilt_fold_tables` (f32, from f64:
the card has native f32, so there is no bf16 hi/lo split).  The plain
versions (:func:`fft_rows_plain`, :func:`osfilt_plain`,
:func:`osfilt_stream_plain`) carry the JAX formulation in float64 on the
input's device: the 4-step ``nfft = N1·128`` DFT with those tables as
matmuls, the twiddle multiply between them and the scrambled spectrum;
for the stream, the folded per-k1 tables of the TPU stream kernel over the
windows of :func:`_stream_geometry`.  The kernels compute the same
functions with their own FFTs (and M with its own windows), so they agree
with the plain versions to f32 rounding (>= 120 dB), not bit for bit.

The TPU layout helpers (the m-layout and spectrum (un)scrambling, the bf16
operand split, ``_auto_block_rows``, ``block_rows``, ``r_windows``) have no
counterpart: a CTA transforms whole rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fftfilt import frame_overlap, pick_nfft
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

LANE = 128
#: Largest FFT the 4-step N1×N2 split supports (N1, N2 ≤ lane width).
MAX_NFFT = LANE * LANE
#: Kernel M's transform size.
STREAM_NFFT = 512
#: Sample types kernels L and M read; kernel K reads f32 planes.
SAMPLE_DTYPES = (torch.uint8, torch.float32)
#: Points a plain version transforms at a time (bounds its float64
#: intermediates on the card).
_PLAIN_CHUNK_POINTS = 1 << 24


def _check_nfft_for_taps(nfft: int, num_taps: int) -> None:
    """Reject out-of-range nfft at dispatch with an actionable error.

    ``pick_nfft`` grows as next_pow2(8·L), so num_taps > 2048 would
    request nfft > MAX_NFFT and die inside ``factor_nfft``; surface the
    limit (and the fallback paths) here instead.
    """
    if nfft < num_taps:
        raise ValueError(f"nfft={nfft} must be >= num_taps={num_taps}")
    if nfft > MAX_NFFT:
        raise ValueError(
            f"nfft={nfft} exceeds the fused Pallas FFT kernel's "
            f"{MAX_NFFT}-point cap (num_taps={num_taps}; the default "
            f"pick_nfft exceeds the cap for num_taps > {MAX_NFFT // 8}). "
            "Pass nfft<=16384 explicitly, or use ops.fftfilt."
            "fir_overlap_save (XLA FFT) / kernels.dispatch."
            "fir1d_fixed_rows_auto (direct MXU) instead."
        )


def factor_nfft(nfft: int) -> tuple[int, int]:
    """Split ``nfft = N1 × N2`` with N2 = lane width (or all of nfft)."""
    if nfft < 2 or nfft & (nfft - 1):
        raise ValueError(f"nfft={nfft} must be a power of two >= 2")
    n2 = min(LANE, nfft)
    n1 = nfft // n2
    if n1 > LANE:
        raise ValueError(f"nfft={nfft} > {LANE * LANE} is unsupported")
    return n1, n2


@functools.lru_cache(maxsize=16)
def _dft_tables(nfft: int) -> dict[str, np.ndarray]:
    """Real/imag DFT factor matrices + twiddles for the 4-step split.

    Forward uses (f1, t, f2); inverse uses their conjugates (g1, tc, g2)
    with the 1/nfft scale folded into g1.
    """
    n1, n2 = factor_nfft(nfft)
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    f1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)  # [k1, n1]
    t = np.exp(-2j * np.pi * np.outer(k1, j2) / nfft)  # [k1, n2]
    f2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)  # [n2, k2]
    g1 = f1.conj() / nfft  # [n1, k1], scaled
    g2 = f2.conj()  # [k2, n2]
    if n1 == 1:
        # Degenerate single-factor split: the inverse skips the g1
        # matmul, so the 1/nfft scale must ride on g2 instead.
        g2 = g2 / nfft
    out = {}
    for name, mat in (("f1", f1), ("t", t), ("f2", f2), ("g1", g1),
                      ("g2", g2)):
        out[name + "c"] = np.ascontiguousarray(mat.real, np.float32)
        out[name + "s"] = np.ascontiguousarray(mat.imag, np.float32)
    return out


def _osfilt_fold_tables(hc, hs, tables: dict, n1: int, n2: int) -> dict:
    """Per-k1 folded matmul tables of the fused filter, computed in
    float64 and stored as f32:

    - ``T2F_k1  = diag(t[k1,:]) @ F2``                       (forward)
    - ``HG2T_k1 = diag(H[k1,:]) @ G2 @ diag(conj t[k1,:])``  (inverse)

    stacked along k1 into (N1·N2, N2) planes (keys ``t2fc``, ``t2fs``,
    ``hg2c``, ``hg2s`` beside the DFT tables).
    """
    t = (np.asarray(tables["tc"], np.float64)
         + 1j * np.asarray(tables["ts"], np.float64))
    f2 = (np.asarray(tables["f2c"], np.float64)
          + 1j * np.asarray(tables["f2s"], np.float64))
    g2 = (np.asarray(tables["g2c"], np.float64)
          + 1j * np.asarray(tables["g2s"], np.float64))
    hp = np.asarray(hc, np.float64) + 1j * np.asarray(hs, np.float64)
    t2f = np.concatenate(
        [t[k][:, None] * f2 for k in range(n1)], axis=0)
    hg2t = np.concatenate(
        [hp[k][:, None] * g2 * np.conj(t[k])[None, :] for k in range(n1)],
        axis=0)
    out = dict(tables)
    for key, mat in (("t2fc", t2f.real), ("t2fs", t2f.imag),
                     ("hg2c", hg2t.real), ("hg2s", hg2t.imag)):
        out[key] = np.ascontiguousarray(mat, np.float32)
    return out


def _stream_geometry(num_taps: int, off: int):
    """Single source of truth for the stream kernel's alignment class.

    Returns ``(center, d, m_shift, hop_tiles)``: the spectral shift
    ``d = (-(off+center)) mod 128`` folded into H, the window-placement
    offset ``m_shift = (off+center+d)/128``, and the window hop (3 lane
    tiles when the class admits the 3-chunk valid window — d ≤ 129−L —
    else 2).
    """
    center = num_taps // 2
    d = (-(off + center)) % LANE
    m_shift = (off + center + d) // LANE
    hop = 3 if d <= LANE + 1 - num_taps else 2
    return center, d, m_shift, hop


def stream_kernel_supported(num_taps: int, off: int = 0,
                            nfft: int = 512) -> bool:
    """Gate for the stream overlap-save kernel (nfft=512)."""
    if nfft != 512:
        return False
    _, d, _, _ = _stream_geometry(num_taps, off)
    return (1 <= num_taps <= 257 and off >= 0 and off + num_taps // 2 <= 256
            and d <= nfft // 2 + 1 - num_taps)


def stream_plan(num_taps: int, off: int) -> tuple[int, int]:
    """Kernel M's windows: ``(hop, start)``.

    Window ``w`` of a channel covers samples ``[w·hop + start, w·hop +
    start + 512)`` (zero outside the stream); its circular outputs ``p ∈
    [L − 1, 512)`` are the call's outputs ``q = w·hop + p − (L − 1)``.  So
    ``hop = 512 − L + 1``, every valid output of a window, and ``start =
    off + L//2 − (L − 1)``; the filter spectrum is h's own, with no shift.
    """
    return (STREAM_NFFT - num_taps + 1,
            off + num_taps // 2 - (num_taps - 1))


def _osfilt_spectrum_shifted(h64, nfft: int, d: int):
    """Scrambled-order filter spectrum with the alignment shift folded
    in (circularly delays the filtered output by ``d`` samples)."""
    n1, n2 = factor_nfft(nfft)
    k = np.arange(nfft)
    h_freq = np.fft.fft(np.asarray(h64, np.float64), nfft)
    h_freq = h_freq * np.exp(-2j * np.pi * k * d / nfft)
    hp = np.ascontiguousarray(h_freq.reshape(n2, n1).T)
    return (np.ascontiguousarray(hp.real, np.float32),
            np.ascontiguousarray(hp.imag, np.float32))


def _osfilt_spectrum(h64, nfft: int):
    """Filter spectrum permuted to the kernel's scrambled (k1, k2) order."""
    n1, n2 = factor_nfft(nfft)
    h_freq = np.fft.fft(h64, nfft)
    hp = np.ascontiguousarray(h_freq.reshape(n2, n1).T)
    return (np.ascontiguousarray(hp.real, np.float32),
            np.ascontiguousarray(hp.imag, np.float32))


# ------------------------------------------------------------ kernel tables


def _log2(nfft: int) -> int:
    factor_nfft(nfft)
    return nfft.bit_length() - 1


def fft_twiddles(nfft: int) -> np.ndarray:
    """``exp(-2πi·k/nfft)`` for k < nfft/2, computed in float64, as
    (nfft/2, 2) f32 re/im pairs: the kernels' twiddle table."""
    k = np.arange(nfft // 2, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / nfft)
    return np.ascontiguousarray(np.stack([w.real, w.imag], -1), np.float32)


@functools.lru_cache(maxsize=32)
def _twiddles_on(nfft: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fft_twiddles(nfft), device=device)


class FilterSpectrum(nn.Module):
    """A filter's spectrum for kernels L and M on one device.

    ``spectrum`` (buffer, (nfft, 2) f32) is what the kernels read:
    ``H[k] / nfft``, h's spectrum in natural order, computed in float64,
    with the inverse's scale folded in (kernel M places its windows so that
    it needs no shift); ``twiddles`` (buffer) is :func:`fft_twiddles`.
    ``hc`` and ``hs`` (numpy, (N1, N2) f32) are the scrambled spectrum of
    the JAX package (:func:`_osfilt_spectrum`, or
    :func:`_osfilt_spectrum_shifted` with the stream kernel's alignment
    shift ``d > 0``), which the plain versions multiply by.
    """

    def __init__(self, h, nfft: int, *, d: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        h64 = np.asarray(h, np.float64)
        _check_nfft_for_taps(nfft, h64.size)
        self.num_taps = int(h64.size)
        self.nfft = nfft
        self.d = d
        self.hc, self.hs = (_osfilt_spectrum_shifted(h64, nfft, d) if d
                            else _osfilt_spectrum(h64, nfft))
        spec = np.fft.fft(h64, nfft) / nfft
        device = torch.device(device)
        self.register_buffer("spectrum", torch.as_tensor(
            np.stack([spec.real, spec.imag], -1).astype(np.float32),
            device=device))
        self.register_buffer("twiddles", _twiddles_on(nfft, device))


# ------------------------------------------------------------ plain versions


def _complex_table(tables: dict, name: str, device) -> torch.Tensor:
    return torch.complex(
        torch.as_tensor(tables[name + "c"], dtype=torch.float64),
        torch.as_tensor(tables[name + "s"], dtype=torch.float64)).to(device)


def _four_step(x: torch.Tensor, tab: dict, n1: int, n2: int) -> torch.Tensor:
    """Forward 4-step DFT of (..., nfft) complex rows (``n = N2·n1 + n2``)
    → the scrambled spectrum ``C[..., k1, k2] = X[k1 + N1·k2]``."""
    xm = x.reshape(*x.shape[:-1], n1, n2)
    return ((tab["f1"] @ xm) * tab["t"]) @ tab["f2"]


def _four_step_inverse(c: torch.Tensor, tab: dict, n1: int) -> torch.Tensor:
    """Scaled inverse of :func:`_four_step`: scrambled spectrum →
    (..., nfft) natural rows.  With N1 = 1 the scale rides on G2 and
    there is no G1 factor (``_dft_tables``)."""
    e = c @ tab["g2"]
    if n1 > 1:
        e = tab["g1"] @ (e * tab["t"].conj())
    return e.reshape(*c.shape[:-2], -1)


def _plain_tables(nfft: int, device) -> dict:
    tables = _dft_tables(nfft)
    return {name: _complex_table(tables, name, device)
            for name in ("f1", "t", "f2", "g1", "g2")}


def _row_chunks(rows: int, width: int):
    step = max(1, _PLAIN_CHUNK_POINTS // max(width, 1))
    return [slice(lo, min(rows, lo + step)) for lo in range(0, rows, step)]


def fft_rows_plain(xr: torch.Tensor, xi: torch.Tensor | None, *,
                   inverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K's plain version: the 4-step DFT of (B, nfft) rows in
    float64 on ``xr.device``, natural order in and out; the inverse takes
    the natural spectrum through the scrambled order of ``_ifft_kernel``
    and carries the 1/nfft scale.  Returns float64 (re, im)."""
    batch, nfft = xr.shape
    n1, n2 = factor_nfft(nfft)
    tab = _plain_tables(nfft, xr.device)
    re = torch.empty((batch, nfft), dtype=torch.float64, device=xr.device)
    im = torch.empty_like(re)
    for rows in _row_chunks(batch, nfft):
        x = torch.complex(xr[rows].to(torch.float64),
                          torch.zeros_like(xr[rows], dtype=torch.float64)
                          if xi is None else xi[rows].to(torch.float64))
        if inverse:
            c = x.reshape(-1, n2, n1).transpose(-1, -2)
            y = _four_step_inverse(c, tab, n1)
        else:
            y = _four_step(x, tab, n1, n2).transpose(-1, -2).reshape(-1, nfft)
        re[rows], im[rows] = y.real, y.imag
    return re, im


def osfilt_plain(segments: torch.Tensor,
                 spectrum: FilterSpectrum) -> torch.Tensor:
    """Kernel L's plain version (``_osfilt_kernel``): per (B, nfft)
    segment, the real 4-step forward DFT, times the scrambled spectrum,
    the inverse, real part; float64 on the segments' device."""
    batch, nfft = segments.shape
    n1, n2 = factor_nfft(nfft)
    tab = _plain_tables(nfft, segments.device)
    hp = torch.complex(torch.as_tensor(spectrum.hc, dtype=torch.float64),
                       torch.as_tensor(spectrum.hs, dtype=torch.float64)
                       ).to(segments.device)
    y = torch.empty((batch, nfft), dtype=torch.float64,
                    device=segments.device)
    for rows in _row_chunks(batch, nfft):
        x = segments[rows].to(torch.float64).to(torch.complex128)
        y[rows] = _four_step_inverse(_four_step(x, tab, n1, n2) * hp, tab,
                                     n1).real
    return y


def _zero_extended(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """``x[:, start : start + length]``, zero outside ``[0, T)``."""
    out = x.new_zeros((x.shape[0], length))
    lo, hi = max(start, 0), min(start + length, x.shape[1])
    if hi > lo:
        out[:, lo - start:hi - start] = x[:, lo:hi]
    return out


def osfilt_stream_plain(x: torch.Tensor, tables: FilterSpectrum, *, off: int,
                        out_len: int) -> torch.Tensor:
    """Kernel M's plain version, the TPU stream kernel's formulation in
    float64 on ``x.device``: the 512-point windows of
    :func:`_stream_geometry` (window w starts at ``128·(hop·w + m_shift −
    c0)``, zero outside the stream), the outer 4-point DFT, the per-k1
    folded tables (forward twiddle and F2; spectrum, G2 and inverse
    twiddle), the inverse outer DFT of the valid chunks ``[c0, 4)``.
    Returns (C, out_len) float64."""
    _, _, m_shift, hop_tiles = _stream_geometry(tables.num_taps, off)
    n1, c0 = STREAM_NFFT // LANE, 4 - hop_tiles
    hop = hop_tiles * LANE
    windows = -(-out_len // hop)
    fold = _osfilt_fold_tables(tables.hc, tables.hs, _dft_tables(STREAM_NFFT),
                               n1, LANE)
    f1 = _complex_table(fold, "f1", x.device)
    g1 = _complex_table(fold, "g1", x.device)[c0:]
    t2f = _complex_table(fold, "t2f", x.device).reshape(n1, LANE, LANE)
    hg2 = _complex_table(fold, "hg2", x.device).reshape(n1, LANE, LANE)
    xs = _zero_extended(x.to(torch.float64), LANE * (m_shift - c0),
                        (windows - 1) * hop + STREAM_NFFT)
    y = torch.empty((x.shape[0], windows * hop), dtype=torch.float64,
                    device=x.device)
    for rows in _row_chunks(x.shape[0], windows * STREAM_NFFT):
        slabs = xs[rows].unfold(1, STREAM_NFFT, hop).reshape(
            -1, windows, n1, LANE).to(torch.complex128)
        a = torch.einsum("kj,cwjn->cwkn", f1, slabs)
        e = torch.einsum("cwkm,kmp->cwkp",
                         torch.einsum("cwkn,knm->cwkm", a, t2f), hg2)
        y[rows] = torch.einsum("qk,cwkp->cwqp", g1, e).real.reshape(
            -1, windows * hop)
    return y[:, :out_len]


# ------------------------------------------------------------------ wrappers


def _u8_stage(y: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' u8 output stage: round half up, saturate."""
    return torch.clamp(torch.floor(y + 0.5), 0, 255).to(torch.uint8)


def fft_rows(xr: torch.Tensor, xi: torch.Tensor | None, *,
             inverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K on CUDA planes; :func:`fft_rows_plain` (cast to f32) on CPU
    planes.

    ``xr`` and ``xi`` are (B, nfft) f32 planes, ``xi`` None for a real
    input (forward only).  Raises on anything else, a non-contiguous CUDA
    plane, a failed build or a failed launch.  Counts its launches in
    ``fft_rows.launches``.
    """
    _build.check_rows(xr, (torch.float32,))
    if xi is not None:
        _build.check_rows(xi, (torch.float32,))
        if xi.shape != xr.shape or xi.device != xr.device:
            raise ValueError(f"re/im must be matching (B, nfft) planes, got "
                             f"{tuple(xr.shape)} vs {tuple(xi.shape)}")
    elif inverse:
        raise ValueError("inverse FFT requires both re and im planes")
    nfft = xr.shape[1]
    log_n = _log2(nfft)
    if xr.device.type == "cpu":
        re, im = fft_rows_plain(xr, xi, inverse=inverse)
        return re.to(torch.float32), im.to(torch.float32)
    if not xr.is_contiguous() or (xi is not None and not xi.is_contiguous()):
        raise ValueError("kernel input must be contiguous")
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    if xr.shape[0] == 0:
        return yr, yi
    lib = _build.load_library()
    with torch.cuda.device(xr.device):
        code = lib.wft_fft_rows(
            xr.data_ptr(), None if xi is None else xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), xr.shape[0], log_n,
            _twiddles_on(nfft, xr.device).data_ptr(), int(inverse),
            _build.stream_of(xr),
        )
    _build.check_launch(lib, code, "fft_rows")
    fft_rows.launches += 1
    return yr, yi


fft_rows.launches = 0


def osfilt(segments: torch.Tensor, spectrum: FilterSpectrum, *,
           out_u8: bool) -> torch.Tensor:
    """Kernel L on CUDA segments; :func:`osfilt_plain` (cast to f32, then
    the u8 stage when ``out_u8``) on CPU segments.

    ``segments`` is (B, nfft) uint8 or f32 with ``nfft ==
    spectrum.nfft``; returns (B, nfft) f32, or uint8 when ``out_u8``.
    Counts its launches in ``osfilt.launches``.
    """
    _build.check_rows(segments, SAMPLE_DTYPES)
    if segments.shape[1] != spectrum.nfft:
        raise ValueError(f"segments of {segments.shape[1]} points, spectrum "
                         f"of {spectrum.nfft}")
    if segments.device.type == "cpu":
        y = osfilt_plain(segments, spectrum).to(torch.float32)
        return _u8_stage(y) if out_u8 else y
    if not segments.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    _build.check_same_device(segments, spectrum.spectrum, "filter spectrum")
    y = torch.empty(segments.shape,
                    dtype=torch.uint8 if out_u8 else torch.float32,
                    device=segments.device)
    if y.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(segments.device):
        code = lib.wft_osfilt(
            segments.data_ptr(), y.data_ptr(), segments.shape[0],
            _log2(spectrum.nfft), spectrum.twiddles.data_ptr(),
            spectrum.spectrum.data_ptr(), int(segments.dtype == torch.uint8),
            int(out_u8), _build.stream_of(segments),
        )
    _build.check_launch(lib, code, "osfilt")
    osfilt.launches += 1
    return y


osfilt.launches = 0


def osfilt_stream(x: torch.Tensor, tables: FilterSpectrum, *, off: int,
                  out_len: int, out_u8: bool) -> torch.Tensor:
    """Kernel M on a CUDA stream; :func:`osfilt_stream_plain` (cast to
    f32, then the u8 stage when ``out_u8``) on a CPU one.

    ``x`` is (C, T) uint8 or f32; ``tables`` a 512-point
    :class:`FilterSpectrum` with the shift ``d`` of ``(L, off)``.
    Returns (C, out_len) f32, or uint8 when ``out_u8``:
    ``same_mode_fir(x, h)[:, q + off]``.  Counts its launches in
    ``osfilt_stream.launches``.
    """
    _build.check_rows(x, SAMPLE_DTYPES)
    if tables.nfft != STREAM_NFFT or not stream_kernel_supported(
            tables.num_taps, off):
        raise ValueError(f"stream kernel unsupported for num_taps="
                         f"{tables.num_taps}, off={off}, nfft={tables.nfft}")
    _, d, _, _ = _stream_geometry(tables.num_taps, off)
    if d != tables.d:
        raise ValueError(f"the spectrum carries the shift d={tables.d}; "
                         f"off={off} needs d={d}")
    if out_len < 1:
        raise ValueError(f"invalid out_len={out_len}")
    if x.device.type == "cpu":
        y = osfilt_stream_plain(x, tables, off=off,
                                out_len=out_len).to(torch.float32)
        return _u8_stage(y) if out_u8 else y
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    _build.check_same_device(x, tables.spectrum, "filter spectrum")
    y = torch.empty((x.shape[0], out_len),
                    dtype=torch.uint8 if out_u8 else torch.float32,
                    device=x.device)
    if y.numel() == 0 or x.shape[1] == 0:
        return y.zero_()
    hop, start = stream_plan(tables.num_taps, off)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.wft_osfilt_stream(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], out_len, hop,
            start, tables.twiddles.data_ptr(), tables.spectrum.data_ptr(),
            int(x.dtype == torch.uint8), int(out_u8), _build.stream_of(x),
        )
    _build.check_launch(lib, code, "osfilt_stream")
    osfilt_stream.launches += 1
    return y


osfilt_stream.launches = 0


# --------------------------------------------------------------- entries


def fft_rows_pallas(xr, xi=None, *,
                    inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over (B, nfft) rows on ``xr``'s device.

    ``xi=None`` means real input (forward only — an inverse needs a full
    spectrum).  ``inverse`` computes the scaled inverse transform.
    Returns natural-order ``(re, im)`` f32 planes, matching
    ``torch.fft.fft`` / ``torch.fft.ifft`` up to f32 rounding.
    """
    xr = torch.as_tensor(xr).to(torch.float32).contiguous()
    if xr.dim() != 2:
        raise ValueError(f"expected (B, nfft) rows, got {tuple(xr.shape)}")
    factor_nfft(xr.shape[1])
    if inverse and xi is None:
        raise ValueError("inverse FFT requires both re and im planes")
    if xi is not None:
        xi = torch.as_tensor(xi, device=xr.device).to(
            torch.float32).contiguous()
    return fft_rows(xr, xi, inverse=inverse)


def _osfilt_segments(x: torch.Tensor, num_taps: int, nfft: int):
    """Frame a (C, T) stream into padded overlap-save segments, keeping
    the input dtype (the kernel widens uint8 itself)."""
    channels, time = x.shape
    center = num_taps // 2
    step = nfft - (num_taps - 1)
    num_blocks = -(-time // step)
    left = num_taps - 1 - center
    right = num_blocks * step - time + center + (num_taps - 1)
    xp = F.pad(x, (left, right))
    segments = frame_overlap(xp, nfft, step, num_blocks).reshape(
        channels * num_blocks, nfft)
    return segments.contiguous(), step, num_blocks


def _framed(x: torch.Tensor, h64: np.ndarray, nfft: int,
            out_u8: bool) -> torch.Tensor:
    """Frame, kernel L, discard the first L−1 of each segment, unframe."""
    num_taps = int(h64.size)
    channels, time = x.shape
    segments, step, num_blocks = _osfilt_segments(x, num_taps, nfft)
    y = osfilt(segments, FilterSpectrum(h64, nfft, device=x.device),
               out_u8=out_u8)
    valid = y[:, num_taps - 1:]  # overlap-save discard
    return valid.reshape(channels, num_blocks * step)[:, :time]


def fir_overlap_save_pallas(x: torch.Tensor, h, *,
                            nfft: int | None = None) -> torch.Tensor:
    """Float32 same-mode FIR by FFT overlap-save over (C, T) rows.

    Drop-in for :func:`ops.fftfilt.fir_overlap_save` (same alignment
    contract).  With nfft automatic and :func:`stream_kernel_supported`,
    kernel M straight off the stream; otherwise the framed kernel L.
    """
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    auto_nfft = nfft is None
    nfft = pick_nfft(num_taps) if nfft is None else nfft
    _check_nfft_for_taps(nfft, num_taps)
    factor_nfft(nfft)
    if auto_nfft and stream_kernel_supported(num_taps):
        return fir_overlap_save_stream(x, h64)
    return _framed(torch.as_tensor(x).to(torch.float32), h64, nfft,
                   out_u8=False)


def fir_overlap_save_quantized_pallas(x_u8: torch.Tensor, h, qformat=None, *,
                                      nfft: int | None = None
                                      ) -> torch.Tensor:
    """The FFT filter with quantized coefficients and the hardware output
    stage (round half up, saturate) → uint8.

    Mirrors :func:`ops.fftfilt.fir_overlap_save_quantized`: comparable to
    the bit-exact sim within the SNR bound.  uint8 in, uint8 out, no float
    plane in device memory: kernel M, or the framed kernel L.
    """
    qformat = QFormat() if qformat is None else qformat
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.float64)
    h_real = h_fixed / qformat.scale
    num_taps = int(h_real.size)
    auto_nfft = nfft is None
    nfft = pick_nfft(num_taps) if nfft is None else nfft
    _check_nfft_for_taps(nfft, num_taps)
    x_u8 = torch.as_tensor(x_u8).to(torch.uint8)
    if auto_nfft and stream_kernel_supported(num_taps):
        return fir_overlap_save_stream(x_u8, h_real, out_u8=True)
    return _framed(x_u8, h_real, nfft, out_u8=True)


def fir_overlap_save_stream(
    x: torch.Tensor,
    h,
    *,
    off: int = 0,
    out_len: int | None = None,
    out_u8: bool = False,
) -> torch.Tensor:
    """Float32 same-mode FIR through kernel M.

    ``out[q] = same_mode_fir(x, h)[q + off]`` for ``q < out_len``
    (default ``x.shape[1] - off``), zero-pad semantics outside the input.
    No framing, padding or slicing pass touches device memory.
    """
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    if not stream_kernel_supported(num_taps, off):
        raise ValueError(
            f"stream kernel unsupported for num_taps={num_taps}, "
            f"off={off} (need L <= 257 and the d-gate, see "
            "stream_kernel_supported); use fir_overlap_save_pallas")
    x = torch.as_tensor(x)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
    channels, tx = x.shape
    out_len = tx - off if out_len is None else out_len
    if out_len < 1 or off < 0:
        raise ValueError(f"invalid off={off} / out_len={out_len}")
    _, d, _, _ = _stream_geometry(num_taps, off)
    tables = FilterSpectrum(h64, STREAM_NFFT, d=d, device=x.device)
    return osfilt_stream(x.contiguous(), tables, off=off, out_len=out_len,
                         out_u8=out_u8)
