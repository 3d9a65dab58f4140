"""Kernel J: the DSP chain in one pass (ports K11).

Counterpart of ``warmup_fir_filter_tpu/kernels/chain_fused.py``: polyphase
resample → same-mode channelizer → FM discriminator over (C, T) I/Q rows,
with the intermediates kept on chip.  The stages keep the staged ops'
contracts (``ops/resample.py``, ``kernels/fir_float.py``,
``ops/demod.py``):

- the resampled stream is zero outside ``rs_bounds = [lo, hi)``, by
  default ``[0, out_len)``: the staged path's zero pad of the resampled
  stream (``:246-265``); the time-sharded chain passes its global window;
- each message needs the previous channelized sample, and only output 0
  (of this call) is 0 (``:281-323``).

:class:`FusedChain` holds the prepared filters (a
:class:`~warmup_fir_filter_tpu_torch.kernels.resample.PolyphaseResampler`
and a :class:`~warmup_fir_filter_tpu_torch.kernels.fir_float.FloatFir1d`).
:func:`chain_fused` launches ``csrc/chain_fused.cu`` on CUDA tensors and
runs :func:`chain_fused_plain` on CPU tensors.  :func:`chain_forward_fused`
is the entry point with the JAX function's signature (``:416``, minus its
TPU knobs ``seg_tiles``, ``opt`` and ``fold``), and
:func:`chain_fused_supported` gives the JAX gate's answers (``:394-413``),
so that ``models/chain.py`` takes the same path as the JAX package does on
its accelerator.

Precision: ``"bf16x3"`` and ``"highest"`` are plain f32 FMAs on the card.
``"bf16"`` is the storage mode: bf16 I/Q in, bf16-rounded taps, each
resampled sample rounded to bf16 before the channelizer, f32 sums.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir_band import LANE
from warmup_fir_filter_tpu_torch.kernels.fir_float import (
    FloatFir1d,
    fir_float_plain,
)
from warmup_fir_filter_tpu_torch.kernels.resample import (
    PolyphaseResampler,
    band_windows,
    build_resample_band,
)

PRECISIONS = ("bf16x3", "highest", "bf16")
#: Output lane tiles of the TPU kernel's superblock; the gate below keeps
#: the JAX package's answers, which depend on it.
FUSED_SEG_TILES = 64
#: Candidate input-halo widths (lane tiles) of the TPU kernel.
_HALO_TILE_CHOICES = (4, 8, 16, 32)


def _halo_tiles_for(ds: int, first_read: int, k_rows: int,
                    seg_in_tiles: int) -> int | None:
    """Smallest halo width (tiles) covering the resample margins, or
    None if no candidate fits this geometry."""
    for h in _HALO_TILE_CHOICES:
        halo = h * LANE
        if (2 * ds - first_read <= halo
                and first_read + k_rows + ds <= halo
                and seg_in_tiles % h == 0):
            return h
    return None


def chain_fused_supported(
    channels: int, up: int, down: int, rs_taps: int, ch_taps: int
) -> bool:
    """Whether the fused single-pass kernel covers this chain config."""
    if 128 % up or channels < 1 or 2 * channels > 256 or channels % 8:
        return False
    if ch_taps > 2 * LANE + 1:
        return False
    try:
        h_probe = np.zeros(rs_taps)
        h_probe[rs_taps // 2] = 1.0
        _, k_rows, ds, beta0, j_count = build_resample_band(
            h_probe, up, down)
    except ValueError:
        return False
    first_read = beta0 - (j_count - 1)
    if (FUSED_SEG_TILES * ds) % LANE:
        return False
    seg_in_tiles = FUSED_SEG_TILES * ds // LANE
    return _halo_tiles_for(ds, first_read, k_rows, seg_in_tiles) is not None


def _bf16_values(h: np.ndarray) -> np.ndarray:
    """``h`` rounded to f32, then to bf16 (ties to even), as f32 values."""
    t = torch.as_tensor(np.asarray(h, np.float64).astype(np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


class FusedChain(nn.Module):
    """The chain's filters prepared for kernel J on one device.

    ``resampler`` and ``channelizer`` hold the f32 taps, bf16-rounded in
    ``"bf16"`` mode; ``inv_gain`` is ``1 / (2π·k_f)`` as an f32 value.
    """

    def __init__(self, h_rs, h_ch, up: int, down: int, k_f: float, *,
                 precision: str = "bf16x3",
                 device: torch.device | str = "cpu"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if k_f <= 0:
            raise ValueError(f"k_f={k_f} must be > 0")
        self.bf16 = precision == "bf16"
        if self.bf16:
            h_rs, h_ch = _bf16_values(h_rs), _bf16_values(h_ch)
        self.resampler = PolyphaseResampler(h_rs, up, down, device)
        self.channelizer = FloatFir1d(h_ch, device)
        self.inv_gain = float(np.float32(1.0 / (2.0 * np.pi * k_f)))

    def forward(self, re: torch.Tensor, im: torch.Tensor,
                rs_bounds=None) -> torch.Tensor:
        return chain_fused(re, im, self, rs_bounds)


def _check_planes(re: torch.Tensor, im: torch.Tensor) -> None:
    for plane in (re, im):
        _build.check_rows(plane, (torch.float32, torch.bfloat16))
    if re.shape != im.shape or re.device != im.device:
        raise ValueError(f"re/im must be matching (C, T) rows, got "
                         f"{tuple(re.shape)} vs {tuple(im.shape)}")


def _bounds(rs_bounds, out_len: int) -> tuple[int, int]:
    if rs_bounds is None:
        return 0, out_len
    lo, hi = (int(v) for v in rs_bounds)
    return lo, hi


def chain_fused_plain(re: torch.Tensor, im: torch.Tensor, chain: FusedChain,
                      rs_bounds=None) -> torch.Tensor:
    """Kernel J's plain version on the planes' device, in float64.

    The staged computation on one extended range: the resampled samples
    ``q ∈ [−1 − left_c, out_len + center_c)`` through the resample band
    (zero-extended input), zeroed outside ``rs_bounds``, the channelizer's
    tri-tile bands over them, then the discriminator on
    ``[−1, out_len)``, with message 0 set to 0.
    """
    x = torch.cat([re, im], dim=0)
    if chain.bf16:
        x = x.to(torch.bfloat16)
    x = x.to(torch.float64)
    channels = re.shape[0]
    rs, fir = chain.resampler, chain.channelizer
    out_len = rs.out_len(x.shape[1])
    lo, hi = _bounds(rs_bounds, out_len)
    ch_center = fir.num_taps // 2
    ch_left = fir.num_taps - 1 - ch_center
    t0 = (-1 - ch_left) // LANE
    t1 = -(-(out_len + ch_center) // LANE)
    rs_ext = band_windows(x, rs, t0, t1 - t0)
    q = torch.arange(t0 * LANE, t1 * LANE, device=x.device)
    rs_ext = torch.where((q >= lo) & (q < hi), rs_ext, 0.0)
    if chain.bf16:
        rs_ext = rs_ext.to(torch.float32).to(torch.bfloat16).to(torch.float64)
    first = -1 - t0 * LANE  # column of the channelized sample -1
    ch = fir_float_plain(rs_ext, fir)[:, first : first + out_len + 1]
    re_ch, im_ch = ch[:channels], ch[channels:]
    re_c, im_c = re_ch[:, 1:], im_ch[:, 1:]
    re_p, im_p = re_ch[:, :-1], im_ch[:, :-1]
    out = torch.atan2(im_c * re_p - re_c * im_p,
                      re_c * re_p + im_c * im_p) * chain.inv_gain
    out[:, :1] = 0.0
    return out


def chain_fused(re: torch.Tensor, im: torch.Tensor, chain: FusedChain,
                rs_bounds=None) -> torch.Tensor:
    """Kernel J on CUDA planes; :func:`chain_fused_plain` (cast to f32) on
    CPU planes.

    ``re`` and ``im`` are matching (C, T) f32 or bf16 rows; they are read
    as bf16 in ``"bf16"`` mode and as f32 otherwise.  Raises on anything
    else, taps on another device, a failed build or a failed launch.
    Counts its launches in ``chain_fused.launches``.
    """
    _check_planes(re, im)
    if re.device.type == "cpu":
        return chain_fused_plain(re, im, chain, rs_bounds).to(torch.float32)
    _build.check_same_device(re, chain.resampler.taps, "chain taps")
    dtype = torch.bfloat16 if chain.bf16 else torch.float32
    re = re.to(dtype).contiguous()
    im = im.to(dtype).contiguous()
    rs, fir = chain.resampler, chain.channelizer
    channels, n = re.shape
    out_len = rs.out_len(n)
    lo, hi = _bounds(rs_bounds, out_len)
    y = torch.empty((channels, out_len), dtype=torch.float32, device=re.device)
    if y.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(re.device):
        code = lib.wft_chain_fused(
            re.data_ptr(), im.data_ptr(), y.data_ptr(), channels, n, out_len,
            rs.taps.data_ptr(), rs.up, rs.down, rs.center, rs.branch_len,
            rs.tap_stride, fir.taps.data_ptr(), fir.num_taps, lo, hi,
            chain.inv_gain, int(chain.bf16), _build.stream_of(re),
        )
    _build.check_launch(lib, code, "chain_fused")
    chain_fused.launches += 1
    return y


chain_fused.launches = 0


def chain_forward_fused(
    re: torch.Tensor,
    im: torch.Tensor,
    h_rs: np.ndarray,
    h_ch: np.ndarray,
    up: int,
    down: int,
    k_f: float,
    *,
    precision: str = "bf16x3",
    rs_bounds=None,
) -> torch.Tensor:
    """Run the fused chain on (C, T) I/Q rows → (C, T') message rows.

    Drop-in for the staged ``models.chain.chain_forward`` composition
    (``resample_poly`` → ``fir1d_ideal_rows_band`` → ``fm_demodulate``)
    when ``chain_fused_supported`` holds; raises otherwise.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if k_f <= 0:
        raise ValueError(f"k_f={k_f} must be > 0")
    if re.shape != im.shape or re.dim() != 2:
        raise ValueError(f"re/im must be matching (C, T) rows, got "
                         f"{tuple(re.shape)} vs {tuple(im.shape)}")
    channels = re.shape[0]
    h_rs = np.asarray(h_rs, np.float64)
    h_ch = np.asarray(h_ch, np.float64)
    if not chain_fused_supported(channels, up, down, h_rs.size, h_ch.size):
        raise ValueError("config not supported by the fused chain kernel; "
                         "use the staged path")
    chain = FusedChain(h_rs, h_ch, up, down, k_f, precision=precision,
                       device=re.device)
    return chain_fused(re, im, chain, rs_bounds)
