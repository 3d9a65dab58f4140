"""Kernel I: the float32 polyphase P/Q resampler over (C, T) rows (ports K10).

Counterpart of ``warmup_fir_filter_tpu/kernels/resample_mxu.py``.  The
contract is ``ops/resample.py``'s: output ``m`` is
``Σ_j h[r_m + P·j] · x[b_m − j]`` with ``x`` zero outside ``[0, T)``, for
the ``ceil(T·P/Q)`` outputs.  The TPU kernels (``:96``, ``:129``,
``:196``) compute output tile ``t`` (128 outputs) as the input window
starting at ``t·ds + β0 − (J−1)``, ``ds = 128·Q/P``, times the
tile-independent band of :func:`build_resample_band`, which needs
``P | 128``; the plain version does just that.

:class:`PolyphaseResampler` holds the (P, J) branch taps for the kernel
and the band for the plain version as buffers.  :func:`resample` launches
``csrc/resample.cu`` on a CUDA tensor and runs :func:`resample_plain` on a
CPU tensor.  :func:`resample_poly_band` is the entry point with the JAX
function's signature (``resample_poly_mxu``, ``:387``, minus its TPU
knobs ``block_rows``, ``max_out_tiles``, ``group`` and ``unroll``).  Any
branch length J is taken: the JAX windowed fallback for long branches
(``:411-416``) is a VMEM limit, not a second contract.  ``"bf16x3"`` and
``"highest"`` both compute plain f32 FMAs on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir_band import LANE
from warmup_fir_filter_tpu_torch.ops.resample import _plan, _polyphase_taps

PRECISIONS = ("bf16x3", "highest")


def build_resample_band(
    h: np.ndarray, up: int, down: int
) -> tuple[np.ndarray, int, int, int, int]:
    """Tile-independent resampling band matrix (``resample_mxu.py:55-93``).

    Returns ``(A, K, ds, beta0, J)``: the (K, 128) float32 band with
    ``A[db_i + (J−1) − j, i] = taps[r_i, j]``, its row count, the per-tile
    input stride ``ds = 128·Q/P``, ``β_0`` (the input anchor of output 0)
    and the branch length J.  Requires ``P | 128``.
    """
    if 128 % up:
        raise ValueError(
            f"MXU resample band needs up | 128 (tile-periodic), got up={up}."
        )
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    center = num_taps // 2
    taps = _polyphase_taps(h64, up)  # (P, J)
    j_count = taps.shape[1]
    i = np.arange(LANE)
    u = i * down + center
    r_i = u % up
    beta = (u - r_i) // up
    db = beta - beta[0]
    k_rows = int(db[-1]) + j_count
    a = np.zeros((k_rows, LANE), np.float32)
    # Column i holds branch r_i's taps at rows db_i + (J-1) - j: one
    # scatter for all columns (the JAX package loops over them).
    rows = db[:, None] + (j_count - 1) - np.arange(j_count)[None, :]
    a[rows, i[:, None]] = taps[r_i]
    ds = 128 * down // up
    return a, k_rows, ds, int(beta[0]), j_count


class PolyphaseResampler(nn.Module):
    """A P/Q resampler prepared for kernel I on one device.

    Buffers: ``taps``, the (P, tap_stride) f32 branch taps
    ``taps[r, j] = h[r + P·j]`` (zero past J; the stride is odd, so that
    threads on different branches read different shared-memory banks),
    and ``band``, :func:`build_resample_band`'s f32 band of the same taps.
    """

    def __init__(self, h, up: int, down: int,
                 device: torch.device | str = "cpu"):
        super().__init__()
        h32 = np.asarray(h, dtype=np.float64).astype(np.float32)
        _plan(1, up, down, h32.size)  # validates up, down
        band, self.k_rows, self.ds, self.beta0, self.branch_len = \
            build_resample_band(h32, up, down)
        self.up, self.down = up, down
        self.center = h32.size // 2
        self.tap_stride = self.branch_len | 1
        table = np.zeros((up, self.tap_stride), np.float32)
        table[:, : self.branch_len] = _polyphase_taps(h32, up)
        self.register_buffer("taps", torch.as_tensor(table, device=device))
        self.register_buffer("band", torch.as_tensor(band, device=device))

    def out_len(self, n: int) -> int:
        return -(-n * self.up // self.down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resample(x, self)


def band_windows(x64: torch.Tensor, rs: PolyphaseResampler, t0: int,
                 tiles: int) -> torch.Tensor:
    """The resampled tiles ``t0 .. t0 + tiles - 1`` (any integers) of
    float64 rows: the window at ``t·ds + β0 − (J−1)`` of the zero-extended
    rows times the band.  Returns ``(C, tiles·128)`` float64."""
    first = t0 * rs.ds + rs.beta0 - (rs.branch_len - 1)
    last = first + (tiles - 1) * rs.ds + rs.k_rows  # one past the last read
    n = x64.shape[1]
    pad_l, pad_r = max(0, -first), max(0, last - n)
    xp = F.pad(x64, (pad_l, pad_r))[:, first + pad_l : last + pad_l]
    windows = xp.unfold(1, rs.k_rows, rs.ds)[:, :tiles]
    band = rs.band.to(device=x64.device, dtype=torch.float64)
    return (windows @ band).reshape(x64.shape[0], tiles * LANE)


def resample_plain(x: torch.Tensor, rs: PolyphaseResampler) -> torch.Tensor:
    """Kernel I's plain version on ``x.device``, in float64."""
    out_len = rs.out_len(x.shape[1])
    tiles = -(-out_len // LANE)
    return band_windows(x.to(torch.float64), rs, 0, tiles)[:, :out_len]


def resample(x: torch.Tensor, rs: PolyphaseResampler) -> torch.Tensor:
    """Kernel I on a CUDA tensor; :func:`resample_plain` (cast to f32) on a
    CPU tensor.

    ``x`` is (C, T) f32.  Raises on anything else, a non-contiguous CUDA
    tensor, taps on another device, a failed build or a failed launch.
    Counts its launches in ``resample.launches``.
    """
    _build.check_rows(x, (torch.float32,))
    if x.device.type == "cpu":
        return resample_plain(x, rs).to(torch.float32)
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    _build.check_same_device(x, rs.taps, "resampler taps")
    channels, n = x.shape
    out_len = rs.out_len(n)
    y = torch.empty((channels, out_len), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.wft_resample(
            x.data_ptr(), y.data_ptr(), channels, n, out_len,
            rs.taps.data_ptr(), rs.up, rs.down, rs.center, rs.branch_len,
            rs.tap_stride, _build.stream_of(x),
        )
    _build.check_launch(lib, code, "resample")
    resample.launches += 1
    return y


resample.launches = 0


def resample_poly_band(x: torch.Tensor, h, up: int, down: int, *,
                       precision: str = "bf16x3") -> torch.Tensor:
    """Float32 polyphase resampler over (C, T) rows on ``x.device``.

    Same rate-change contract as ``ops.resample.resample_poly``; kernel I
    (or its plain version on a CPU tensor).  Requires ``128 % up == 0``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    rs = PolyphaseResampler(h, up, down, x.device)
    return resample(x.to(torch.float32).contiguous(), rs)


def resample_poly_mxu(x: torch.Tensor, h, up: int, down: int, *,
                      precision: str = "bf16x3") -> torch.Tensor:
    """The JAX ``resample_mxu.py::resample_poly_mxu`` entry (its TPU
    blocking knobs dropped): :func:`resample_poly_band`, kernel I."""
    return resample_poly_band(x, h, up, down, precision=precision)
