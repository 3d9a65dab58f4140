"""Stateful block-streaming FIR with checkpointable carry state.

Counterpart of ``warmup_fir_filter_tpu/ops/streaming.py:34-511``.  The
delay line is a ``(C, L-1)`` carry block processed a whole block at a
time, and the carry is the resume state.  Feeding blocks x_0, x_1, … of
width S emits blocks y_0, y_1, … such that ``concat(y_b)`` equals the
same-mode filtering of the zero-prepended stream delayed by
``center = L // 2`` samples::

    emitted[t] = y_global[t - center]      (zero-pad before t = 0)

``flush()`` pushes ``center`` zeros to emit the final tail.

- :class:`FirStreamState` saves and loads the JAX package's npz format
  (``carry`` (C, L-1) int32, ``samples_seen`` int64), so either package
  resumes the other's checkpoint.
- :meth:`Fir1DStream.process` runs the plain int32 core
  (``ops/fir1d.py::fixed_fir_prehaloed_i32``) on the stream's device: it
  is the blockwise oracle the scanned loop is held against.
- :func:`stream_scanned` runs many blocks with the carry and the
  checksums on the device and one download at the end.  On a CUDA device
  each step is the prepared kernel of ``kernels/dispatch.py``; where the
  block admits a window geometry (:func:`pick_window_split`) and the
  default emit is used, it is the windowed step: kernel D (``window_rows``)
  cuts the block into row-rich windows and kernel A filters them.  On the
  CPU each step is the plain :func:`_stream_step`.

Not ported (measured slower on the TPU, or a TPU workaround): the row
split ``rows_split > 1`` (``_stream_step_mxu_wide``, ``auto_rows_split``)
and the compiled-scan cache ``_SCAN_CACHE``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from warmup_fir_filter_tpu_torch._build import resolve_device
from warmup_fir_filter_tpu_torch.kernels.dispatch import prepare_fixed_fir
from warmup_fir_filter_tpu_torch.kernels.window_copy import (
    LANE,
    window_rows,
    window_rows_supported,
)
from warmup_fir_filter_tpu_torch.ops.fir1d import fixed_fir_prehaloed_i32
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.utils.profiling import span

#: Odd (bijective mod 2^32) Weyl constant of the third checksum.
WEYL = 2654435761
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class FirStreamState:
    """Checkpointable streaming state: the delay line + sample count."""

    carry: np.ndarray  # (C, L-1) int32 — last L-1 input samples
    samples_seen: int

    def save(self, path: Path) -> None:
        np.savez(path, carry=self.carry,
                 samples_seen=np.int64(self.samples_seen))

    @classmethod
    def load(cls, path: Path) -> "FirStreamState":
        data = np.load(path)
        return cls(
            carry=np.asarray(data["carry"], np.int32),
            samples_seen=int(data["samples_seen"]),
        )


class Fir1DStream:
    """Block-streaming bit-exact fixed-point FIR over C channels on one
    device (``set_taps``/``process``/``reset``/``flush``).

    Runs on the card unless ``device="cpu"`` asks for the host: without
    CUDA the default raises, as :func:`resolve_device` does; nothing falls
    back to the CPU.
    """

    def __init__(self, h, channels: int, qformat: QFormat = QFormat(),
                 device: torch.device | str = "cuda"):
        if not qformat.tpu_native:
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 is not representable in "
                "the int32 sim path."
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.qformat = qformat
        self.channels = int(channels)
        self.set_taps(h)

    def set_taps(self, h) -> None:
        self._h_raw = np.asarray(h, np.float64)
        self._h_fixed = self.qformat.quantize_coeffs(h).astype(np.int32)
        self.num_taps = int(self._h_fixed.size)
        self.center = self.num_taps // 2
        self._prepared = None
        self.reset()

    def reset(self) -> None:
        """Zero the delay line."""
        self.state = FirStreamState(
            carry=np.zeros((self.channels, self.num_taps - 1), np.int32),
            samples_seen=0,
        )

    def prepared(self) -> torch.nn.Module:
        """The filter prepared for its kernel on the stream's device, once."""
        if self._prepared is None:
            self._prepared = prepare_fixed_fir(self._h_raw, self.qformat,
                                               self.device)
        return self._prepared

    def process(self, x_block) -> np.ndarray:
        """Feed a (C, S) uint8 block; returns the (C, S) uint8 output."""
        x = np.asarray(x_block)
        if x.shape[0] != self.channels:
            raise ValueError(
                f"Expected {self.channels} channels, got {x.shape[0]}."
            )
        y, new_carry = _stream_step(
            torch.from_numpy(x.astype(np.int32)).to(self.device),
            torch.from_numpy(self.state.carry).to(self.device),
            [int(v) for v in self._h_fixed],
            self.num_taps,
            self.qformat.frac_bits,
            self.qformat.acc_bits,
        )
        self.state = FirStreamState(
            carry=new_carry.cpu().numpy().astype(np.int32),
            samples_seen=self.state.samples_seen + x.shape[1],
        )
        return y.cpu().numpy()

    def flush(self) -> np.ndarray:
        """Emit the final ``center`` outputs by pushing zeros."""
        if self.center == 0:
            return np.zeros((self.channels, 0), np.uint8)
        return self.process(np.zeros((self.channels, self.center), np.uint8))


def _carry_after(x_i32: torch.Tensor, carry_i32: torch.Tensor,
                 num_taps: int) -> torch.Tensor:
    """The last ``L-1`` samples of ``carry ‖ x``, as a new int32 tensor."""
    k = num_taps - 1
    if k == 0:
        return carry_i32
    if x_i32.shape[1] >= k:
        return x_i32[:, -k:].to(torch.int32, copy=True)
    return torch.cat([carry_i32, x_i32.to(torch.int32)], dim=1)[:, -k:].clone()


def _stream_step(x_i32, carry_i32, h_fixed: list[int], num_taps: int,
                 frac_bits: int, acc_bits: int):
    """Plain int32 step: the pre-haloed core over ``carry ‖ x``."""
    if num_taps > 1:
        ext = torch.cat([carry_i32, x_i32], dim=1)
    else:
        ext = x_i32
    y = fixed_fir_prehaloed_i32(ext, h_fixed, num_taps, frac_bits, acc_bits)
    return y, _carry_after(x_i32, carry_i32, num_taps)


def _stream_step_mxu(x_u8, carry_i32, fir: torch.nn.Module, num_taps: int):
    """Kernel step, bit-identical to :func:`_stream_step`.

    The same-mode kernel over the carry-extended block computes, on its
    interior columns, exactly the pre-haloed outputs (out[left + j] reads
    only in-bounds samples, so the zero pad never contributes), so the
    slice ``[left : left + S]`` is the delay-line contract.
    """
    left = num_taps - 1 - num_taps // 2
    if num_taps > 1:
        ext = torch.cat([carry_i32.to(torch.uint8), x_u8], dim=1)
    else:
        ext = x_u8.contiguous()
    y = fir(ext)
    return y[:, left : left + x_u8.shape[1]], _carry_after(x_u8, carry_i32,
                                                           num_taps)


def default_emit_checksums(y: torch.Tensor) -> torch.Tensor:
    """Order-sensitive block checksums: three residues mod 2^32, as int64.

    ``[Σy, Σ y·w, Σ y·(w·φ mod 2^32)]`` with ``w = 1..S`` along the last
    axis and ``φ`` = :data:`WEYL`, as ``streaming.py:217-234``.  torch has
    no wrapping uint32, so the sums run in int64 over the column sums
    ``Σ_c y[c, s]``: each product is masked to 32 bits before its sum,
    which stays below 2^63 for any S < 2^31, and each sum is masked after
    it.  The unmasked products of a 4M-sample block would overflow int64.
    """
    return _weighted_sums(_column_sums(y.reshape(-1, y.shape[-1]), dim=0),
                          _checksum_weights(y.shape[-1], y.device))


def _column_sums(y: torch.Tensor, dim: int) -> torch.Tensor:
    """``y`` summed over ``dim``, as int64.

    ``sum`` first casts its input to the result type, so uint8 samples are
    summed in the narrowest type that holds the sum exactly: over 16
    channels int16 moves a quarter of int64's bytes.
    """
    if y.dtype == torch.uint8:
        bound = 255 * y.shape[dim]
        dtype = (torch.int16 if bound < 2**15 else
                 torch.int32 if bound < 2**31 else torch.int64)
    else:
        dtype = torch.int64
    return y.sum(dim=dim, dtype=dtype).to(torch.int64)


def _checksum_weights(n: int, device: torch.device) -> torch.Tensor:
    """``(3, n)`` int64 rows ``1``, ``w`` and ``w·φ mod 2^32`` for
    ``w = 1..n``; a scan builds them once."""
    w = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    return torch.stack([torch.ones_like(w), w, (w * WEYL) & MASK32])


def _weighted_sums(colsum: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The three checksums of column sums ``colsum[t]`` with the rows of
    :func:`_checksum_weights`."""
    return ((colsum * weights) & MASK32).sum(dim=1) & MASK32


def host_emit_checksums(y) -> np.ndarray:
    """Numpy mirror of :func:`default_emit_checksums` (uint64 values
    of the three uint32 residues) for host-side cross-checks."""
    yu = np.asarray(y, np.uint64)
    w = np.arange(1, yu.shape[-1] + 1, dtype=np.uint64)
    mod = np.uint64(1) << np.uint64(32)
    w2 = (w * np.uint64(WEYL)) % mod
    return np.array([
        yu.sum() % mod,
        (yu * w).sum() % mod,
        (yu * w2).sum() % mod,
    ], np.uint64)


def pick_window_split(channels: int, width: int,
                      num_taps: int) -> tuple[int, int] | None:
    """Geometry (sub, g_windows) for the windowed scan, or None.

    Picks the lane-aligned sub-row width whose window count makes the
    band FIR row-rich (64 ≤ C·R ≤ 8192, sub ≥ max(512, 4·L)); the window
    group is the largest divisor of R ≤ 16 (``streaming.py:262-296``).
    """
    if width % LANE or num_taps > 129:
        return None
    min_sub = max(512, 4 * num_taps)
    best = None
    spt_total = width // LANE
    for spt in range(min_sub // LANE, spt_total + 1):
        if spt_total % spt:
            continue
        sub = spt * LANE
        r = width // sub
        rows = channels * r
        if rows < 64 or rows > 8192:
            continue
        if not window_rows_supported(channels, width, sub, num_taps):
            continue
        if best is None or rows > best[2]:
            g = 1
            for cand in range(min(16, r), 0, -1):
                if r % cand == 0:
                    g = cand
                    break
            best = (sub, g, rows)
    return (best[0], best[1]) if best else None


def _stream_step_windowed(x_u8, carry_i32, fir: torch.nn.Module,
                          num_taps: int, sub: int, g_windows: int):
    """Windowed step: kernel D builds overlapping ``(R·C, sub+256)`` rows,
    the band kernel filters them row-rich.

    The outputs stay window-major; :func:`_emit_windowed_checksums`
    re-indexes them.  Checksum-equal to the unsplit step.
    """
    channels = x_u8.shape[0]
    carry_ext = torch.zeros((channels, LANE), dtype=torch.uint8,
                            device=x_u8.device)
    if num_taps > 1:
        carry_ext[:, LANE - (num_taps - 1):] = carry_i32.to(torch.uint8)
    win = window_rows(x_u8, carry_ext, sub, g_windows)
    return fir(win), _carry_after(x_u8, carry_i32, num_taps)


def _emit_windowed_checksums(y_win: torch.Tensor, channels: int, sub: int,
                             num_taps: int) -> torch.Tensor:
    """:func:`default_emit_checksums` re-indexed for window-major rows.

    Window col ``p`` of window ``r`` is emitted sample
    ``t = r·sub + p − 128 + center``, valid for
    ``p ∈ [128−center, 128−center+sub)`` (``streaming.py:340-363``), so
    the valid columns of the windows, summed over channels, are the
    column sums of the (C, S) block in order.
    """
    colsum = _windowed_column_sums(y_win, channels, sub, num_taps)
    return _weighted_sums(colsum, _checksum_weights(colsum.numel(),
                                                    colsum.device))


def _windowed_column_sums(y_win: torch.Tensor, channels: int, sub: int,
                          num_taps: int) -> torch.Tensor:
    """The (C, S) block's column sums from its window-major outputs."""
    lo = LANE - num_taps // 2
    windows = y_win.shape[0] // channels
    valid = y_win.view(windows, channels, -1)[:, :, lo : lo + sub]
    return _column_sums(valid, dim=1).reshape(-1)


def stream_scanned(
    stream: Fir1DStream,
    block_fn,
    num_blocks: int,
    *,
    emit_fn=None,
    start_block: int = 0,
    rows_split: int | str | None = None,
):
    """Run ``num_blocks`` streaming steps with the state on the device.

    ``block_fn(b)`` takes a Python int and returns block ``b`` as a
    ``(C, S)`` uint8 tensor on the stream's device.  It is called once for
    ``start_block`` to learn the shape, and that result is the first
    block.  The carry stays a device tensor and the default emit writes
    its three checksums into a preallocated device tensor: no step reads
    the device, and one download at the end returns the checksums and the
    carry.  The stream's state is updated exactly as if the blocks had been
    fed one by one, so a second call resumed from a saved
    :class:`FirStreamState` continues bit-identically.

    ``rows_split``: None, ``"auto"`` or a positive int run the default
    step, as the JAX function does off its accelerator: its row split is
    a TPU layout whose results are bit-identical across splits, so every
    split gives the same checksums and carry here.  ``"pallas"`` forces
    the windowed step (default emit only).  Anything else raises
    ValueError.

    Returns the emitted values, leading axis ``num_blocks``: for the
    default emit a numpy uint32 ``(num_blocks, 3)`` array.

    Under a profiler each block after ``block_fn`` is one ``stream.block``
    span holding one ``stream.checksum`` span around its checksums or emit
    (``utils/profiling.py::span``).
    """
    if not (rows_split in (None, "auto", "pallas")
            or (isinstance(rows_split, int) and not isinstance(rows_split, bool)
                and rows_split >= 1)):
        raise ValueError(f"rows_split must be None, 'auto', 'pallas' or a "
                         f"positive int, got {rows_split!r}")
    num_taps = stream.num_taps
    qf = stream.qformat
    device = stream.device
    default_emit = emit_fn is None or emit_fn is default_emit_checksums
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be at least 1, got {num_blocks}")

    def block(b: int) -> torch.Tensor:
        x = block_fn(b)
        if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8 \
                or x.dim() != 2:
            raise TypeError("block_fn must return a (C, S) uint8 tensor")
        if x.device != device:
            raise ValueError(f"block on {x.device}, stream on {device}")
        if x.shape[0] != stream.channels:
            raise ValueError(f"Expected {stream.channels} channels, got "
                             f"{x.shape[0]}.")
        return x

    first = block(start_block)
    channels, width = first.shape
    window_geom = None
    if rows_split == "pallas":
        if not default_emit:
            raise ValueError(
                "rows_split='pallas' supports only the default emit "
                "(the windowed layout re-indexing is built into it)")
        window_geom = pick_window_split(channels, width, num_taps)
        if window_geom is None:
            raise ValueError(
                f"no windowed-scan geometry for shape ({channels}, "
                f"{width}) at {num_taps} taps")
    elif device.type == "cuda" and default_emit:
        window_geom = pick_window_split(channels, width, num_taps)
    use_kernels = device.type == "cuda" or window_geom is not None
    fir = stream.prepared() if use_kernels else None
    h_fixed = [int(v) for v in stream._h_fixed]

    carry = torch.from_numpy(stream.state.carry).to(device)
    if default_emit:
        sums = torch.empty((num_blocks, 3), dtype=torch.int64, device=device)
        weights = _checksum_weights(width, device)
    emitted = []
    x = first
    for i in range(num_blocks):
        if i:
            x = block(start_block + i)
            if tuple(x.shape) != (channels, width):
                raise ValueError(f"block {start_block + i} has shape "
                                 f"{tuple(x.shape)}, expected "
                                 f"{(channels, width)}")
        with span("stream.block"):
            if window_geom is not None:
                y_win, carry = _stream_step_windowed(x, carry, fir, num_taps,
                                                     *window_geom)
                with span("stream.checksum"):
                    sums[i] = _weighted_sums(_windowed_column_sums(
                        y_win, channels, window_geom[0], num_taps), weights)
                continue
            if use_kernels:
                y, carry = _stream_step_mxu(x, carry, fir, num_taps)
            else:
                y, carry = _stream_step(x.to(torch.int32), carry, h_fixed,
                                        num_taps, qf.frac_bits, qf.acc_bits)
            with span("stream.checksum"):
                if default_emit:
                    sums[i] = _weighted_sums(_column_sums(y, dim=0), weights)
                else:
                    emitted.append(emit_fn(y))

    if default_emit:
        flat = torch.cat([sums.reshape(-1),
                          carry.reshape(-1).to(torch.int64)]).cpu().numpy()
        result = flat[: 3 * num_blocks].astype(np.uint32).reshape(num_blocks, 3)
        carry_np = flat[3 * num_blocks :].astype(np.int32)
    else:
        result = torch.stack(emitted).cpu().numpy()
        carry_np = carry.cpu().numpy().astype(np.int32)
    stream.state = FirStreamState(
        carry=carry_np.reshape(channels, num_taps - 1),
        samples_seen=stream.state.samples_seen + num_blocks * width,
    )
    return result
