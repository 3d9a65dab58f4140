"""The plain reference the benchmark holds the port to.

Plain PyTorch and numpy, written from the Q-format specification
(``docs/fir1d_golden_spec.md``) and the stream's contract, and frozen here:
it imports nothing of the port, of JAX or of the JAX package, and is given
only what the harness made (samples, taps, block source), never what the
port derived from them.  It runs on whatever device its inputs are on, in
blocks of rows, after the port's state is freed.

- :func:`fir_fixed_rows`: the bit-exact Q-format FIR of uint8 rows, in
  exact int64: ``acc = Σ_k h[k]·x[n + L//2 - k]`` (zero outside the row),
  wrapped to ``acc_bits`` in two's complement, ``+ 2^(fb-1)``, arithmetic
  shift by ``fb``, saturated to ``[0, 255]``.
- :func:`stream_block_checksums`: one stream block's output from its
  predecessor's last ``L-1`` samples, and its three checksums mod 2^32.
- :func:`fir_f32_rows_f64`: the same-mode float FIR in float64, the
  yardstick of the float32 overlap-save; :func:`fir_rows_tf32` is its
  control, the taps and samples rounded to TF32 and summed in float32.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = (1 << 32) - 1
#: The odd Weyl constant of the stream's third checksum.
WEYL = 2654435761
#: Rows a pass of the int64 and float64 references holds.
ROW_BLOCK = 4096


def quantize_taps(h, coeff_bits: int, frac_bits: int) -> np.ndarray:
    """Real taps to Q-format integers: ``rint`` (ties to even), then clipped
    to the signed ``coeff_bits`` range."""
    lo, hi = -(1 << (coeff_bits - 1)), (1 << (coeff_bits - 1)) - 1
    scaled = np.rint(np.asarray(h, dtype=np.float64) * (1 << frac_bits))
    return np.clip(scaled, lo, hi).astype(np.int64)


def fixed_epilogue(acc: torch.Tensor, frac_bits: int,
                   acc_bits: int) -> torch.Tensor:
    """An exact int64 accumulator wrapped to ``acc_bits``, rounded half up
    by ``frac_bits`` and saturated to uint8."""
    if acc_bits < 63:
        sign = 1 << (acc_bits - 1)
        acc = ((acc & ((1 << acc_bits) - 1)) ^ sign) - sign
    acc = (acc + (1 << (frac_bits - 1))) >> frac_bits
    return acc.clamp_(0, 255).to(torch.uint8)


def fixed_prehaloed(ext: torch.Tensor, taps: np.ndarray, frac_bits: int,
                    acc_bits: int) -> torch.Tensor:
    """``out[j] = Σ_k taps[k]·ext[j + L-1-k]`` over rows whose halos are
    attached (``L-1-L//2`` columns on the left, ``L//2`` on the right), in
    exact int64, then :func:`fixed_epilogue`."""
    num_taps = len(taps)
    n = ext.shape[1] - (num_taps - 1)
    wide = ext.to(torch.int64)
    acc = torch.zeros((ext.shape[0], n), dtype=torch.int64, device=ext.device)
    for k, tap in enumerate(int(t) for t in taps):
        if tap:
            start = num_taps - 1 - k
            acc.add_(wide[:, start : start + n], alpha=tap)
    return fixed_epilogue(acc, frac_bits, acc_bits)


def fir_fixed_rows(x_u8: torch.Tensor, taps: np.ndarray, frac_bits: int,
                   acc_bits: int, rows: slice | None = None) -> torch.Tensor:
    """The same-mode Q-format FIR of ``x_u8[rows]`` (all rows by default),
    ``ROW_BLOCK`` rows at a time."""
    num_taps = len(taps)
    center = num_taps // 2
    left = num_taps - 1 - center
    x = x_u8 if rows is None else x_u8[rows]
    out = torch.empty_like(x)
    for r in range(0, x.shape[0], ROW_BLOCK):
        ext = torch.nn.functional.pad(x[r : r + ROW_BLOCK], (left, center))
        out[r : r + ROW_BLOCK] = fixed_prehaloed(ext, taps, frac_bits,
                                                 acc_bits)
    return out


def block_checksums(y_u8: torch.Tensor) -> np.ndarray:
    """The stream's three checksums of a ``(C, S)`` output block, as uint64
    values of uint32 residues: ``Σ y``, ``Σ y·w`` and ``Σ y·(w·WEYL mod
    2^32)`` with ``w = 1..S`` along the samples, all mod 2^32."""
    col = y_u8.to(torch.int64).sum(dim=0)
    w = torch.arange(1, col.numel() + 1, dtype=torch.int64, device=col.device)
    w_weyl = (w * WEYL) & MASK32
    sums = [int(col.sum()), int((col * w).sum()),
            int(((col * w_weyl) & MASK32).sum())]
    return np.array([s & MASK32 for s in sums], dtype=np.uint64)


def stream_block(prev_u8: torch.Tensor | None, block_u8: torch.Tensor,
                 taps: np.ndarray, frac_bits: int,
                 acc_bits: int) -> torch.Tensor:
    """A stream block's ``(C, S)`` output: the FIR over the last ``L-1``
    samples of the previous block (zeros before the first) and the block."""
    k = len(taps) - 1
    if prev_u8 is None:
        prev = torch.zeros((block_u8.shape[0], k), dtype=block_u8.dtype,
                           device=block_u8.device)
    else:
        prev = prev_u8[:, prev_u8.shape[1] - k :]
    return fixed_prehaloed(torch.cat([prev, block_u8], dim=1), taps,
                           frac_bits, acc_bits)


def stream_block_checksums(prev_u8, block_u8, taps, frac_bits,
                           acc_bits) -> np.ndarray:
    """:func:`block_checksums` of :func:`stream_block`."""
    return block_checksums(stream_block(prev_u8, block_u8, taps, frac_bits,
                                        acc_bits))


def fir_f32_rows_f64(x_ext: torch.Tensor, h) -> torch.Tensor:
    """The same-mode float FIR in float64 over rows whose halos are
    attached: ``out[j] = Σ_k h[k]·x_ext[j + L-1-k]``."""
    taps = np.asarray(h, dtype=np.float64)
    num_taps = taps.size
    n = x_ext.shape[1] - (num_taps - 1)
    out = torch.empty((x_ext.shape[0], n), dtype=torch.float64,
                      device=x_ext.device)
    for r in range(0, x_ext.shape[0], ROW_BLOCK):
        wide = x_ext[r : r + ROW_BLOCK].to(torch.float64)
        acc = torch.zeros((wide.shape[0], n), dtype=torch.float64,
                          device=x_ext.device)
        for k, tap in enumerate(taps.tolist()):
            start = num_taps - 1 - k
            acc.add_(wide[:, start : start + n], alpha=tap)
        out[r : r + ROW_BLOCK] = acc
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits, to
    nearest with ties to even (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & MASK32
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def fir_rows_tf32(x_ext: torch.Tensor, h) -> torch.Tensor:
    """The control of :func:`fir_f32_rows_f64`: the same FIR with the
    samples and taps rounded to TF32 and the products summed in float32,
    as a TF32 tensor-core path computes it."""
    taps = round_tf32(torch.as_tensor(np.asarray(h, np.float32))).tolist()
    num_taps = len(taps)
    n = x_ext.shape[1] - (num_taps - 1)
    out = torch.empty((x_ext.shape[0], n), dtype=torch.float32,
                      device=x_ext.device)
    for r in range(0, x_ext.shape[0], ROW_BLOCK):
        rounded = round_tf32(x_ext[r : r + ROW_BLOCK])
        acc = torch.zeros((rounded.shape[0], n), dtype=torch.float32,
                          device=x_ext.device)
        for k, tap in enumerate(taps):
            start = num_taps - 1 - k
            acc.add_(rounded[:, start : start + n], alpha=tap)
        out[r : r + ROW_BLOCK] = acc
    return out
