"""Polyphase rational resampling (the DSP chain's resample stage).

Counterpart of ``warmup_fir_filter_tpu/ops/resample.py``.  Rational rate
change by P/Q (upsample P, anti-alias low-pass, downsample Q) in true
polyphase form: with the same-mode centre ``c = L // 2``,

    y[m] = Σ_j h[r_m + P·j] · x[b_m − j]
    r_m  = (m·Q + c) mod P            (polyphase branch)
    b_m  = (m·Q + c − r_m) / P        (input anchor)

over every ``m`` with ``m·Q < N·P``, so the output length is
``ceil(N·P / Q)``; ``x`` is zero outside ``[0, N)``.

- The numpy functions (:func:`design_lowpass`, :func:`_plan`,
  :func:`_polyphase_taps`, :func:`_phase_plan`,
  :func:`resample_poly_golden`, :func:`resample_poly_fixed_golden`) are
  copies of the JAX package's (``:43-143``).
- :func:`resample_poly` runs on the input tensor's device: ``"exact"`` is
  the torch port of the JAX package's slice path (``:146-202``, not a
  kernel there either); ``"auto"`` on a CUDA tensor with ``128 % up == 0``
  runs kernel I (``kernels/resample.py``), as the JAX package picks its
  MXU kernel on the TPU (``:222-227``), and the exact path otherwise.
- :func:`resample_poly_fixed` is the bit-exact fixed-point path: int64
  sums wrapped to int32 as the JAX package's int32 ones wrap, then the
  port's epilogue (``ops/fir1d.py``).
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fir1d import (
    fixed_epilogue_i32,
    require_int32_format,
)
from warmup_fir_filter_tpu_torch.ops.qformat import (
    QFormat,
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)

PRECISIONS = ("auto", "exact", "bf16x3", "highest")


def design_lowpass(num_taps: int, cutoff: float, *, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc low-pass (Hamming), normalized to ``gain`` at DC.

    ``cutoff`` is the normalized frequency in (0, 1) relative to Nyquist.
    Standard textbook design (parity with scipy.signal.firwin semantics).
    """
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff={cutoff} must be in (0, 1)")
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    window = 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(num_taps) / (num_taps - 1)
    )
    h *= window
    return h * (gain / h.sum())


def _plan(n: int, up: int, down: int, num_taps: int):
    """Per-output (branch, anchor) index plan, host-side numpy."""
    if up < 1 or down < 1:
        raise ValueError(f"up={up} and down={down} must be >= 1")
    if gcd(up, down) != 1:
        raise ValueError(f"up={up} and down={down} must be coprime")
    center = num_taps // 2
    m = np.arange(-(-n * up // down))  # ceil(N·P / Q) outputs
    u = m * down + center
    branch = u % up
    anchor = (u - branch) // up
    return m.size, branch, anchor, center


def _polyphase_taps(h: np.ndarray, up: int) -> np.ndarray:
    """(P, J) branch taps: ``taps[r, j] = h[r + P·j]`` (zero-padded)."""
    num_taps = h.shape[0]
    branches = -(-num_taps // up)
    padded = np.zeros(up * branches, h.dtype)
    padded[:num_taps] = h
    return padded.reshape(branches, up).T.copy()


def resample_poly_golden(
    x, h, up: int, down: int
) -> np.ndarray:
    """Float64 host oracle over (C, T) rows."""
    x64 = np.asarray(x, np.float64)
    h64 = np.asarray(h, np.float64)
    channels, n = x64.shape
    out_len, branch, anchor, _ = _plan(n, up, down, h64.size)
    taps = _polyphase_taps(h64, up)  # (P, J)
    num_branches = taps.shape[1]
    y = np.zeros((channels, out_len), np.float64)
    # Same float64 accumulation order as the golden FIR: ascending j.
    xp = np.pad(x64, ((0, 0), (num_branches, num_branches)))
    for j in range(num_branches):
        idx = anchor - j + num_branches  # in-bounds via padding
        idx = np.clip(idx, 0, xp.shape[1] - 1)
        valid = ((anchor - j) >= 0) & ((anchor - j) < n)
        y += np.where(valid, taps[branch, j] * xp[:, idx], 0.0)
    return y


def resample_poly_fixed_golden(
    x_u8, h, up: int, down: int, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-accurate fixed-point resampler (trusted host oracle)."""
    x64 = np.asarray(x_u8, np.int64)
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    channels, n = x64.shape
    out_len, branch, anchor, _ = _plan(n, up, down, h_fixed.size)
    taps = _polyphase_taps(h_fixed, up)
    num_branches = taps.shape[1]
    acc = np.zeros((channels, out_len), np.int64)
    xp = np.pad(x64, ((0, 0), (num_branches, num_branches)))
    for j in range(num_branches):
        idx = anchor - j + num_branches
        idx = np.clip(idx, 0, xp.shape[1] - 1)
        valid = ((anchor - j) >= 0) & ((anchor - j) < n)
        acc += np.where(valid, taps[branch, j] * xp[:, idx], 0)
    acc = wrap_to_acc_bits_np(acc, qformat.acc_bits)
    return saturate_pixel_np(bias_round_shift_np(acc, qformat.frac_bits))


def _phase_plan(up: int, down: int, center: int, out_len: int):
    """Static per-phase decomposition of the output stream.

    Outputs split into ``P = up`` interleaved phases: phase ``t`` holds
    the outputs ``m ≡ t (mod P)``, whose polyphase branch is constant
    (``r_t = (t·Q + c) mod P``) and whose input anchor is affine
    (``a0_t + Q·k`` for the k-th output of the phase).  This turns the
    per-output gather formulation into **strided slices** — TPU gathers
    over megasample index vectors measured ~60× off the roofline (see
    docs/architecture.md), strided ``lax.slice`` is a plain DMA pattern.
    """
    plan = []
    for t in range(up):
        u = t * down + center
        r = u % up
        a0 = (u - r) // up
        count = -(-max(out_len - t, 0) // up)  # outputs m = t, t+P, ...
        plan.append((r, a0, count))
    return tuple(plan)


def _poly_core(xp: torch.Tensor, taps: list, plan, down: int,
               num_branches: int, pad_left: int) -> torch.Tensor:
    """Polyphase accumulation over padded rows, in ``xp``'s dtype.

    The JAX package's slice path (``ops/resample.py:146-190``): the padded
    rows split once into their Q downsample phases, then every tap of a
    phase adds one contiguous slice, in ascending j.  The pad zeros give
    the contract's zero contributions.  ``taps`` are the (P, J) branch
    taps as nested lists of Python numbers, so each product runs in
    ``xp``'s dtype.  Returns the phase-interleaved ``(C, max_count·P)``
    sums; callers crop to ``out_len``.
    """
    channels = xp.shape[0]
    max_count = max(count for _, _, count in plan)
    total_q = -(-xp.shape[1] // down)
    xp = F.pad(xp, (0, total_q * down - xp.shape[1]))
    xq = [xp[:, q::down] for q in range(down)]
    phases = []
    for r, a0, _ in plan:
        acc = torch.zeros((channels, max_count), dtype=xp.dtype,
                          device=xp.device)
        for j in range(num_branches):
            tap = taps[r][j]
            if tap == 0:
                continue
            start = pad_left + a0 - j
            q, k0 = start % down, start // down
            acc = acc + tap * xq[q][:, k0 : k0 + max_count]
        phases.append(acc)
    return torch.stack(phases, dim=-1).reshape(channels, max_count * len(plan))


def _exact_resample(x: torch.Tensor, h64: np.ndarray, up: int,
                    down: int) -> torch.Tensor:
    """The f32 slice path on ``x.device``."""
    x = x.to(torch.float32)
    out_len, _, _, center = _plan(int(x.shape[1]), up, down, h64.size)
    taps = _polyphase_taps(h64, up).astype(np.float32)  # f32 values
    plan = _phase_plan(up, down, center, out_len)
    num_branches = taps.shape[1]
    pad_right = down * max(count for _, _, count in plan) + num_branches
    xp = F.pad(x, (num_branches, pad_right))
    out = _poly_core(xp, taps.tolist(), plan, down, num_branches,
                     num_branches)
    return out[:, :out_len]


def resample_poly(
    x: torch.Tensor, h, up: int, down: int, *, precision: str = "auto"
) -> torch.Tensor:
    """Float32 polyphase resampler over (C, T) rows on ``x.device``.

    ``precision`` selects the path, with the JAX package's names:

    - ``"auto"`` (default): kernel I on a CUDA tensor when ``128 % up ==
      0``; the exact slice path otherwise;
    - ``"exact"``: the slice path (f32, ascending-j accumulation);
    - ``"bf16x3"`` / ``"highest"``: kernel I (its plain version on a CPU
      tensor).  Both compute plain f32 FMAs on the card, which has native
      f32: the TPU's bf16 operand split has no counterpart.

    A host array goes to the card (``_build.as_rows``).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    x = _build.as_rows(x)
    if precision == "auto":
        precision = ("highest" if x.device.type == "cuda" and 128 % up == 0
                     else "exact")
    h64 = np.asarray(h, np.float64)
    if precision != "exact":
        from warmup_fir_filter_tpu_torch.kernels.resample import (
            resample_poly_band,
        )

        return resample_poly_band(x, h64, up, down, precision=precision)
    return _exact_resample(x, h64, up, down)


def resample_poly_fixed(
    x_u8: torch.Tensor, h, up: int, down: int, qformat: QFormat = QFormat()
) -> torch.Tensor:
    """Bit-exact fixed-point polyphase resampler on ``x_u8.device`` (a host
    array goes to the card, ``_build.as_rows``)."""
    require_int32_format(qformat)
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    x = _build.as_rows(x_u8, torch.int64)
    out_len, _, _, center = _plan(int(x.shape[1]), up, down, h_fixed.size)
    taps = _polyphase_taps(h_fixed, up)
    plan = _phase_plan(up, down, center, out_len)
    num_branches = taps.shape[1]
    pad_right = down * max(count for _, _, count in plan) + num_branches
    xp = F.pad(x, (num_branches, pad_right))
    acc = _poly_core(xp, taps.tolist(), plan, down, num_branches,
                     num_branches)[:, :out_len]
    # The int32 sums of the JAX path wrap mod 2^32.
    acc = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return fixed_epilogue_i32(acc, qformat.frac_bits, qformat.acc_bits)
