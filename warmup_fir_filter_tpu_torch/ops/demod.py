"""FM demodulation (the DSP chain's final stage).

Counterpart of ``warmup_fir_filter_tpu/ops/demod.py``.  Quadrature
(polar-discriminator) FM demod over complex baseband rows carried as
split I/Q float planes:

    y[n] = angle( x[n] · conj(x[n-1]) ) / (2π · k_f)

with ``x[-1]`` taken as ``x[0]``, so output 0 of each row is 0.
:func:`fm_modulate` and :func:`fm_demodulate_golden` are numpy copies of
the JAX package's (``:23-30``, ``:57-67``); :func:`fm_demodulate` is f32
torch elementwise on the tensors' device (the JAX package has no kernel
here either).
"""

from __future__ import annotations

import numpy as np
import torch


def fm_modulate(message: np.ndarray, k_f: float) -> tuple[np.ndarray, np.ndarray]:
    """Test-signal generator: message rows → complex baseband I/Q rows.

    ``phase[n] = 2π·k_f·Σ_{m≤n} message[m]`` (host-side, float64).
    """
    msg = np.asarray(message, np.float64)
    phase = 2.0 * np.pi * k_f * np.cumsum(msg, axis=-1)
    return np.cos(phase), np.sin(phase)


def fm_demodulate(re: torch.Tensor, im: torch.Tensor,
                  k_f: float) -> torch.Tensor:
    """Demodulate complex baseband rows; returns f32 message estimate rows.

    First output sample of each row is 0 (no previous sample).
    """
    if k_f <= 0:
        raise ValueError(f"k_f={k_f} must be > 0")
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    # x[n] · conj(x[n-1]) with x[-1] treated as x[0] (zero first output).
    re_prev = torch.cat([re[:, :1], re[:, :-1]], dim=1)
    im_prev = torch.cat([im[:, :1], im[:, :-1]], dim=1)
    dot = re * re_prev + im * im_prev
    cross = im * re_prev - re * im_prev
    return torch.atan2(cross, dot) * float(np.float32(1.0 / (2.0 * np.pi * k_f)))


def fm_demodulate_golden(re, im, k_f: float) -> np.ndarray:
    """Float64 host oracle of the same discriminator."""
    if k_f <= 0:
        raise ValueError(f"k_f={k_f} must be > 0")
    re = np.asarray(re, np.float64)
    im = np.asarray(im, np.float64)
    re_prev = np.concatenate([re[:, :1], re[:, :-1]], axis=1)
    im_prev = np.concatenate([im[:, :1], im[:, :-1]], axis=1)
    dot = re * re_prev + im * im_prev
    cross = im * re_prev - re * im_prev
    return np.arctan2(cross, dot) / (2.0 * np.pi * k_f)
