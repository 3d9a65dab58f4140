"""FFT overlap-save filtering on ``torch.fft``: the chain's ``"jnp"`` channelizer.

Counterpart of ``warmup_fir_filter_tpu/ops/fftfilt.py`` (``:28-126``).
The float FFT path is a *model*: its agreement with the direct paths is
an SNR bound, not bit-equality.  The framework-wide same-mode contract
``y[n] = Σ_k h[k] · x[n - k + center]`` is kept by reading each
length-``nfft`` segment starting at ``n0 - (L - 1) + center`` in the
zero-padded stream and discarding the first ``L - 1`` circular outputs.

The transforms here are ``torch.fft``'s on either device.  The port's own
FFT kernels (K, L and M, the counterparts of the JAX package's Pallas FFT
kernels K12-K14) and the chain's ``"pallas"`` channelizer live in
``kernels/fft.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch.ops.qformat import QFormat


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pick_nfft(num_taps: int) -> int:
    """Block size heuristic: ≥8× taps keeps discard overhead ≤ ~12%."""
    return max(256, _next_pow2(8 * num_taps))


def frame_overlap(xp: torch.Tensor, nfft: int, step: int,
                  num_blocks: int) -> torch.Tensor:
    """(C, T) → (C, num_blocks, nfft) overlapping frames, hop ``step``.

    The stream is cut into ``step``-sized hops with a reshape and each
    frame is the concatenation of ``ceil(nfft/step)`` consecutive hops.
    """
    channels = xp.shape[0]
    m = -(-nfft // step)  # hops spanned by one frame
    total = (num_blocks + m) * step
    xp = F.pad(xp, (0, total - xp.shape[1]))
    hops = xp.reshape(channels, num_blocks + m, step)
    parts = [hops[:, i : i + num_blocks, :] for i in range(m)]
    return torch.cat(parts, dim=-1)[:, :, :nfft]


def fir_overlap_save(x: torch.Tensor, h, *,
                     nfft: int | None = None) -> torch.Tensor:
    """Float32 same-mode FIR via FFT overlap-save over (C, T) rows."""
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    nfft = pick_nfft(num_taps) if nfft is None else nfft
    if nfft < num_taps:
        raise ValueError(f"nfft={nfft} must be >= num_taps={num_taps}")
    x_f32 = x.to(torch.float32)
    channels, time = x_f32.shape
    center = num_taps // 2
    step = nfft - (num_taps - 1)
    num_blocks = -(-time // step)

    # Zero-pad so every segment read is in bounds:
    # segment b starts at b*step - (L-1) + center in the original stream.
    left = num_taps - 1 - center
    right = num_blocks * step - time + center + (num_taps - 1)
    xp = F.pad(x_f32, (left, right))

    segments = frame_overlap(xp, nfft, step, num_blocks)  # (C, B, nfft)

    h_f32 = torch.as_tensor(h64, dtype=torch.float32, device=x.device)
    h_freq = torch.fft.rfft(h_f32, n=nfft)  # (nfft//2+1,)
    spec = torch.fft.rfft(segments, dim=-1)
    y_blocks = torch.fft.irfft(spec * h_freq, n=nfft, dim=-1)

    # Overlap-save discard: first L-1 samples of each block are circular.
    valid = y_blocks[:, :, num_taps - 1 :]  # (C, B, step)
    return valid.reshape(channels, num_blocks * step)[:, :time]


def fir_overlap_save_quantized(
    x_u8: torch.Tensor, h, qformat: QFormat = QFormat(), *,
    nfft: int | None = None
) -> torch.Tensor:
    """FFT path + hardware output stage → uint8, comparable to the sim.

    Applies the golden output contract (round-half-up at the implied
    fixed-point scale, then saturate) to the float FFT result, using the
    *quantized* coefficients so the only divergence from the bit-exact
    sim path is FFT arithmetic noise — bounded in tests by an SNR floor.
    """
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.float64)
    h_real = h_fixed / qformat.scale
    y = fir_overlap_save(x_u8, h_real, nfft=nfft)
    return torch.clamp(torch.floor(y + 0.5), 0, 255).to(torch.uint8)


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between two outputs."""
    ref = np.asarray(reference, np.float64)
    err = np.asarray(test, np.float64) - ref
    power = float(np.mean(ref**2))
    noise = float(np.mean(err**2))
    if noise == 0.0:
        return float("inf")
    return float(10.0 * np.log10(power / noise)) if power > 0 else float("-inf")
