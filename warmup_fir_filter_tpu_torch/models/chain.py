"""The DSP chain: resample → channelize → FM demod (BASELINE config 5).

Counterpart of ``warmup_fir_filter_tpu/models/chain.py`` (``:25-137``).
The chain runs on complex baseband rows carried as split I/Q float planes
of shape (channels, time), on the planes' device.

:func:`chain_forward` takes the JAX package's paths under its names:

- ``"auto"`` on CUDA planes runs kernel J (the fused chain) when
  :func:`chain_fused_supported` holds, as the JAX package runs its fused
  kernel on its accelerator; otherwise the staged path: ``resample_poly``
  (kernel I on the card), the ``"mxu"`` channelizer (kernel H), then
  ``fm_demodulate``.  Above 257 channelizer taps ``"auto"`` takes the
  ``"pallas"`` channelizer on CUDA planes and the ``torch.fft`` one on CPU
  planes, as the JAX ``"auto"`` does on and off its accelerator;
- ``"fused"`` forces kernel J and raises where it does not apply;
- ``"mxu"`` and ``"jnp"`` force a staged channelizer: kernel H, or the
  ``torch.fft`` overlap-save of ``ops/fftfilt.py``;
- ``"pallas"`` forces the FFT overlap-save of ``kernels/fft.py``
  (``fir_overlap_save_pallas``): kernel M up to 257 taps, the framed
  kernel L beyond.  It runs once over the I and Q planes stacked as rows,
  the same row-wise function as the JAX package's two calls;
- ``use_fft_channelizer=False`` channelizes with the plain f32 FIR.

The sharded chains (``chain_forward_sharded``,
``chain_forward_time_sharded``) wait for the port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
    chain_forward_fused,
    chain_fused_supported,
)
from warmup_fir_filter_tpu_torch.kernels.fft import fir_overlap_save_pallas
from warmup_fir_filter_tpu_torch.kernels.fir_band import MAX_TAPS
from warmup_fir_filter_tpu_torch.kernels.fir_float import fir1d_ideal_rows_band
from warmup_fir_filter_tpu_torch.ops.demod import fm_demodulate
from warmup_fir_filter_tpu_torch.ops.fftfilt import fir_overlap_save
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_ideal_rows_torch
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass, resample_poly


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of the DSP chain (the JAX package's fields)."""

    resample_up: int = 2
    resample_down: int = 3
    resample_taps: int = 63
    channelizer_taps: int = 63
    channelizer_cutoff: float = 0.25
    demod_k_f: float = 0.05
    use_fft_channelizer: bool = True
    #: "auto", "fused", "mxu", "jnp" or "pallas" (module docstring).
    channelizer_backend: str = "auto"
    #: Numerics of the fused kernel: "bf16x3" and "highest" (f32 on the
    #: card), or "bf16" (bf16 storage mode).
    fused_precision: str = "bf16x3"

    def resample_filter(self) -> np.ndarray:
        cutoff = 0.9 / max(self.resample_up, self.resample_down)
        return design_lowpass(self.resample_taps, cutoff,
                              gain=self.resample_up)

    def channelizer_filter(self) -> np.ndarray:
        return design_lowpass(self.channelizer_taps, self.channelizer_cutoff)


def chain_forward(re: torch.Tensor, im: torch.Tensor,
                  config: ChainConfig = ChainConfig()) -> torch.Tensor:
    """Run the full chain on (C, T) I/Q rows → (C, T') f32 message rows.

    Tensors stay on their device; host arrays go to the card
    (``_build.as_rows``)."""
    re, im = _build.as_rows(re), _build.as_rows(im)
    h_rs = config.resample_filter()
    h_ch = config.channelizer_filter()

    backend = config.channelizer_backend
    if backend == "fused" and not config.use_fft_channelizer:
        # A forced 'fused' request must not silently fall through to the
        # staged ideal channelizer.
        raise ValueError(
            "channelizer_backend='fused' requires use_fft_channelizer=True "
            "(the fused kernel implements the FFT-channelizer contract)")
    if backend in ("auto", "fused") and config.use_fft_channelizer:
        supported = chain_fused_supported(
            int(re.shape[0]), config.resample_up, config.resample_down,
            config.resample_taps, config.channelizer_taps)
        if backend == "fused" and not supported:
            raise ValueError(
                "channelizer_backend='fused' but the fused chain kernel "
                "does not support this config (see chain_fused_supported)")
        if supported and (backend == "fused" or re.device.type == "cuda"):
            return chain_forward_fused(
                re, im, h_rs, h_ch, config.resample_up,
                config.resample_down, config.demod_k_f,
                precision=config.fused_precision)

    # One resampler pass over both I/Q planes stacked as extra rows.
    channels = re.shape[0]
    both_rs = resample_poly(
        torch.cat([re.to(torch.float32), im.to(torch.float32)], dim=0),
        h_rs, config.resample_up, config.resample_down,
    )
    re_rs, im_rs = both_rs[:channels], both_rs[channels:]

    if config.use_fft_channelizer:
        backend = config.channelizer_backend
        if backend == "auto":
            backend = "mxu" if config.channelizer_taps <= MAX_TAPS else (
                "pallas" if re.device.type == "cuda" else "jnp")
        if backend == "mxu":
            # One pass of kernel H over both I/Q planes.
            both = fir1d_ideal_rows_band(both_rs, h_ch)
            re_ch, im_ch = both[:channels], both[channels:]
        elif backend == "pallas":
            both = fir_overlap_save_pallas(both_rs, h_ch)
            re_ch, im_ch = both[:channels], both[channels:]
        elif backend == "jnp":
            re_ch = fir_overlap_save(re_rs, h_ch)
            im_ch = fir_overlap_save(im_rs, h_ch)
        else:
            raise ValueError(
                f"unknown channelizer_backend {config.channelizer_backend!r}"
            )
    else:
        re_ch = fir1d_ideal_rows_torch(re_rs, h_ch)
        im_ch = fir1d_ideal_rows_torch(im_rs, h_ch)

    return fm_demodulate(re_ch, im_ch, config.demod_k_f)
