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

The sharded chains (``:140-313``) run on a ``parallel/`` mesh:
:func:`chain_forward_sharded` runs :func:`chain_forward` on each rank's
channel rows (kernel J where the local channel count supports it), and
:func:`chain_forward_time_sharded` runs kernel J on each rank's
halo-extended time block, bit-identical to the unsharded fused chain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
    FusedChain,
    chain_forward_fused,
    chain_fused,
    chain_fused_supported,
)
from warmup_fir_filter_tpu_torch.kernels.fft import fir_overlap_save_pallas
from warmup_fir_filter_tpu_torch.kernels.fir_band import MAX_TAPS
from warmup_fir_filter_tpu_torch.kernels.fir_float import fir1d_ideal_rows_band
from warmup_fir_filter_tpu_torch.kernels.resample import build_resample_band
from warmup_fir_filter_tpu_torch.ops.demod import fm_demodulate
from warmup_fir_filter_tpu_torch.ops.fftfilt import fir_overlap_save
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_ideal_rows_torch
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass, resample_poly
from warmup_fir_filter_tpu_torch.parallel.halo import exchange_halo_1d
from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    axis_size,
    global_shape,
    local_block,
    mesh_device,
)


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


def chain_forward_sharded(
    re,
    im,
    config: ChainConfig = ChainConfig(),
    *,
    mesh: DeviceMesh,
    channel_axis: str = "data",
) -> DTensor:
    """Data-parallel chain: channels sharded over ``channel_axis``.

    Every stage is row-independent, so each rank runs the full chain on
    its local channel rows, and the fused kernel engages exactly when the
    LOCAL channel count supports it.  Returns (C, T') f32 placed
    ``(channel_axis, None)``.
    """
    channels = global_shape(re)[0]
    if channels % axis_size(mesh, channel_axis):
        raise ValueError(
            f"channels={channels} not divisible by mesh axis "
            f"{channel_axis!r}={axis_size(mesh, channel_axis)}."
        )
    spec = (channel_axis, None)
    re_loc, im_loc = (local_block(p, mesh, spec, torch.float32)
                      for p in (re, im))
    return as_dtensor(chain_forward(re_loc, im_loc, config), mesh, spec)


def _chain_time_local(re_ext: torch.Tensor, im_ext: torch.Tensor,
                      chain: FusedChain, rs_bounds: tuple[int, int],
                      h_out: int, out_local: int,
                      first: bool) -> torch.Tensor:
    """The time-sharded chain's shard-local step on a halo-extended block:
    kernel J with the global resampled window ``rs_bounds`` in extended
    coordinates, the ``out_local`` messages from ``h_out`` on, and on the
    first shard the global sample 0 set to 0 (it has no predecessor; every
    other shard's came in with the halo)."""
    y = chain_fused(re_ext, im_ext, chain, rs_bounds)
    y = y[:, h_out : h_out + out_local].contiguous()
    if first:
        y[:, 0] = 0.0
    return y


def chain_forward_time_sharded(
    re,
    im,
    config: ChainConfig = ChainConfig(),
    *,
    mesh: DeviceMesh,
    time_axis: str = "time",
    channel_axis: str | None = None,
    halo_mult: int = 4,
) -> DTensor:
    """The fused chain sharded along TIME.

    Each shard halo-extends its input block by ``H_in = 128·down·
    halo_mult`` samples per side (the ring of ``parallel/halo.py``; zeros
    at the stream ends — identical to the kernel's own zero pad), runs
    kernel J on the extended block, and keeps the interior from ``H_out =
    128·up·halo_mult`` on.  Kernel J computes each output from its own
    operand window with its taps in ascending order, and both H_in and
    the per-shard lengths are tile- and phase-aligned (constraints below),
    so every retained output is BIT-IDENTICAL to the single-device run.

    Constraints: ``T % n_shards == 0``; the local length must keep the
    polyphase phase (``T_local % down == 0``) and the output tile grid
    (``T_local·up/down % 128 == 0``) aligned across shards.
    ``channel_axis`` optionally shards channels too (row-local, exact).
    Returns (C, T·up/down) f32 placed ``(channel_axis, time_axis)``.
    """
    up, down = config.resample_up, config.resample_down
    h_rs = config.resample_filter()
    h_ch = config.channelizer_filter()
    channels, time = global_shape(re)
    n_t = axis_size(mesh, time_axis)
    n_c = axis_size(mesh, channel_axis) if channel_axis else 1
    if channels % max(n_c, 1) or time % n_t:
        raise ValueError(
            f"(C, T)=({channels}, {time}) not divisible by mesh "
            f"({n_c}, {n_t})")
    t_local = time // n_t
    if t_local % down or (t_local * up // down) % 128:
        raise ValueError(
            f"T_local={t_local} must be divisible by down={down} with "
            f"T_local·up/down a multiple of 128 (tile/phase alignment)")
    h_in = 128 * down * halo_mult
    if h_in > t_local:
        raise ValueError(
            f"halo width {h_in} exceeds T_local={t_local}; use more "
            f"samples per shard or a smaller halo_mult")
    if not chain_fused_supported(channels // max(n_c, 1), up, down,
                                 h_rs.size, h_ch.size):
        raise ValueError("config not supported by the fused chain kernel")
    out_local = t_local * up // down
    h_out = 128 * up * halo_mult

    # Reach check: the first/last retained output tile must read only
    # real (exchanged) samples, so the kernel's own edge zero-masks fire
    # exclusively inside the discarded halo region.
    _, k_rows, ds, beta0, j_count = build_resample_band(
        np.asarray(h_rs, np.float64), up, down)
    first_read = beta0 - (j_count - 1)
    q_min = h_out // 128 - 2   # leftmost rs tile any retained output uses
    q_max = (h_out + out_local) // 128 + 1   # rightmost (exclusive-ish)
    ext_len = t_local + 2 * h_in
    if q_min * ds + first_read < 0 or \
            q_max * ds + first_read + k_rows > ext_len:
        raise ValueError(
            f"halo_mult={halo_mult} too small for this geometry "
            f"(ds={ds}, k_rows={k_rows}, first_read={first_read})")

    spec = (channel_axis, time_axis)
    chain = FusedChain(h_rs, h_ch, up, down, config.demod_k_f,
                       precision=config.fused_precision,
                       device=mesh_device(mesh))
    re_ext, im_ext = (
        exchange_halo_1d(local_block(p, mesh, spec, torch.float32),
                         mesh=mesh, axis_name=time_axis, left_width=h_in,
                         right_width=h_in)
        for p in (re, im))
    # The global resampled-space valid window in local extended
    # coordinates: the kernel zero-pads the resampled stream exactly where
    # the single-device run does.
    s_idx = mesh.get_local_rank(time_axis)
    lo = h_out - s_idx * out_local
    hi = h_out + out_local * n_t - s_idx * out_local
    y = _chain_time_local(re_ext, im_ext, chain, (lo, hi), h_out, out_local,
                          first=s_idx == 0)
    return as_dtensor(y, mesh, spec)
