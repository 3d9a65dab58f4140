"""Time-sharded FFT overlap-save over a device mesh.

Counterpart of ``warmup_fir_filter_tpu/parallel/fft_sharded.py``.
BASELINE.json config 4: "FFT overlap-save equivalent of 63-tap FIR on 16
channels x 10M samples, sharded across chips with halo exchange."  Each
rank owns a T/n time block of every channel, exchanges the asymmetric
same-mode halo with its neighbours (``parallel/halo.py``'s ring), and runs
the local overlap-save on its extended block (:func:`_overlap_save_local`):

- ``backend="jnp"``: ``torch.fft.rfft``/``irfft`` over frames of the
  block, the computation the JAX package also leaves to its FFT library;
- ``backend="pallas"``: kernel M (``kernels/fft.py::osfilt_stream``)
  straight off the extended block at ``off = L-1-L//2`` where
  ``stream_kernel_supported(L, off)`` holds (up to 257 taps), else
  kernel L (``osfilt``) over its frames.  On a CPU block each kernel's
  plain version runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch.kernels.fft import (
    STREAM_NFFT,
    FilterSpectrum,
    _stream_geometry,
    osfilt,
    osfilt_stream,
    stream_kernel_supported,
)
from warmup_fir_filter_tpu_torch.ops.fftfilt import frame_overlap, pick_nfft
from warmup_fir_filter_tpu_torch.parallel.halo import exchange_halo_1d
from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    check_divisible,
    global_shape,
    local_block,
    mesh_device,
)

BACKENDS = ("jnp", "pallas")


@dataclasses.dataclass
class LocalOverlapSave:
    """The shard-local filter, prepared once on one device: ``spectrum``
    is kernel M's 512-point table (``stream``) or kernel L's, ``h_freq``
    the ``"jnp"`` filter's rfft."""

    backend: str
    num_taps: int
    nfft: int
    left_w: int
    stream: bool
    spectrum: FilterSpectrum | None
    h_freq: torch.Tensor | None

    @classmethod
    def prepare(cls, h, nfft: int | None, backend: str,
                device: torch.device) -> "LocalOverlapSave":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        h64 = np.asarray(h, np.float64)
        num_taps = int(h64.size)
        nfft = pick_nfft(num_taps) if nfft is None else nfft
        if nfft < num_taps:
            raise ValueError(f"nfft={nfft} must be >= num_taps={num_taps}")
        left_w = num_taps - 1 - num_taps // 2
        stream = backend == "pallas" and stream_kernel_supported(num_taps,
                                                                 left_w)
        spectrum = h_freq = None
        if stream:
            spectrum = FilterSpectrum(
                h64, STREAM_NFFT, d=_stream_geometry(num_taps, left_w)[1],
                device=device)
        elif backend == "pallas":
            spectrum = FilterSpectrum(h64, nfft, device=device)
        else:
            h_freq = torch.fft.rfft(
                torch.as_tensor(h64, dtype=torch.float32, device=device),
                n=nfft)
        return cls(backend, num_taps, nfft, left_w, stream, spectrum, h_freq)


def _overlap_save_local(x_ext: torch.Tensor, plan: LocalOverlapSave,
                        out_len: int) -> torch.Tensor:
    """The shard-local step: ``out_len`` same-mode FIR outputs of the
    halo-extended f32 block, output t at extended index ``t + left_w``.

    Framed: segment b covers extended indices ``[b·step, b·step + nfft)``
    and y[t] needs ``ext[t ... t + L - 1]``, the standard
    discard-first-(L-1) alignment.
    """
    if plan.stream:
        return osfilt_stream(x_ext, plan.spectrum, off=plan.left_w,
                             out_len=out_len, out_u8=False)
    num_taps, nfft = plan.num_taps, plan.nfft
    step = nfft - (num_taps - 1)
    num_blocks = -(-out_len // step)
    pad_right = num_blocks * step + (num_taps - 1) - x_ext.shape[1]
    xp = F.pad(x_ext, (0, max(0, pad_right)))
    segments = frame_overlap(xp, nfft, step, num_blocks)
    channels = x_ext.shape[0]
    if plan.backend == "jnp":
        spec = torch.fft.rfft(segments, dim=-1)
        y = torch.fft.irfft(spec * plan.h_freq, n=nfft, dim=-1)
    else:
        y = osfilt(segments.reshape(channels * num_blocks, nfft).contiguous(),
                   plan.spectrum, out_u8=False)
    valid = y[..., num_taps - 1 :].reshape(channels, num_blocks * step)
    return valid[:, :out_len]


def make_overlap_save_step(
    h,
    *,
    mesh: DeviceMesh,
    time_axis: str = "time",
    channel_axis: str = "data",
    nfft: int | None = None,
    backend: str = "jnp",
    steps: int = 1,
) -> Callable:
    """Build a reusable sharded overlap-save step.

    Returns ``run(x, seed=0.0) -> DTensor`` (C, T) f32 placed
    ``(channel_axis, time_axis)``, with the filter's tables prepared once.
    ``x`` is the global (C, T) array or a ``DTensor`` on the mesh.
    ``steps > 1`` applies the filter that many times (shape-preserving,
    a halo exchange per application); ``seed`` is added to the input
    first.
    """
    plan = LocalOverlapSave.prepare(h, nfft, backend, mesh_device(mesh))
    right_w = plan.num_taps // 2
    spec = (channel_axis, time_axis)

    def run(x, seed: float = 0.0) -> DTensor:
        check_divisible(global_shape(x), spec, mesh)
        y = local_block(x, mesh, spec, torch.float32)
        if seed:  # a zero seed would cost a pass over the block
            y = y + float(np.float32(seed))
        local_time = y.shape[1]
        for _ in range(steps):
            # The halo gives each shard the neighbourhood it would see
            # inside the global zero-padded stream.
            x_ext = exchange_halo_1d(y, mesh=mesh, axis_name=time_axis,
                                     left_width=plan.left_w,
                                     right_width=right_w)
            y = _overlap_save_local(x_ext, plan, local_time)
        return as_dtensor(y, mesh, spec)

    return run


def fir_overlap_save_sharded(
    x,
    h,
    *,
    mesh: DeviceMesh,
    time_axis: str = "time",
    channel_axis: str = "data",
    nfft: int | None = None,
    backend: str = "jnp",
) -> DTensor:
    """Float32 same-mode FIR via FFT overlap-save, (C, T) sharded C×T.

    ``backend="pallas"`` runs each shard's local overlap-save through
    kernel M (or L) instead of ``torch.fft`` — same sharding, same halo
    exchange, same result to f32 rounding.
    """
    run = make_overlap_save_step(
        h, mesh=mesh, time_axis=time_axis, channel_axis=channel_axis,
        nfft=nfft, backend=backend,
    )
    return run(x)
