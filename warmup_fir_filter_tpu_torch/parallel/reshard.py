"""Channel↔time resharding over a mesh axis (the Ulysses analogue for DSP).

Counterpart of ``warmup_fir_filter_tpu/parallel/reshard.py``.  A (C, T)
stream bank can live on a mesh axis in two layouts:

- **channel-sharded** (``Shard(0)``): each rank owns C/n whole channels —
  right for per-channel FIR/demod (no halos at all);
- **time-sharded** (``Shard(1)``): each rank owns a T/n time block of
  every channel — right for FFT overlap-save and halo-exchange
  convolution along time.

One ``all_to_all_single`` on the axis's process group flips between them,
with the JAX function's block order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    axis_size,
    global_shape,
    local_block,
)


def _check(x, mesh: DeviceMesh, axis: str) -> tuple[int, int, int]:
    num = axis_size(mesh, axis)
    channels, time = global_shape(x)
    if channels % num or time % num:
        raise ValueError(
            f"C={channels} and T={time} must both divide mesh axis "
            f"{axis!r}={num}."
        )
    return num, channels, time


def _all_to_all(blocks: torch.Tensor, mesh: DeviceMesh,
                axis: str) -> torch.Tensor:
    """Send ``blocks[d]`` to rank d of ``axis``; ``out[s]`` comes from s."""
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=mesh.get_group(axis))
    return out


def channel_to_time(x, *, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """Reshard (C, T): channel-sharded → time-sharded.

    Input placement ``(axis, None)`` → output ``(None, axis)``, moved with
    a single all_to_all instead of a host round-trip.
    """
    num, channels, time = _check(x, mesh, axis)
    x_loc = local_block(x, mesh, (axis, None))  # (C/n, T)
    # Split the local rows into n time blocks; send block d to rank d;
    # the n received (C/n, T/n) pieces stack along channels.
    blocks = x_loc.reshape(x_loc.shape[0], num, time // num).transpose(0, 1)
    out = _all_to_all(blocks.contiguous(), mesh, axis)
    return as_dtensor(out.reshape(channels, time // num), mesh, (None, axis))


def time_to_channel(x, *, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """Reshard (C, T): time-sharded → channel-sharded (inverse flip)."""
    num, channels, time = _check(x, mesh, axis)
    x_loc = local_block(x, mesh, (None, axis))  # (C, T/n)
    blocks = x_loc.reshape(num, channels // num, x_loc.shape[1])
    out = _all_to_all(blocks, mesh, axis)  # (n, C/n, T/n), by time block
    return as_dtensor(out.transpose(0, 1).reshape(channels // num, time),
                      mesh, (axis, None))
