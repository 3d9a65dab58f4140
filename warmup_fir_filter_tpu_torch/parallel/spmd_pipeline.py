"""SPMD collective pipeline: stages on a mesh axis, isend/irecv transport.

Counterpart of ``warmup_fir_filter_tpu/parallel/spmd_pipeline.py``: where
``pipeline_parallel.PipelinedChain`` orchestrates the stages from one
host process, here every rank of the mesh axis ``stage`` runs one
pipeline stage of the same program:

- ``T + S - 1`` ticks; at tick ``t`` rank ``s`` processes microbatch
  ``t - s`` (the 1F schedule); a rank with no microbatch at a tick
  computes nothing;
- stage 0 injects; activations move one stage to the right by
  ``isend``/``irecv`` on the axis's process group; the last stage
  retires;
- stage heterogeneity comes from the stage index: the stage function
  receives it as a Python int and selects parameters/behaviour.

All stages must therefore be shape- and dtype-preserving over the
activation.  Inputs are replicated; outputs are collected at the last
stage and replicated back by an ``all_reduce`` of the masked buffer (the
JAX ``psum``), so the result is replicated on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    axis_size,
    local_block,
)


def make_spmd_pipeline(
    stage_fn: Callable,
    *,
    mesh: DeviceMesh,
    axis: str = "stage",
) -> Callable:
    """Build the pipelined runner (reusable across calls).

    Returns ``run(microbatches) -> DTensor``: the ``(T, *item_shape)``
    outputs, replicated on the mesh.
    """
    num_stages = axis_size(mesh, axis)
    s = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < num_stages - 1 else None

    def run(microbatches) -> DTensor:
        mb = local_block(microbatches, mesh, (None,) * len(microbatches.shape))
        num_batches = mb.shape[0]
        outs = torch.zeros_like(mb)
        sends = []  # (work, buffer): a send completes while the next computes
        for t in range(num_batches + num_stages - 1):
            m = t - s  # this stage's microbatch at tick t
            if not 0 <= m < num_batches:
                continue
            if s == 0:
                x = mb[m]
            else:
                x = torch.empty_like(mb[0])
                dist.irecv(x, prev, group).wait()
            y = stage_fn(s, x)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(
                    f"stage_fn must preserve the activation: stage {s} "
                    f"turned {tuple(x.shape)} {x.dtype} into "
                    f"{tuple(y.shape)} {y.dtype}")
            if nxt is None:
                outs[m] = y  # the last stage retires microbatch m
            else:
                y = y.contiguous()
                sends.append((dist.isend(y, nxt, group), y))
        for work, _ in sends:
            work.wait()
        # Replicate the last stage's buffer to every rank.
        dist.all_reduce(outs, group=group)
        return as_dtensor(outs, mesh, (None,) * outs.dim())

    return run


def spmd_pipeline(
    stage_fn: Callable,
    microbatches,
    *,
    mesh: DeviceMesh,
    axis: str = "stage",
):
    """Run ``microbatches`` through a rank-pipelined stage chain.

    Args:
        stage_fn: ``(stage_index, x) -> y`` with ``y.shape == x.shape`` and
            the same dtype; ``stage_index`` is a Python int in ``[0, S)``.
        microbatches: ``(T, *item_shape)`` array, the same on every rank
            (or a replicated ``DTensor``); microbatch ``t`` enters stage 0
            at tick ``t``.
        mesh: mesh whose ``axis`` dimension (size S) hosts the stages.
        axis: mesh axis name holding the pipeline stages.

    Returns:
        ``(T, *item_shape)`` outputs as a replicated ``DTensor``,
        bit-identical to applying stages ``0..S-1`` sequentially to each
        microbatch; an empty stream comes back as given.
    """
    if int(microbatches.shape[0]) == 0:
        return microbatches
    return make_spmd_pipeline(stage_fn, mesh=mesh, axis=axis)(microbatches)
