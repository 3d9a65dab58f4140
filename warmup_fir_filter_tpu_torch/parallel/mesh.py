"""Device mesh construction, and where a sharded array's blocks live.

Counterpart of ``warmup_fir_filter_tpu/parallel/mesh.py``.  JAX runs one
process over many devices; torch runs one process per rank, each with one
device, so the mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the process group (:func:`initialize_multihost` makes
it, for a world of 1 too), with the JAX mesh's axis names.

The entries of ``parallel/`` take a global array (the same on every rank,
as in SPMD lockstep) or a ``DTensor`` already on the mesh, and return a
``DTensor`` placed as the JAX function's out-spec.  A spec here is a tuple
of mesh axis names (or None) per array dimension, as a ``PartitionSpec``:
:func:`placements_of` turns it into ``Shard``/``Replicate`` placements,
:func:`local_block` cuts the rank's block out of the input and
:func:`as_dtensor` wraps the rank's output block.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from warmup_fir_filter_tpu_torch import _build

#: Mesh device types and the process-group backend each needs.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

Spec = Sequence[str | None]


def make_mesh(
    axis_sizes: dict[str, int] | None = None,
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a named :class:`DeviceMesh` over the process group's ranks.

    Args:
        axis_sizes: ordered {axis_name: size}; sizes must multiply to the
            world size (one device per rank).  Default: every rank on one
            ``"data"`` axis.
        device_type: ``"cuda"`` (each rank binds ``cuda:{local rank}``;
            the group must be NCCL) or ``"cpu"`` (gloo).
    """
    if device_type not in BACKENDS:
        raise ValueError(f"device_type={device_type!r}; expected one of "
                         f"{tuple(BACKENDS)}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call initialize_multihost("
            "coordinator_address=..., num_processes=..., process_id=...) "
            "first, num_processes=1 for a single rank.")
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {"data": world}
    sizes = tuple(int(s) for s in axis_sizes.values())
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(
            f"Mesh axes {axis_sizes} need {total} devices, have {world}."
        )
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(axis_sizes))


def local_rank() -> int:
    """This rank's card: ``LOCAL_RANK`` where the launcher sets it, else
    the global rank modulo the cards visible.  Raises without CUDA."""
    _build.resolve_device("cuda")
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return dist.get_rank() % torch.cuda.device_count()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's blocks."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of the named mesh axis (``mesh.shape[axis]`` in JAX)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise KeyError(f"mesh has no axis {axis!r}; its axes are {names}")
    return mesh.size(names.index(axis))


def placements_of(mesh: DeviceMesh, spec: Spec) -> list:
    """``Shard(d)`` on each mesh axis that dimension ``d`` of ``spec``
    names, ``Replicate()`` on the others."""
    for axis in spec:
        if axis is not None:
            axis_size(mesh, axis)
    return [Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh.mesh_dim_names]


def global_shape(x) -> tuple[int, ...]:
    """Shape of the global array ``x`` (a tensor, ``DTensor`` or array)."""
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def check_divisible(shape: Sequence[int], spec: Spec,
                    mesh: DeviceMesh) -> None:
    """Raise unless every sharded dimension divides by its axis size."""
    for size, axis in zip(shape, spec):
        if axis is not None and size % axis_size(mesh, axis):
            raise ValueError(
                f"Dimension {size} not divisible by mesh axis "
                f"{axis!r}={axis_size(mesh, axis)}."
            )


def local_block(x, mesh: DeviceMesh, spec: Spec,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's contiguous block of the global array ``x``, placed as
    ``spec`` on ``mesh``, on the mesh's device.

    A ``DTensor`` with those placements gives its local tensor; any other
    ``DTensor`` is gathered first.  A tensor or host array is cut on its
    own device, then the block moves.  The caller has checked
    divisibility (:func:`check_divisible`).
    """
    if isinstance(x, DTensor):
        if x.device_mesh == mesh and list(x.placements) == placements_of(
                mesh, spec):
            block = x.to_local()
            return block.to(dtype=dtype).contiguous()
        x = x.full_tensor()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    for dim, axis in enumerate(spec):
        if axis is not None:
            width = x.shape[dim] // axis_size(mesh, axis)
            x = x.narrow(dim, mesh.get_local_rank(axis) * width, width)
    return x.to(device=mesh_device(mesh), dtype=dtype).contiguous()


def as_dtensor(block: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> DTensor:
    """The rank's output block as a ``DTensor`` placed as ``spec``."""
    return DTensor.from_local(block.contiguous(), mesh,
                              placements_of(mesh, spec), run_check=False)
