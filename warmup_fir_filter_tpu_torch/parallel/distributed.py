"""Process-group initialization for meshes that span ranks and hosts.

Counterpart of ``warmup_fir_filter_tpu/parallel/distributed.py``.  Where
JAX starts one process per host over its devices, torch starts one
process per device (rank): every rank calls :func:`initialize_multihost`
before building a mesh, and the mesh's collectives (isend/irecv halos,
``all_to_all_single`` reshard, ``all_reduce``) then run over NCCL on the
cards or gloo on the host.

A single process with no coordinator is a no-op, as in JAX.  Nothing
falls back: ``device="cuda"`` without CUDA or without NCCL raises.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.parallel.mesh import BACKENDS


def _env_int(*names: str) -> int | None:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _coordinator_from_env() -> str | None:
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if address:
        return address
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
) -> bool:
    """Initialize the default process group when there is a coordinator or
    more than one process.

    Arguments default from ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, then torch's
    ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  ``device``
    is ``"cuda"`` (NCCL) or ``"cpu"`` (gloo).

    Returns True when a process group was initialized, False for the
    single-process no-op.
    """
    coordinator_address = coordinator_address or _coordinator_from_env()
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process — nothing to do

    if device not in BACKENDS:
        raise ValueError(f"device={device!r}; expected one of "
                         f"{tuple(BACKENDS)}")
    if device == "cuda":
        _build.resolve_device("cuda")
        if not dist.is_nccl_available():
            raise RuntimeError(
                "device='cuda' needs NCCL, which this torch build lacks; "
                "pass device='cpu' for gloo on the host.")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process group needs coordinator_address, num_processes "
            f"and process_id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    dist.init_process_group(
        BACKENDS[device], init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def global_mesh_axes(time_parallel: int = 1) -> dict[str, int]:
    """Suggested mesh axes for the current rank population.

    Puts ``time_parallel`` ranks on the sequence-parallel axis and the
    rest on the data axis.
    """
    total = dist.get_world_size() if dist.is_initialized() else 1
    if total % time_parallel:
        raise ValueError(
            f"time_parallel={time_parallel} must divide device count {total}."
        )
    return {"data": total // time_parallel, "time": time_parallel}
