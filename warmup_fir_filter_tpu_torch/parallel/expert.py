"""Filter-bank (expert) parallelism: different filters on different ranks.

Counterpart of ``warmup_fir_filter_tpu/parallel/expert.py``.  The bank
itself is sharded — each rank holds F/n filters, the input block is
replicated, and every rank produces its filters' outputs locally, so the
only communication is the input's placement and none afterwards.  Each
filter runs the shard-local step of ``parallel/halo.py`` over the whole
rows: kernel A (up to 257 taps; C or B beyond) on the card, the int32
core on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch.kernels.dispatch import prepare_fixed_fir
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.parallel.halo import (
    _fir1d_local,
    _require_int32,
)
from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    axis_size,
    local_block,
)


def filter_bank_fixed_sharded(
    x_u8,
    h_bank,
    qformat: QFormat = QFormat(),
    *,
    mesh: DeviceMesh,
    expert_axis: str = "data",
) -> DTensor:
    """Apply an (F, L) filter bank to (C, T) rows; F sharded over a mesh axis.

    Returns (F, C, T) uint8, placed ``(expert_axis, None, None)``.
    Bit-exact per filter against the single-device fixed path.
    """
    _require_int32(qformat)
    h_bank = np.asarray(h_bank, np.float64)
    if h_bank.ndim != 2:
        raise ValueError(f"h_bank must be (F, L), got shape {h_bank.shape}")
    num_filters = h_bank.shape[0]
    num_experts = axis_size(mesh, expert_axis)
    if num_filters % num_experts:
        raise ValueError(
            f"F={num_filters} not divisible by mesh axis "
            f"{expert_axis!r}={num_experts}."
        )
    x = local_block(x_u8, mesh, (None, None), torch.uint8)
    per_rank = num_filters // num_experts
    first = mesh.get_local_rank(expert_axis) * per_rank
    outs = [_fir1d_local(x, prepare_fixed_fir(h, qformat, x.device), 0, 0)
            for h in h_bank[first : first + per_rank]]
    return as_dtensor(torch.stack(outs), mesh, (expert_axis, None, None))
