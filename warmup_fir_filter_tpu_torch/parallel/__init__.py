"""Multi-device layer over ``torch.distributed``: meshes, halo exchange,
resharding, filter-bank and pipeline parallelism.

Counterpart of ``warmup_fir_filter_tpu/parallel/``, under its names: data
parallel over channels/cases, sequence parallel over time blocks with
overlap-save halo exchange (an isend/irecv ring), channel↔time
resharding (``all_to_all_single``).  One process per rank and device;
the mesh is a ``DeviceMesh`` with the JAX mesh's axis names, and the
sharded entries return ``DTensor``s placed as the JAX out-specs.
"""

from warmup_fir_filter_tpu_torch.parallel.mesh import make_mesh
from warmup_fir_filter_tpu_torch.parallel.halo import (
    exchange_halo_1d,
    exchange_halo_2d,
    fir1d_fixed_sharded,
    fir2d_fixed_sharded,
)
from warmup_fir_filter_tpu_torch.parallel.reshard import (
    channel_to_time,
    time_to_channel,
)
from warmup_fir_filter_tpu_torch.parallel.expert import (
    filter_bank_fixed_sharded,
)
from warmup_fir_filter_tpu_torch.parallel.fft_sharded import (
    fir_overlap_save_sharded,
)
from warmup_fir_filter_tpu_torch.parallel.pipeline_parallel import (
    PipelinedChain,
)
from warmup_fir_filter_tpu_torch.parallel.spmd_pipeline import spmd_pipeline
from warmup_fir_filter_tpu_torch.parallel.distributed import (
    initialize_multihost,
)

__all__ = [
    "make_mesh",
    "exchange_halo_1d",
    "exchange_halo_2d",
    "fir1d_fixed_sharded",
    "fir2d_fixed_sharded",
    "channel_to_time",
    "time_to_channel",
    "filter_bank_fixed_sharded",
    "fir_overlap_save_sharded",
    "PipelinedChain",
    "spmd_pipeline",
    "initialize_multihost",
]
