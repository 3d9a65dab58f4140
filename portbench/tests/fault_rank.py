"""A rank of the sharded cell with its timed path broken underneath, for
``test_portbench_faults.py``: ``FAULT`` in the environment names the
fault, then the rank runs as ``portbench.drivers.sharded_rank`` does."""

import os
import sys

import torch.nn.functional as F


def no_exchange(x_local, *, mesh, axis_name, left_width, right_width):
    """The halo exchange left out: zeros where the neighbours' samples
    belong."""
    return F.pad(x_local, (left_width, right_width))


def apply(fault: str) -> None:
    from warmup_fir_filter_tpu_torch.parallel import fft_sharded

    if fault == "no_exchange":
        fft_sharded.exchange_halo_1d = no_exchange
    elif fault == "altered":
        local = fft_sharded._overlap_save_local

        def altered(x_ext, plan, out_len):
            y = local(x_ext, plan, out_len)
            y[0, out_len // 2] += 1.0
            return y

        fft_sharded._overlap_save_local = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    apply(os.environ["FAULT"])
    from portbench.drivers import sharded_rank

    raise SystemExit(sharded_rank.main(sys.argv[1:]))
