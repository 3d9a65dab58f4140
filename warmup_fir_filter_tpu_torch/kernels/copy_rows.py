"""Kernel N: the in-place copy of uint8 rows (ports K15).

Counterpart of ``bench_roofline.py::_pallas_copy_fn`` (``:46``), the TPU
roofline harness's aliased block copy: the yardstick of a pass that reads
one byte and writes one byte a sample, as the fixed FIR does.  The port's
roofline bench (``benches/bench_roofline.py``) times it as ``copy_rows``,
and the headline bench (``benches/bench.py``) takes its rate as
``wall_msps``.

:func:`copy_rows_` launches ``csrc/copy_rows.cu`` on a CUDA tensor and
returns the same tensor; on a CPU tensor it runs :func:`copy_rows_plain`.
The TPU kernel's block rows (``br``) are a VMEM blocking with no
counterpart: the CUDA kernel walks the whole buffer in 16-byte vectors.
"""

from __future__ import annotations

import torch

from warmup_fir_filter_tpu_torch import _build


def _check(x: torch.Tensor) -> None:
    _build.check_rows_u8(x)
    if not x.is_contiguous():
        raise ValueError("copy_rows_ needs contiguous rows")


def copy_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Kernel N's plain version: copy a clone of ``x`` back into ``x``;
    returns ``x``.  Runs on the device of its input."""
    _check(x)
    return x.copy_(x.clone())


def copy_rows_(x: torch.Tensor) -> torch.Tensor:
    """Copy contiguous ``(rows, n)`` uint8 rows onto themselves; returns
    ``x`` (the same tensor, the same storage).

    Kernel N on a CUDA tensor, every byte read once and written once;
    :func:`copy_rows_plain` on a CPU tensor.  Raises on anything but a
    contiguous 2-D uint8 tensor, on a failed build and on a failed launch.
    Counts its launches in ``copy_rows_.launches``.
    """
    _check(x)
    if x.device.type == "cpu":
        return copy_rows_plain(x)
    if x.numel() == 0:
        return x
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.wft_copy_rows(x.data_ptr(), x.data_ptr(), x.numel(),
                                 _build.stream_of(x))
    _build.check_launch(lib, code, "copy_rows")
    copy_rows_.launches += 1
    return x


copy_rows_.launches = 0
