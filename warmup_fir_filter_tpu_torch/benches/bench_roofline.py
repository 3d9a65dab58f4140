"""The card's bandwidth wall for a 2-bytes-a-sample pass (one JSON line).

Port of ``bench_roofline.py``.  Every probe is a pass over ``(batch, 8192)``
uint8 rows of 40, 160 and 640 MB, timed by ``chained_throughput`` (CUDA
events, chain slope):

- ``copy_rows``: kernel N, the in-place copy (the TPU harness's aliased
  Pallas copy), the wall for the FIR's exact dataflow;
- ``torch_copy``: ``dst.copy_(x)`` between two buffers, the library call;
- ``xor``: ``x ^ 1``, one elementwise pass;
- ``widen_narrow``: ``u8 → int32 (+1, clamp) → u8``, the FIR's epilogue
  without the products (PyTorch runs it as several passes);
- ``f32_scale``: ``x * 1.0001`` over f32 rows of the same bytes;
- ``fir_band``: kernel A on the 5-tap sharpen filter.

``gbps`` counts two bytes a sample (eight for ``f32_scale``) and
``datasheet_gbps`` is the H100's 3,350 GB/s.  Left out of the JAX harness:
the block-row sweeps (TPU VMEM blockings) and the ``--hlo-check`` count of
XLA copies.

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_roofline
[--sizes-mb 40,160,640] [--quick] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.copy_rows import copy_rows_
from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANK_5TAP

METRIC = "roofline_probes"
UNIT = "Gsamples/s and GB/s per probe"
WIDTH = 8192
SEED = 3
#: The JAX harness's keys under another name here.
RENAMED = {f"pallas_copy_br{br}": "copy_rows"
           for br in (256, 512, 1024, 2048)}
RENAMED.update(xla_xor="xor", fir_mxu_auto="fir_band")
#: The JAX harness's keys with no counterpart, each with its reason.
DROPPED = {f"fir_mxu_br{br}": "a TPU VMEM block-row sweep"
           for br in (256, 512, 1024)}
DROPPED["hlo_fullsize_copies_in_loop"] = (
    "a count of XLA copies in compiled HLO (--hlo-check)")


def batch_rows(mb: int, width: int = WIDTH) -> int:
    """Rows of a ``mb``-MiB probe, rounded down to 1,024 (at least 128),
    as the JAX harness sizes them: 5,120, 20,480 and 81,920 for 40, 160
    and 640."""
    batch = (mb * 1024 * 1024) // width
    return (batch // 1024) * 1024 or 128


def _probe(entry: dict, name: str, step, x: torch.Tensor,
           bytes_per_sample: float = _common.BYTES_PER_SAMPLE) -> None:
    r = _common.throughput(step, x)
    sps = r["samples_per_second"]
    entry[name] = {"gsps": round(sps / 1e9, 3),
                   "gbps": round(sps * bytes_per_sample / 1e9, 3),
                   "ms": r["seconds_per_apply"] * 1e3}


def probe_size(mb: int, rng: np.random.Generator, device: torch.device,
               fir: FixedFir1d) -> dict:
    """Every probe at one size; kernel N is held to the identity first."""
    batch = batch_rows(mb)
    x = torch.from_numpy(rng.integers(0, 256, size=(batch, WIDTH),
                                      dtype=np.uint8)).to(device)
    entry: dict = {"shape": [batch, WIDTH], "mb": x.numel() / 1e6}
    want = x.clone()
    if copy_rows_(x) is not x or not torch.equal(x, want):
        raise AssertionError(f"copy_rows_ is not the identity at {batch} x "
                             f"{WIDTH}")
    del want
    _probe(entry, "copy_rows", copy_rows_, x)
    bound_ms = 2 * x.numel() / _common.PEAK_BYTES_PER_S * 1e3
    entry["copy_rows"].update(
        bound_ms=bound_ms,
        roofline_share=bound_ms / entry["copy_rows"]["ms"])
    dst = torch.empty_like(x)
    _probe(entry, "torch_copy",
           lambda a: (dst if a is x else x).copy_(a), x)
    del dst
    _probe(entry, "xor", lambda a: a ^ 1, x)
    _probe(entry, "widen_narrow",
           lambda a: (a.to(torch.int32) + 1).clamp_(0, 255).to(torch.uint8),
           x)
    _probe(entry, "fir_band", fir, x)
    del x
    # f32 over the same byte count: 4 bytes a sample each way.
    xf = torch.from_numpy(rng.standard_normal((batch // 4, WIDTH)).astype(
        np.float32)).to(device)
    _probe(entry, "f32_scale", lambda a: a * 1.0001, xf, bytes_per_sample=8.0)
    return entry


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes-mb", default="40,160,640")
    parser.add_argument("--quick", action="store_true",
                        help="the first size only")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        sizes_mb = [int(s) for s in args.sizes_mb.split(",")]
        if args.quick:
            sizes_mb = sizes_mb[:1]
        fir = FixedFir1d.from_numpy(np.asarray(FILTER_BANK_5TAP["sharpen"]),
                                    device=device)
        rng = np.random.default_rng(SEED)
        results = {"metric": METRIC, "unit": UNIT, **_common.card(device),
                   "datasheet_gbps": _common.PEAK_BYTES_PER_S / 1e9,
                   "datasheet_gsps_2B": _common.SOL_MSPS / 1e3,
                   "probes": {}}
        for mb in sizes_mb:
            results["probes"][f"{mb}MB"] = probe_size(mb, rng, device, fir)
        # value: the wall, kernel N's rate at the largest size.
        results["value"] = results["probes"][f"{sizes_mb[-1]}MB"][
            "copy_rows"]["gsps"]
        results["elapsed_s"] = round(time.perf_counter() - start, 1)
        return results

    return _common.run(METRIC, UNIT, body)


if __name__ == "__main__":
    raise SystemExit(main())
