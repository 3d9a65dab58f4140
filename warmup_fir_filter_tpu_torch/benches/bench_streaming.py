"""Long-stream streaming and checkpoint/resume on the card (one JSON line).

Port of ``bench_streaming.py``: 16 channels × 4,000,000 samples a block,
252 blocks (about 16.1 × 10⁹ samples) through the checkpointable block
stream (``ops/streaming.py``, 5-tap sharpen, Q4.12):

1. **Sustained rate**: ``stream_scanned`` run twice, the second timed; the
   carry stays on the card, blocks come from a seeded noise table on the
   card XOR a per-block tweak, and only the per-block checksums return.
   On the card each block is cut into window rows by kernel D and filtered
   by kernel A (``scan_mode`` names the geometry).
2. **Kill/resume**: the run split at the midpoint, the delay line saved
   (``FirStreamState.save``) and loaded into a fresh stream; the second
   half's checksums and the final state must equal the uninterrupted run's.
3. **Stitch**: the two blocks around the resume point through ``process``
   against the offline int32 core (``fixed_fir_prehaloed_i32``) over the
   regenerated input window, bit for bit; and the scan's checksums of the
   first of them against ``process``'s output (scan against blockwise).

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_streaming
[--quick] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANK_5TAP
from warmup_fir_filter_tpu_torch.ops.fir1d import fixed_fir_prehaloed_i32
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.streaming import (
    MASK32,
    Fir1DStream,
    FirStreamState,
    host_emit_checksums,
    pick_window_split,
    stream_scanned,
)

METRIC = "streaming_checkpoint_sustained"
UNIT = "Msamples/s sustained (on-device scan)"
CHANNELS = 16
BLOCK = 4_000_000          # samples per channel per block
NUM_BLOCKS = 252           # ≈ 16.1e9 samples in all
#: ``--quick``: a 64th of the block (the JAX bench's 62,500 rounded up to
#: a multiple of 128, so that the scan takes kernel D's windows as the full
#: block does) and 15 blocks.
QUICK_BLOCK, QUICK_BLOCKS = 64_000, 15
NOISE_SEED = 0x5EED
GATES = ("resume_checksums_match", "resume_state_match", "stitch_bit_exact",
         "scan_vs_blockwise_checksums_match")
#: The JAX bench's keys under another name here, and those with no
#: counterpart.
RENAMED: dict[str, str] = {}
DROPPED: dict[str, str] = {}


def block_tweak(b: int) -> int:
    """Block ``b``'s byte, ``bench_streaming.py:80-84``'s hash in uint32."""
    s = (b * 2654435761) & MASK32
    s = ((s ^ (s >> 13)) * 1274126177) & MASK32
    return (s >> 8) & 255


def stream_source(channels: int, block: int, device: torch.device):
    """``bench_streaming.py:77-84``'s blocks: a seeded (channels, block)
    noise table on ``device`` XOR a per-block tweak computed on the host.
    Returns ``block_fn(b)``, a pure function of ``b``."""
    noise = torch.from_numpy(np.random.default_rng(NOISE_SEED).integers(
        0, 256, size=(channels, block), dtype=np.uint8)).to(device)

    def block_fn(b: int) -> torch.Tensor:
        return noise ^ block_tweak(int(b))

    return block_fn


def stitch(h: np.ndarray, qf: QFormat, channels: int, block: int,
           half: int, block_fn,
           device: torch.device) -> tuple[bool, np.ndarray]:
    """Blocks ``half - 1`` and ``half`` through ``process`` after a scan of
    ``half - 1`` blocks, against the offline core over the regenerated
    window (``emitted[t] = y_global[t - center]``, all interior for
    ``half >= 2``).  Returns the verdict and block ``half - 1``'s output."""
    if half < 2:
        raise ValueError(f"the stitch needs half >= 2 (a window with no "
                         f"samples before 0), not {half}")
    stream = Fir1DStream(h, channels, qf, device)
    stream_scanned(stream, block_fn, half - 1)
    y_pair = [stream.process(block_fn(b).cpu().numpy())
              for b in (half - 1, half)]
    got = torch.from_numpy(np.concatenate(y_pair, axis=1)).to(device)
    num_taps = int(h.size)
    center = num_taps // 2
    left = num_taps - 1 - center
    lo = (half - 1) * block - center - left
    hi = (half + 1) * block
    xcat = torch.cat([block_fn(b) for b in range(max(0, lo // block),
                                                 (hi - 1) // block + 1)],
                     dim=1)
    off = lo - (lo // block) * block
    window = xcat[:, off : off + got.shape[1] + num_taps - 1].to(torch.int32)
    expected = fixed_fir_prehaloed_i32(
        window, qf.quantize_coeffs(h), num_taps, qf.frac_bits, qf.acc_bits)
    return bool(torch.equal(got, expected)), y_pair[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help=f"{QUICK_BLOCKS} blocks of {QUICK_BLOCK}")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        channels = CHANNELS
        block, num_blocks = ((QUICK_BLOCK, QUICK_BLOCKS) if args.quick
                             else (BLOCK, NUM_BLOCKS))
        h = np.asarray(FILTER_BANK_5TAP["sharpen"])
        qf = QFormat()
        block_fn = stream_source(channels, block, device)

        # 1. The uninterrupted scan, timed on its second run.
        stream = Fir1DStream(h, channels, qf, device)
        stream_scanned(stream, block_fn, num_blocks)
        stream.reset()
        _common.sync(device)
        t0 = time.perf_counter()
        sums_full = stream_scanned(stream, block_fn, num_blocks)
        elapsed = time.perf_counter() - t0
        total = channels * block * num_blocks
        final = stream.state

        # 2. Kill at the midpoint; a fresh stream resumes from the file.
        half = num_blocks // 2
        first = Fir1DStream(h, channels, qf, device)
        sums_a = stream_scanned(first, block_fn, half)
        with tempfile.TemporaryDirectory() as td:
            ckpt = Path(td) / "stream_state.npz"
            first.state.save(ckpt)
            resumed = Fir1DStream(h, channels, qf, device)
            resumed.state = FirStreamState.load(ckpt)
        sums_b = stream_scanned(resumed, block_fn, num_blocks - half,
                                start_block=half)
        gates = {
            "resume_checksums_match": bool(np.array_equal(
                np.concatenate([sums_a, sums_b]), sums_full)),
            "resume_state_match": bool(
                np.array_equal(resumed.state.carry, final.carry)
                and resumed.state.samples_seen == final.samples_seen),
        }

        # 3. The stitch across the resume point, and scan vs blockwise.
        gates["stitch_bit_exact"], y_before = stitch(
            h, qf, channels, block, half, block_fn, device)
        gates["scan_vs_blockwise_checksums_match"] = bool(np.array_equal(
            sums_full[half - 1].astype(np.uint64),
            host_emit_checksums(y_before)))

        geometry = (pick_window_split(channels, block, int(h.size))
                    if device.type == "cuda" else None)
        rate = total / elapsed / 1e6
        payload = {
            "metric": METRIC,
            "value": round(rate, 1),
            "unit": UNIT,
            "vs_baseline": round(rate / _common.REFERENCE_MSPS, 1),
            "total_samples": total,
            "blocks": num_blocks,
            "block_shape": [channels, block],
            "scan_mode": f"windowed{geometry}" if geometry else "unsplit",
            **gates,
            "checksums_nonzero": bool(sums_full.any()),
            "backend": device.type,
            **_common.card(device),
            "elapsed_s": round(time.perf_counter() - start, 1),
        }
        failed = [name for name in (*GATES, "checksums_nonzero")
                  if payload[name] is not True]
        if failed:
            payload["error"] = f"failed gates: {', '.join(failed)}"
        return payload

    return _common.run(METRIC, UNIT, body)


if __name__ == "__main__":
    raise SystemExit(main())
