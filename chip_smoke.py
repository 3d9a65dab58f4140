#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Every phase raises on failure, so the process exits non-zero unless all
of them pass:

1. device   CUDA is present; print the card's name and power limit
            (``nvidia-smi``); note whether Pillow is installed.
2. build    compile ``warmup_fir_filter_tpu_torch/csrc/*.cu`` with nvcc
            from a clean build directory, then the host C++ tools of
            ``tools/src`` (``native.py``) with the host compiler; print
            the seconds.
3. kernels  each kernel against its plain PyTorch version (``torch.equal``,
            tolerance 0) over taps × widths × Q-formats and geometries, at
            the main paths' shapes, and against the host golden on the
            small shapes (kernel A either side of its 6-tap short-tap
            crossover and at each chunk count of its digit planes, one to
            five planes, at widths around its 16-byte chunks and row counts
            that fill no whole CTA; kernel C at 258-4,096 taps over widths
            1-40,000 around its 512-column warp item, odd ones starting rows
            misaligned; kernel B either side of its 32-tap route crossover
            and past 4,096 taps, against its plain version on the card, and
            at 19,456 × 8,192 against kernel A at 5 taps and kernel C at 258
            and 4,096 taps, card-side); for the 2-D kernels E, F and G (the
            plain versions run on the card too) the bank and random filters up
            to 33 × 257, F's Lc 86-97 among them, over widths 1-4,099,
            whole frames compared (kernel G within 1 where its f32 sums can
            round).
4. main     the port's CLI (``--backend auto --device cuda``) over a
            synthetic corpus at the reference corpus's size (seven images,
            67,975,252 samples per tap group); every fixed output against
            the host golden; the band kernel must have carried every fixed
            output.  Then the fixed stage alone under the JAX package's
            other backend names, each run's outputs against the golden:
            ``--backend pallas`` (kernel B alone), ``mxu`` (kernel A
            alone) and ``tpu`` (the int32 path, no kernel).
5. stream   ``stream_scanned`` at the geometry of ``bench_streaming.py``
            (16 channels × 4,000,000 samples a block, 252 blocks, 5-tap
            sharpen, Q4.12, blocks from a seeded noise table XOR a per-block
            tweak): the timed scan, kill/resume at the midpoint through a
            checkpoint file, the stitch of the two blocks around it against
            the offline int32 core, and the scan's checksums against
            ``process``; kernels D and A must have carried the scan.
6. stream   the same gates for a 1,001-tap Hamming low-pass over 16
   long    blocks of the same shape, carried by kernel C.
7. 2-D      BASELINE config 3 (5×5 gauss5 over a seeded 512 × 512 image)
   config 3 through ``fir2d_fixed_auto``: bit-exact against the golden,
            RMSE < 0.5 against the ideal golden, kernel F alone; the f32
            model on the card within 1e-2; a 3×129 filter through kernel E
            alone and a 3×258 one through no kernel.
8. 2-D      ``bench_2d.py``'s geometry (8192 × 8192 u8 from its seed):
   frames   five steps of two chained applies through ``scratch`` for
            sharpen5 and gauss5 on the overlapped frame (kernel F), the
            plain frame (kernel E) and the bf16 path (kernel G); each crop
            equal to ``fir2d_fixed_torch`` applied ten times, each frame
            still a frame, kernel G's frames equal to kernel F's.
9. times    CUDA-event medians (per call, over windows of back-to-back
            calls) at 19,456 × 8,192 uint8, Q4.12: kernels A and B (B
            also through ``fir_direct``, which prepares the filter a call),
            B's plain version and the int32 path at 5 taps; kernel A at 3-257
            taps (kernel C's entry on its filters at 33-257 taps, A's
            yardstick) and on the 5-tap stream's window rows; kernels C and B at
            258, 1,001, 2,048 and 4,096 taps, the int32 path over single
            calls, kernel B at 4,097 and 8,193 taps of ``bench_taps.py``'s
            low-pass (each held to its plain version first), and
            kernel C on a 1,001-tap stream block; kernel D and its
            plain version at the stream's geometry; the 5-tap stream's
            per-block split into kernel D, the FIR and the checksums; at
            8192² kernels E, F and G, their plain versions,
            ``fir2d_fixed_torch`` and a frame ``copy_``, and kernel E at
            the 3 × 129 and 3 × 257 filters ``fir2d_fixed_auto`` sends it,
            each first held equal to its plain version on that frame.
10. chain   kernels H (float FIR), I (polyphase resampler) and J (fused
    kernels chain) against their plain versions, which run in float64 on
            the card: H and I over taps × rates × ragged widths and at the
            main path's shapes, SNR >= 120 dB (I also on its compact
            route: 1/16, 1/56 and a 6,001-tap branch at 2/1); J over the
            six geometries of tests/test_chain_fused.py and 1/8 and 1/15
            (the compact route) on FM signals at ragged lengths, SNR >=
            95 dB in "highest" and > 40 dB against the f32 chain in
            "bf16".
11. config  BASELINE config 5 at bench_configs.py's size (16 channels ×
    5       2,000,000 complex f32 samples, seeded as there, and an FM
            signal of the same shape): ``chain_forward`` "auto" through
            kernel J alone, the staged "mxu" path through kernels I and H
            alone, fused within 90 dB SNR of staged, the 2-channel
            message recovery of bench_configs.py:233-249 (corr > 0.99);
            then CUDA-event medians of kernel I on 32 × 2 M, kernel H on
            32 × 1,333,334, the demod, kernel J in both modes, the plain
            versions, ``F.conv1d`` of the 63 taps (TF32 off), the two
            chains end to end and a ``copy_`` of the input.
12. FFT    kernels K (row FFT), L (framed overlap-save filter) and M
    kernels (stream overlap-save filter) against their float64 plain
            versions on the card, SNR >= 120 dB: K over every nfft from 2
            to 16,384 (each its own radix plan) × batches 1, 5, 1,000 ×
            complex, real and inverse rows, also
            within 2e-4·max|want| of the float64 FFT; L over pinned nfft
            128-4,096 × 2, 9, 63 taps and 259 and 2,048 taps at their
            automatic nfft; M over the stream cases of
            tests/test_fft_pallas.py:166-176 and T ∈ {1, 511, 40,001}; u8
            outputs within 1 of the plain version's on under 0.1%.
13. config  BASELINE config 4 at bench_configs.py:167-178's size (16 ×
    4       10,000,000 u8 from seed 4, widened to f32 on the card,
            ``design_lowpass(63, 0.25)``): ``fir_overlap_save_pallas``
            through kernel M alone, SNR > 70 dB against a float64 FIR on
            the card (the config's gate) and >= 90 dB against the
            ``torch.fft`` overlap-save; the shard-local call over 4 blocks
            of 2,500,000 with 31-sample halos (``off=31``) within 90 dB of
            it; the quantized u8 path through kernel M against kernel A
            (within 1 on under 2%); the filter's frequency response
            measured through ``fft_rows_pallas`` (kernel K) within 1e-3 of
            the design; the chain on config 5's planes with the
            ``"pallas"`` channelizer (kernels I and M) and a 259-tap
            ``"auto"`` one (I and L); then CUDA-event medians of K (at
            8,192 × 2,048, 1,024 × 16,384 and 65,536 × 256), L and M,
            their plain versions, ``torch.fft.fft``, ``F.conv1d`` (TF32
            off), the ``torch.fft`` overlap-save and a ``copy_``.
14. parallel the ``parallel/`` entries in a world of 1 (a real NCCL group
            from ``initialize_multihost``, meshes {"data": 1, "time": 1}
            and {"stage": 1}) at full width: config 4 through
            ``fir_overlap_save_sharded(backend="pallas")`` (kernel M; > 70
            dB against the float64 FIR, within 2e-2 of the unsharded
            call) and a 259-tap filter on its first 1,000,000 samples
            (kernel L); ``fir1d_fixed_sharded`` at 19,456 × 8,192 (kernel
            A), ``fir2d_fixed_sharded`` at 8192² sharpen5 (kernel F) and
            a random 3 × 129 filter (kernel E), the
            ``channel_to_time``/``time_to_channel`` round trip, the 5-tap
            bank through ``filter_bank_fixed_sharded`` and
            ``spmd_pipeline`` (kernel A), ``chain_forward_sharded`` and
            ``chain_forward_time_sharded`` on config 5 cut to 16 ×
            1,999,872 (kernel J), each ``torch.equal`` to the unsharded
            call; then four emulated time shards (2 × 2 for the 2-D FIR),
            each extended block sliced from the global tensor with zero
            edges, through the entries' shard-local steps: config 4
            through kernel M at ``off = 31`` under the same gates, and
            kernels A, F and J ``torch.equal`` to their unsharded calls;
            ``PipelinedChain`` over config 5 in eight microbatches
            (resample, channelizer, demod on three CUDA streams),
            pipelined equal to ``force_sequential``, both wall times
            printed; CUDA-event medians of each sharded call beside the
            unsharded one.  Multi-rank exchange over NCCL needs a card a
            rank: ``tests/test_torch_parallel_worker.py worlds cuda``
            runs it on four.
15. tools   the ported host tools and checks: kernel A at 19,456 × 8,192
            (5-tap sharpen, Q4.12) bit for bit against the C++ oracle
            (``fir1d_fixed_rows_native``, ``bit_compare_u8``; its host
            time printed); kernel K against ``fft_radix2_native`` on one
            16,384-point complex row (>= 120 dB); each of the fourteen
            kernels byte-identical over two runs of its entry
            (``assert_deterministic``); under ``nan_guard`` config 5 cut
            to 16 × 200,000 through ``chain_forward`` "auto" (J) and
            staged (I, H), config 4's entry (M) and ``fft_rows_pallas``
            (K) run clean, while a CUDA ``0/0`` and kernels H and K over
            a row holding one NaN raise ``FloatingPointError``; phase 4's
            fixed stage again with ``--backend auto --profile``: the same
            bytes, at least one kernel-A event a fixed output in the
            trace, whose device busy share (the union of kernel and
            memcpy intervals over the traced window) is printed; and
            ``chained_throughput`` on kernel A's headline step, within 2×
            of phase 9's median.
16. benches kernel N (``copy_rows_``, the in-place copy) ``torch.equal`` to
            ``copy_rows_plain`` at the roofline's 5,120, 20,480 and 81,920
            rows of 8,192 bytes, at one row, widths 1-47, rows that fill no
            whole CTA and views starting 1-15 bytes past a 16-byte
            boundary, with the same tensor back and one launch a call,
            and at each of them out of place too (``wft_copy_rows`` into
            a destination that held the complement, between untouched
            guard bytes, so a dropped head, tail or chunk shows);
            its median time at 81,920 × 8,192 beside ``dst.copy_(x)`` and
            its bound, refused under 0.95 of the bound (a copy that never
            reached memory); then the seven ported benches
            (``warmup_fir_filter_tpu_torch/benches/``) in their quick
            forms through their ``main`` in this process (the scaling
            bench's three modes over a world of one on NCCL), each JSON
            line parsed, every gate held and the kernels of each run
            launched.

Launch counts are zeroed just before each main path (phases 4-8, 11, 13,
14, 15's traced fixed stage and each bench of 16) and read just after
it.  Then one JSON line for the kernels (each with its
time, its plain version's, its bound at the card's published peaks and,
where one PyTorch call computes the same function, that call's time), the
card line, and as the last line ``{"ok": true, "device": {...}}``.  Inputs
come from numpy/torch generators seeded with ``SEED``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch import _build, native
from warmup_fir_filter_tpu_torch.cli import main as cli_main
from warmup_fir_filter_tpu_torch.benches import (
    bench,
    bench_2d,
    bench_configs,
    bench_roofline,
    bench_scaling,
    bench_streaming,
    bench_taps,
)
from warmup_fir_filter_tpu_torch.benches.bench_configs import (
    ideal_rows64,
    snr_on_device,
)
from warmup_fir_filter_tpu_torch.benches.bench_streaming import (
    stitch,
    stream_source,
)
from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
    FusedChain,
    chain_forward_fused,
    chain_fused,
    chain_fused_plain,
)
from warmup_fir_filter_tpu_torch.kernels.copy_rows import (
    copy_rows_,
    copy_rows_plain,
)
from warmup_fir_filter_tpu_torch.kernels.dispatch import (
    fir1d_fixed_rows_auto,
    fir2d_fixed_auto,
    prepare_fixed_fir2d,
)
from warmup_fir_filter_tpu_torch.kernels.fft import (
    STREAM_NFFT,
    FilterSpectrum,
    _osfilt_segments,
    _stream_geometry,
    _u8_stage,
    _zero_extended,
    fft_rows,
    fft_rows_pallas,
    fft_rows_plain,
    fir_overlap_save_pallas,
    fir_overlap_save_quantized_pallas,
    fir_overlap_save_stream,
    osfilt,
    osfilt_plain,
    osfilt_stream,
    osfilt_stream_plain,
    stream_plan,
)
from warmup_fir_filter_tpu_torch.kernels.fir2d import (
    FixedFir2d,
    bf16_2d_exact,
    crop_frame_overlap,
    fir2d_bf16,
    fir2d_bf16_plain,
    fir2d_fixed_frame,
    fir2d_fixed_frame_overlap,
    fir2d_frame,
    fir2d_frame_overlap_bf16,
    fir2d_frame_plain,
    fir2d_oframe,
    fir2d_oframe_plain,
    pad_frame,
    pad_frame_overlap,
)
from warmup_fir_filter_tpu_torch.kernels.fir_band import (
    MAX_TAPS as BAND_MAX_TAPS,
    SHORT_MAX_TAPS as BAND_SHORT_MAX_TAPS,
    FixedFir1d,
    fir_band,
    fir_band_plain,
)
from warmup_fir_filter_tpu_torch.kernels.fir_direct import (
    FixedFirDirect,
    fir1d_fixed_rows_pallas,
    fir_direct,
    fir_direct_plain,
)
from warmup_fir_filter_tpu_torch.kernels.fir_float import (
    FloatFir1d,
    fir1d_ideal_rows_band,
    fir_float,
    fir_float_plain,
)
from warmup_fir_filter_tpu_torch.kernels.fir_window import (
    FixedFirWindow,
    fir1d_fixed_rows_mxu_window,
    fir_window,
    fir_window_plain,
)
from warmup_fir_filter_tpu_torch.kernels.resample import (
    PolyphaseResampler,
    resample,
    resample_plain,
    resample_poly_band,
)
from warmup_fir_filter_tpu_torch.kernels.window_copy import (
    window_rows,
    window_rows_pallas,
    window_rows_plain,
)
from warmup_fir_filter_tpu_torch.models.chain import (
    ChainConfig,
    _chain_time_local,
    chain_forward,
    chain_forward_sharded,
    chain_forward_time_sharded,
)
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu_torch.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu_torch.ops.demod import fm_demodulate, fm_modulate
from warmup_fir_filter_tpu_torch.ops.fftfilt import fir_overlap_save, pick_nfft
from warmup_fir_filter_tpu_torch.ops.fir1d import (
    fir1d_fixed_rows_torch,
    fir1d_ideal_rows_torch,
)
from warmup_fir_filter_tpu_torch.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_golden,
    fir2d_fixed_torch,
    fir2d_ideal_golden,
    fir2d_ideal_torch,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.resample import _plan, design_lowpass
from warmup_fir_filter_tpu_torch.ops.streaming import (
    Fir1DStream,
    FirStreamState,
    _checksum_weights,
    _weighted_sums,
    _windowed_column_sums,
    host_emit_checksums,
    pick_window_split,
    stream_scanned,
)
from warmup_fir_filter_tpu_torch.parallel import (
    PipelinedChain,
    channel_to_time,
    filter_bank_fixed_sharded,
    fir1d_fixed_sharded,
    fir2d_fixed_sharded,
    fir_overlap_save_sharded,
    initialize_multihost,
    make_mesh,
    spmd_pipeline,
    time_to_channel,
)
from warmup_fir_filter_tpu_torch.parallel.fft_sharded import (
    LocalOverlapSave,
    _overlap_save_local,
)
from warmup_fir_filter_tpu_torch.parallel.halo import (
    _fir1d_local,
    _fir2d_local,
    _margins_2d,
)
from warmup_fir_filter_tpu_torch.pipeline.artifacts import (
    ArtifactStore,
    save_npy,
    write_json,
)
from warmup_fir_filter_tpu_torch.pipeline.synthetic import (
    _render as render_image,
)
from warmup_fir_filter_tpu_torch.utils.benchmarking import chained_throughput
from warmup_fir_filter_tpu_torch.utils.debugging import (
    assert_deterministic,
    nan_guard,
)
from warmup_fir_filter_tpu_torch.utils.imageio import save_gray_png
from yardsticks import conv1d_resample, conv1d_resampler

SEED = 20261016
#: Host clock at import: the phases print their start against it.
START = time.perf_counter()
REPO_ROOT = Path(__file__).resolve().parent
WORK_DIR = REPO_ROOT / "artifacts" / "chip_smoke"

#: (coeff_bits, frac_bits, acc_bits) of the SWEEP cells of
#: tests/test_qformat_sweep.py:30-40 (wrap-needing and multi-digit ones).
FORMATS = ((8, 4, 32), (8, 7, 16), (16, 12, 32), (16, 12, 20), (16, 8, 24),
           (16, 15, 31), (32, 24, 32), (32, 12, 28), (16, 1, 8))
#: Kernel A's grid: its short-tap route up to 6 taps, the digit planes
#: beyond (6 and 7 either side of the crossover, one chunk to 17 taps, two
#: at 24-33, 63-65 either side of three chunks, nine at 256-257); widths at
#: the 16-byte chunk and around it (15, 16, 17, 31), ragged ones, one past
#: the digit planes' 1,024-column item, the stream's window rows (16,256)
#: and K2's regime.
BAND_TAPS = (1, 2, 3, 4, 5, 6, 7, 16, 24, 32, 33, 63, 64, 65, 129, 256, 257)
BAND_WIDTHS = (1, 15, 16, 17, 31, 64, 127, 150, 400, 1025, 4499, 8192,
               16256, 32768, 32769, 40000)
#: Rows of kernel A's grid up to this width: no multiple of a CTA's four
#: warps (digit planes) or chunks (512 of 16 bytes, short taps).
BAND_ODD_ROWS = 13
BAND_ODD_ROWS_MAX_WIDTH = 127
#: Kernel A's timed tap counts at BENCH_SHAPE: the banks, either side of
#: the short-tap crossover (6, 7), and the digit planes' range.
BAND_TIMING_TAPS = (3, 5, 6, 7, 16, 32, 33, 63, 129, 257)
#: Kernel A's digit-plane tap counts at which kernel C's entry, which takes
#: them too, is timed beside it on the same filter: A's yardstick.
BAND_YARDSTICK_TAPS = (33, 63, 129, 257)
DIRECT_TAPS = (1, 5, 32, 33, 258, 300, 4097, 5000)
DIRECT_WIDTHS = (1, 127, 4499, 40000)
#: Kernel B against the kernel whose core each of its routes runs, at
#: BENCH_SHAPE: A (short route), C (chunk route, one and two chunks).
DIRECT_AGAINST = ((5, FixedFir1d), (258, FixedFirWindow),
                  (4096, FixedFirWindow))
#: Kernel B's timed tap counts past kernel C's 4,096, with bench_taps.py's
#: filter (design_lowpass(L, 0.25), Q4.12).
DIRECT_TIMING_TAPS = (4097, 8193)
#: Rows of kernel B's plain version on the card at a time (float64 windows).
DIRECT_PLAIN_ROWS = 1024
ROWS = 4
GOLDEN_MAX_WIDTH = 4499
#: The seven images of the reference corpus by size (W×H 1280×853,
#: 640×762, 1280×854, 64×64, 64×64 noise, 4499×2999, 1280×641), rendered
#: by the reference's synthetic generator as (rows, cols).  Its "stripes"
#: kind renders a single row whatever the shape, so it is not used.
CORPUS = (
    ("img_001_gradient", "gradient", (853, 1280)),
    ("img_002_checker", "checker", (762, 640)),
    ("img_003_steps", "steps", (854, 1280)),
    ("img_004_tiny", "gradient", (64, 64)),
    ("img_005_noise", "noise", (64, 64)),
    ("img_006_large_mix", "mix", (2999, 4499)),
    ("img_007_checker", "checker", (641, 1280)),
)
FIXED_OUTPUTS = len(CORPUS) * 4 * 2  # images × filters × tap groups
#: Phase 4's fixed-stage runs after the pipeline: (--backend, the one
#: kernel that must carry every fixed output, or None for no kernel).
FIXED_STAGE_RUNS = (("pallas", "fir_direct"), ("mxu", "fir_band"),
                    ("tpu", None))
BENCH_SHAPE = (19456, 8192)
TIMING_WARMUP = 2
TIMING_REPS = 7      # timed windows per path; the median is reported
TIMING_LAUNCHES = 10  # back-to-back calls per window
#: Kernel C's grid over K3's tap range, 258-4,096.
WINDOW_TAPS = (258, 300, 511, 1001, 2048, 4096)
#: Kernel C's widths: odd ones start rows misaligned; 511-513 around the
#: 512-column warp item.
WINDOW_WIDTHS = (1, 17, 64, 127, 511, 512, 513, 1500, 4499, 40000)
#: Kernel D's geometries (channels, T, sub, g_windows, taps of the carry):
#: T == sub, the L = 1 and L = 129 delay lines, and the stream's own.
COPY_GEOMETRIES = ((4, 512, 512, 1, 5), (4, 16384, 512, 16, 1),
                   (4, 16384, 512, 16, 129), (3, 1024, 256, 2, 129),
                   (16, 4_000_000, 16_000, 10, 5))
#: The stream of bench_streaming.py:36-38: 16 channels × 4,000,000 samples
#: a block, 252 blocks (16.128e9 samples), 5-tap sharpen, Q4.12.
STREAM_CHANNELS = 16
STREAM_BLOCK = 4_000_000
STREAM_BLOCKS = 252
#: The long-tap stream: a 1,001-tap Hamming low-pass, cutoff 0.2.
LONG_TAPS = 1001
LONG_BLOCKS = 16
LONG_TIMING_TAPS = (258, 1001, 2048, 4096)
LONG_TIMING_REPS = 5
LONG_TIMING_LAUNCHES = 2
PLAIN_LONG_CALLS = 3
#: Blocks of the step-split loop, and the first ones left out of it.
STEP_BLOCKS = 60
STEP_SKIP = 10
#: Kernels E, F and G's grid: random filters (F's Lc 86-97, where its
#: stride falls below left + center, and its widest; E just past it, E's
#: widest and tallest) beside the bank, Q4.12 with a 32- and an 18-bit
#: accumulator, widths around a tile, 70 rows over 16-row blocks.
GRID_2D_SHAPES = ((2, 4), (9, 3), (3, 86), (2, 87), (17, 91), (5, 97),
                  (3, 98), (33, 257))
GRID_2D_FORMATS = ((16, 12, 32), (16, 12, 18))
GRID_2D_WIDTHS = (1, 127, 128, 700, 4099)
GRID_2D_HEIGHT = 70
GRID_2D_BLOCK_ROWS = 16
GOLDEN_2D_MAX_WIDTH = 700
#: BASELINE config 3 as bench_configs.py:72-92 runs it.
CONFIG3_SEED = 3
CONFIG3_SHAPE = (512, 512)
#: bench_2d.py's geometry: an 8192 × 8192 u8 image from its seed, chained
#: two applies a step, the dead frame as the second apply's scratch.
FRAME_SIZE = 8192
FRAME_SEED = 20260819
FRAME_STEPS = 5
FRAME_TIMING_LAUNCHES = 10
PLAIN_2D_CALLS = 2
#: The column widths fir2d_fixed_auto sends to kernel E (98 <= Lc <= 257):
#: config 3's 3 × 129 check and the widest band, 3 × 257, timed at 8192².
E_TIMING_SHAPES = ((3, 129), (3, 257))
#: Kernels H and I's grid: (taps, up, down) over ragged widths, u8 and f32
#: rows for H; I's 1/16 and 1/56 take its compact route.
FLOAT_TAPS = (1, 2, 5, 63, 64, 129, 257)
FLOAT_WIDTHS = (1, 1023, 1025, 40001)
RESAMPLE_RATES = ((2, 3, 63), (4, 3, 47), (2, 1, 33), (8, 5, 63), (1, 2, 31),
                  (2, 3, 95), (2, 3, 160), (1, 16, 63), (1, 56, 63))
#: Kernel I with a long branch (up, down, taps): 15,000 taps a branch at
#: 2/1, past the tiled route's shared memory, on the compact route.  Its
#: f32 sums of 15,000 products cannot reach 120 dB against float64; each
#: output is held to the bound of a recursive f32 sum instead.
RESAMPLE_LONG_BRANCH = (2, 1, 29999)
RESAMPLE_WIDTHS = (1, 1535, 1537, 40001)
#: Kernel J's geometries (up, down, rs_taps, ch_taps, channels), those of
#: tests/test_chain_fused.py:122-129, at lengths past two tiles, ragged.
CHAIN_GEOMETRIES = ((2, 3, 63, 63, 8), (4, 3, 47, 31, 8), (2, 1, 33, 97, 8),
                    (8, 5, 63, 129, 16), (1, 2, 31, 63, 8),
                    (2, 3, 95, 63, 24))
#: Kernel J on the compact route: 1/8 and 1/15 (the lowest rate
#: chain_fused_supported admits at P = 1).  Their planes carry an FM
#: signal narrowed by P/Q, so that it fits the band the chain keeps as
#: config 5's fits its own: the bf16 bound assumes a band-limited signal,
#: and the plain versions' bf16 and f32 chains part (16 dB at 1/8) on one
#: wider than the band.
CHAIN_LOW_RATES = ((1, 8, 63, 63, 8), (1, 15, 63, 63, 8))
#: BASELINE config 5 as bench_configs.py:283-287 runs it: 16 channels ×
#: 2,000,000 complex f32 samples from seed 5.
CONFIG5_CHANNELS = 16
CONFIG5_TIME = 2_000_000
CONFIG5_SEED = 5
CHAIN_TIMING_REPS = 7
CHAIN_TIMING_LAUNCHES = 5
PLAIN_CHAIN_CALLS = 2
#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates):
#: device memory bytes/s and operations/s by type, at the 700 W limit.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
KERNELS = ("fir_band", "fir_direct", "fir_window", "window_rows",
           "fir2d_frame", "fir2d_oframe", "fir2d_bf16", "fir_float",
           "resample", "chain_fused", "fft_rows", "osfilt", "osfilt_stream",
           "copy_rows")
#: Kernel K's grid (nfft × batch, complex, real and inverse rows) and
#: kernel L's (every nfft, so each last-pass radix 2, 4, 8 and 16 and the
#: 1,024-thread 16,384 plan, × the taps that fit, then long filters at
#: their automatic nfft: 4,096 and 16,384).
FFT_SIZES = tuple(1 << b for b in range(1, 15))  # each has its radix plan
FFT_BATCHES = (1, 5, 1000)
OSFILT_SIZES = FFT_SIZES
OSFILT_TAPS = (2, 9, 63)
OSFILT_LONG_TAPS = (259, 2048)
OSFILT_SEGMENTS = 1001
#: Kernel M's (C, T, L, off): tests/test_fft_pallas.py:166-176, then
#: T ∈ {1, 511, 40,001} at 63 taps, then the edges of its window plan
#: (``stream_plan``): hop 512 (L = 1), an even L, hop 384 and 256 (L =
#: 129, 257), T = 449, 450 and 451 at a hop of 450, off = 31 and 62.
STREAM_FFT_CASES = ((3, 2000, 63, 0), (2, 1111, 63, 31), (1, 700, 5, 0),
                    (4, 4096, 129, 64), (2, 900, 257, 128), (2, 513, 63, 62),
                    (3, 300, 63, 0), (2, 257, 1, 0), (2, 1, 63, 0),
                    (2, 511, 63, 0), (2, 40001, 63, 0),
                    (2, 3000, 1, 0), (2, 3000, 2, 0), (2, 3000, 129, 0),
                    (2, 3000, 257, 0), (2, 449, 63, 0), (2, 450, 63, 0),
                    (2, 451, 63, 0), (2, 3000, 63, 31), (2, 3000, 63, 62))
#: BASELINE config 4 as bench_configs.py:167-178 runs it: 16 × 10,000,000
#: u8 from seed 4, 63-tap low-pass at 0.25; the shard-local call over 4
#: time blocks; the framed kernel L timed at a pinned nfft.
CONFIG4_CHANNELS = 16
CONFIG4_TIME = 10_000_000
CONFIG4_SEED = 4
CONFIG4_TAPS = 63
CONFIG4_SHARDS = 4
CONFIG4_PINNED_NFFT = 2048
#: Rows of the frequency-response measurement through kernel K.
RESPONSE_NFFT = 8192
#: Kernel K's timed shapes (rows, nfft), complex: the first is the
#: kernels line's headline.
FFT_TIMING_SHAPES = ((8192, 2048), (1024, 16384), (65536, 256))
FFT_TIMING_REPS = 7
FFT_TIMING_LAUNCHES = 5
PLAIN_FFT_CALLS = 2
#: Phase 14: the parallel/ entries in a world of 1 and PARALLEL_SHARDS
#: emulated time shards.  Config 5 is cut to 1,999,872 samples so that
#: each of four shards (499,968 = 192·2,604) keeps the polyphase phase
#: and the 128-tile output grid; the 259-tap overlap-save (kernel L, past
#: kernel M's 257) runs on the first PARALLEL_LONG_TIME samples of config
#: 4; the pipeline splits config 5 into microbatches of two channels.
PARALLEL_SHARDS = 4
PARALLEL_CHAIN_TIME = 1_999_872
PARALLEL_HALO_MULT = 4
PARALLEL_LONG_TAPS = 259
PARALLEL_LONG_TIME = 1_000_000
PARALLEL_MICROBATCHES = 8
PARALLEL_SPMD_MICROBATCHES = 8
PARALLEL_TIMING_REPS = 5
PARALLEL_TIMING_CALLS = 3
#: Phase 15: the native FFT's row against kernel K, the determinism
#: shapes' long filters, the guarded runs' cuts of configs 5 and 4, and
#: ``chained_throughput``'s sweeps.
NATIVE_FFT_POINTS = 16384
DIRECT_DETERMINISM_TAPS = 4097
OSFILT_DETERMINISM_TAPS = 259
GUARD_CHAIN_TIME = 200_000
GUARD_CONFIG4_TIME = 1_000_000
CHAINED_BEST_OF = 3
#: Phase 16: kernel N at the roofline's sizes (40, 160 and 640 MB of
#: 8,192-byte rows) and at awkward shapes (rows × width, then the byte
#: offsets of views that start off a 16-byte boundary); its timed shape;
#: the least share of its bound a time may show before the copy is taken
#: to have vanished.
COPY_ROWS = (5120, 20480, 81920)
COPY_SHAPES = ((1, 1), (1, 8192), (1, 4099), (3, 1000), (7, 4099),
               *((3, width) for width in range(1, 48)))
COPY_OFFSETS = tuple(range(1, 16))
COPY_TIMING_SHAPE = (81920, 8192)
COPY_MIN_BOUND_SHARE = 0.95
#: Kernel N out of place: the guard bytes each side of the destination,
#: and the value they hold, which the copy must leave untouched.
COPY_GUARD, COPY_SENTINEL = 64, 0xA5
#: Each bench in its quick form, as phase 16 calls its ``main``, and the
#: kernels its run must launch.
BENCH_RUNS = (
    ("bench_roofline", bench_roofline.main, ["--quick"],
     ("copy_rows", "fir_band")),
    ("bench", bench.main, ["--quick"],
     ("fir_band", "copy_rows", "fir_direct")),
    ("bench_taps", bench_taps.main, ["--quick"], ("fir_band", "fir_window")),
    ("bench_streaming", bench_streaming.main, ["--quick"],
     ("window_rows", "fir_band")),
    ("bench_2d", bench_2d.main, ["--quick"],
     ("fir2d_oframe", "fir2d_frame", "fir2d_bf16")),
    ("bench_configs", bench_configs.main, ["--quick"],
     ("fir_band", "fir2d_oframe", "osfilt_stream", "chain_fused", "resample",
      "fir_float")),
    ("bench_scaling_overhead", bench_scaling.main,
     ["--mode", "overhead", "--backend", "nccl"], ("fir_band",)),
    ("bench_scaling_weak", bench_scaling.main,
     ["--mode", "weak", "--backend", "nccl"], ("fir_band",)),
    ("bench_scaling_pp", bench_scaling.main,
     ["--mode", "pp", "--backend", "nccl"], ()),
)
#: Kernel A's ``__global__`` names (``csrc/fir_band.cu:74``, ``:136``) as
#: they appear in a trace's kernel events.
KERNEL_A_NAMES = ("fir_band_planes_kernel", "fir_band_short_kernel")


def phase(name: str) -> None:
    print(f"[chip_smoke] phase {name} (at {time.perf_counter() - START:.1f} s)",
          flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    return {"fir_band": fir_band.launches, "fir_direct": fir_direct.launches,
            "fir_window": fir_window.launches,
            "window_rows": window_rows.launches,
            "fir2d_frame": fir2d_frame.launches,
            "fir2d_oframe": fir2d_oframe.launches,
            "fir2d_bf16": fir2d_bf16.launches,
            "fir_float": fir_float.launches, "resample": resample.launches,
            "chain_fused": chain_fused.launches,
            "fft_rows": fft_rows.launches, "osfilt": osfilt.launches,
            "osfilt_stream": osfilt_stream.launches,
            "copy_rows": copy_rows_.launches}


def reset_launch_counts() -> None:
    fir_band.launches = fir_direct.launches = 0
    fir_window.launches = window_rows.launches = 0
    fir2d_frame.launches = fir2d_oframe.launches = fir2d_bf16.launches = 0
    fir_float.launches = resample.launches = chain_fused.launches = 0
    fft_rows.launches = osfilt.launches = osfilt_stream.launches = 0
    copy_rows_.launches = 0


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of ``nbytes`` at the
    published memory rate and ``ops`` at the published peak for their
    type."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


def finite(value: float) -> float | None:
    """``value``, or None where it is infinite (strict JSON has no inf)."""
    return value if np.isfinite(value) else None


def only(counts: dict, name: str, at_least: int, label: str) -> None:
    """Raise unless kernel ``name`` ran ``at_least`` times and no other."""
    if counts[name] < at_least or any(
            counts[other] for other in KERNELS if other != name):
        raise AssertionError(f"{label} launches {counts}: expected {name} "
                             f">= {at_least} and no other kernel")


def random_taps(rng: np.random.Generator, qf, num_taps: int) -> np.ndarray:
    """Taps spread over the format's range, as the sweep tests draw them."""
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps),
                   max(qf.min_coeff_real, -8.0), span)


class Agreement:
    """Counts kernel-vs-plain comparisons and their largest difference."""

    def __init__(self):
        self.count = 0
        self.max_abs_err = 0

    def check(self, got, want, label: str, tolerance: int = 0) -> None:
        got = got.to(want.device)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.count += 1
        ok = (torch.equal(got, want) if tolerance == 0
              else got.shape == want.shape and err <= tolerance)
        if not ok:
            raise AssertionError(f"{label}: kernel != plain (max |diff| {err}, "
                                 f"tolerance {tolerance})")


def check_kernels(agree: dict) -> None:
    agree_band, agree_direct = agree["fir_band"], agree["fir_direct"]
    golden = fir1d_fixed_golden_rows
    rng = np.random.default_rng(SEED)

    def gate_golden(got, x, h, qf, label):
        if x.shape[1] <= GOLDEN_MAX_WIDTH and not np.array_equal(
                got.cpu().numpy(), golden(x, h, qf)):
            raise AssertionError(f"{label}: kernel != host golden")

    cells = [(QFormat(*f), L, random_taps(rng, QFormat(*f), L))
             for f in FORMATS for L in BAND_TAPS]
    # Q4.12 moving average: 1365 needs two digit planes.
    cells.append((QFormat(), 3, np.asarray(FILTER_BANKS[3]["moving_avg"])))
    for qf, num_taps, h in cells:
        fir = FixedFir1d.from_numpy(h, qf, "cuda")
        fir_cpu = FixedFir1d.from_numpy(h, qf, "cpu")
        for n in BAND_WIDTHS:
            rows = BAND_ODD_ROWS if n <= BAND_ODD_ROWS_MAX_WIDTH else ROWS
            x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
            label = (f"band L={num_taps} {rows}x{n} fmt=({qf.coeff_bits},"
                     f"{qf.frac_bits},{qf.acc_bits})")
            got = fir(torch.from_numpy(x).cuda())
            agree_band.check(got, fir_band_plain(torch.from_numpy(x),
                                                        fir_cpu), label)
            gate_golden(got, x, h, qf, label)
    for f in FORMATS:
        qf = QFormat(*f)
        for num_taps in DIRECT_TAPS:
            h = random_taps(rng, qf, num_taps)
            fir = FixedFirDirect(h, qf, "cuda")
            for n in DIRECT_WIDTHS:
                x = torch.from_numpy(rng.integers(
                    0, 256, size=(ROWS, n), dtype=np.uint8)).cuda()
                label = f"direct L={num_taps} N={n} fmt={f}"
                got = fir_direct(x, h, qf)
                agree_direct.check(got, fir_direct_plain(x, fir), label)
                gate_golden(got, x.cpu().numpy(), h, qf, label)
    for f in FORMATS:
        qf = QFormat(*f)
        for num_taps in WINDOW_TAPS:
            h = random_taps(rng, qf, num_taps)
            fir = FixedFirWindow.from_numpy(h, qf, "cuda")
            fir_cpu = FixedFirWindow.from_numpy(h, qf)
            for n in WINDOW_WIDTHS:
                x = rng.integers(0, 256, size=(ROWS, n), dtype=np.uint8)
                label = f"window L={num_taps} N={n} fmt={f}"
                got = fir(torch.from_numpy(x).cuda())
                agree["fir_window"].check(
                    got, fir_window_plain(torch.from_numpy(x), fir_cpu), label)
                gate_golden(got, x, h, qf, label)
    for channels, total, sub, g, num_taps in COPY_GEOMETRIES:
        x = torch.from_numpy(rng.integers(0, 256, size=(channels, total),
                                          dtype=np.uint8))
        carry = torch.zeros((channels, 128), dtype=torch.uint8)
        if num_taps > 1:
            carry[:, 128 - (num_taps - 1):] = torch.from_numpy(rng.integers(
                0, 256, size=(channels, num_taps - 1), dtype=np.uint8))
        agree["window_rows"].check(
            window_rows(x.cuda(), carry.cuda(), sub, g),
            window_rows_plain(x, carry, sub, g),
            f"window_rows C={channels} T={total} sub={sub} L={num_taps}")
    print(f"[chip_smoke] grid: band {agree_band.count} cells, direct "
          f"{agree_direct.count}, window {agree['fir_window'].count}, "
          f"window_rows {agree['window_rows'].count}, all torch.equal",
          flush=True)
    check_kernels_2d(agree, rng)

    # The main path's own shapes and filters.
    qf = QFormat()
    for shape in sorted({spec[2] for spec in CORPUS}):
        x = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
        xd = x.cuda()
        for tap in (3, 5):
            for name, h in FILTER_BANKS[tap].items():
                label = f"{name} {tap}tap shape={shape}"
                agree_band.check(
                    FixedFir1d.from_numpy(h, qf, "cuda")(xd),
                    fir_band_plain(x, FixedFir1d.from_numpy(h, qf)),
                    f"band {label}")
                agree_direct.check(
                    fir_direct(xd, h, qf),
                    fir_direct_plain(xd, FixedFirDirect(h, qf, "cuda")),
                    f"direct {label}")
    check_stream_shapes(agree, rng)
    check_direct_against_a_and_c(agree_direct)
    torch.cuda.synchronize()
    print("[chip_smoke] kernels: " + ", ".join(
        f"{name} {a.count} comparisons" for name, a in agree.items())
        + f"; max |diff| {max(a.max_abs_err for a in agree.values())}",
        flush=True)


def check_direct_against_a_and_c(agree: Agreement) -> None:
    """Kernel B against the kernels whose cores its two routes run, on the
    card at BENCH_SHAPE (``torch.equal``, no host golden): kernel A at 5
    taps (the short route), kernel C at 258 and 4,096 taps (the chunk
    route, one and two chunks)."""
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    for num_taps, other in DIRECT_AGAINST:
        h = (np.asarray(FILTER_BANKS[5]["sharpen"]) if num_taps == 5
             else design_lowpass(num_taps, 0.2))
        agree.check(FixedFirDirect(h, qf, "cuda")(x),
                    other.from_numpy(h, qf, "cuda")(x),
                    f"direct vs {other.__name__} L={num_taps} {BENCH_SHAPE}")


def check_rows(agree: Agreement, got: torch.Tensor, x: torch.Tensor, plain,
               chunk: int, label: str) -> None:
    """``got`` against ``plain`` over row chunks of ``x`` (rows filter
    independently), so the plain version's memory stays bounded."""
    got = got.cpu()
    for r0 in range(0, x.shape[0], chunk):
        agree.check(got[r0 : r0 + chunk], plain(x[r0 : r0 + chunk]),
                    f"{label} rows {r0}..")


def check_stream_shapes(agree: dict, rng: np.random.Generator) -> None:
    """Kernels A and C at the shapes the stream phases give them: the
    5-tap windowed step's (4,000, 16,256) rows and the long-tap unsplit
    step's carry-extended (16, 4,001,000) block."""
    qf = QFormat()
    sub, _ = pick_window_split(STREAM_CHANNELS, STREAM_BLOCK, 5)
    h = np.asarray(FILTER_BANKS[5]["sharpen"])
    x = torch.from_numpy(rng.integers(
        0, 256, size=(STREAM_CHANNELS * STREAM_BLOCK // sub, sub + 256),
        dtype=np.uint8))
    fir_cpu = FixedFir1d.from_numpy(h, qf)
    check_rows(agree["fir_band"], FixedFir1d.from_numpy(h, qf, "cuda")(x.cuda()),
               x, lambda rows: fir_band_plain(rows, fir_cpu), 500,
               f"band stream windows {tuple(x.shape)}")
    h = design_lowpass(LONG_TAPS, 0.2)
    x = torch.from_numpy(rng.integers(
        0, 256, size=(STREAM_CHANNELS, STREAM_BLOCK + LONG_TAPS - 1),
        dtype=np.uint8))
    fir_cpu = FixedFirWindow.from_numpy(h, qf)
    check_rows(agree["fir_window"],
               FixedFirWindow.from_numpy(h, qf, "cuda")(x.cuda()), x,
               lambda rows: fir_window_plain(rows, fir_cpu), 1,
               f"window stream block {tuple(x.shape)}")


def random_taps_2d(rng: np.random.Generator, shape) -> np.ndarray:
    """Taps of both signs scaled by 1/sqrt(Lr·Lc), so that a filter's
    outputs spread over the u8 range instead of saturating."""
    return rng.uniform(-1.0, 1.0, size=shape) * 2.0 / np.sqrt(np.prod(shape))


def bf16_sums_exact(fir: FixedFir2d) -> bool:
    """Whether kernel G's f32 sums are all exact integers (below 2^24), so
    any order of summation gives the same frame."""
    return 255 * float(fir.bf16_rows.double().abs().sum()) < 2 ** 24


def frame_of(kind: str, x: torch.Tensor, taps, block_rows=None):
    """``(frame, core, block_rows)`` of the layout a kernel takes."""
    if kind == "fir2d_frame":
        frame, geo = pad_frame(x, taps[0], block_rows=block_rows)
    else:
        frame, geo = pad_frame_overlap(x, *taps, block_rows=block_rows)
    return frame, geo[:3], geo[3]


def crop_of(kind: str, frame: torch.Tensor, taps, core) -> torch.Tensor:
    t0, h_img, w_img = core
    if kind == "fir2d_frame":
        return frame[t0 : t0 + h_img, 128 : 128 + w_img]
    return crop_frame_overlap(frame, taps[1], core)


KERNELS_2D = {"fir2d_frame": (fir2d_frame, fir2d_frame_plain),
              "fir2d_oframe": (fir2d_oframe, fir2d_oframe_plain),
              "fir2d_bf16": (fir2d_bf16, fir2d_bf16_plain)}


def check_2d(agree: dict, kind: str, x: torch.Tensor, fir: FixedFir2d,
             label: str, block_rows=None) -> torch.Tensor:
    """One kernel apply against its plain version on the same frame, on
    the card; returns the kernel's crop."""
    frame, core, _ = frame_of(kind, x, fir.taps, block_rows)
    kernel, plain = KERNELS_2D[kind]
    got = kernel(frame, fir, core, out=torch.full_like(frame, 0xFF))
    exact = kind != "fir2d_bf16" or bf16_sums_exact(fir)
    agree[kind].check(got, plain(frame, fir, core), label,
                      tolerance=0 if exact else 1)
    return crop_of(kind, got, fir.taps, core)


def check_kernels_2d(agree: dict, rng: np.random.Generator) -> None:
    """Kernels E, F and G against their plain versions, on the card, over
    the bank and the random shapes × formats × widths; against the golden
    copy up to GOLDEN_2D_MAX_WIDTH columns (kernel G where bf16_2d_exact
    holds)."""
    filters = [(name, np.asarray(h)) for name, h in FILTER_BANK_2D.items()]
    filters += [(f"{r}x{c}", random_taps_2d(rng, (r, c)))
                for r, c in GRID_2D_SHAPES]
    for f in GRID_2D_FORMATS:
        qf = QFormat(*f)
        for name, h in filters:
            fir = FixedFir2d.from_numpy(h, qf, "cuda")
            kinds = ["fir2d_frame"]
            if 0 < h.shape[1] - 1 <= 96:
                kinds += ["fir2d_oframe", "fir2d_bf16"]
            golden_ok = {"fir2d_frame": True, "fir2d_oframe": True,
                         "fir2d_bf16": bf16_2d_exact(
                             fir.h_fixed.cpu().numpy(), qf)}
            for n in GRID_2D_WIDTHS:
                x = rng.integers(0, 256, size=(GRID_2D_HEIGHT, n),
                                 dtype=np.uint8)
                golden = (fir2d_fixed_golden(x, h, qf)
                          if n <= GOLDEN_2D_MAX_WIDTH else None)
                for kind in kinds:
                    label = f"{kind} {name} {GRID_2D_HEIGHT}x{n} fmt={f}"
                    crop = check_2d(agree, kind, torch.from_numpy(x).cuda(),
                                    fir, label, GRID_2D_BLOCK_ROWS)
                    if golden is not None and golden_ok[kind] and not \
                            np.array_equal(crop.cpu().numpy(), golden):
                        raise AssertionError(f"{label}: kernel != golden")
    torch.cuda.synchronize()
    print("[chip_smoke] 2-D grid: " + ", ".join(
        f"{kind} {agree[kind].count}" for kind in KERNELS_2D)
        + f" comparisons, max |diff| "
        f"{max(agree[kind].max_abs_err for kind in KERNELS_2D)}", flush=True)


def run_config3() -> dict:
    """BASELINE config 3 through ``fir2d_fixed_auto``: bit-exact against
    the golden, RMSE < 0.5 against the ideal golden, kernel F alone; the
    f32 model on the card within 1e-2.  Then a 3×129 filter (kernel E
    alone) and a 3×258 one (no kernel: the int32 path)."""
    x = np.random.default_rng(CONFIG3_SEED).integers(
        0, 256, size=CONFIG3_SHAPE, dtype=np.uint8)
    xd = torch.from_numpy(x).cuda()
    h = np.asarray(FILTER_BANK_2D["gauss5"])
    reset_launch_counts()
    sim = fir2d_fixed_auto(xd, h)
    torch.cuda.synchronize()
    counts = {"config3": launch_counts()}
    only(counts["config3"], "fir2d_oframe", 1, "config 3")
    sim = sim.cpu().numpy()
    bit_ok = bool(np.array_equal(sim, fir2d_fixed_golden(x, h)))
    model = fir2d_ideal_golden(x, h)
    rmse = float(np.sqrt(np.mean((sim.astype(np.float64) - model) ** 2)))
    ideal_err = float(np.abs(fir2d_ideal_torch(xd, h).cpu().numpy()
                             - model).max())
    result = {"bit_exact_vs_golden": bit_ok, "rmse_vs_model": rmse,
              "ideal_torch_max_abs_err": ideal_err}
    rng = np.random.default_rng(CONFIG3_SEED)
    for shape, kernel in (((3, 129), "fir2d_frame"), ((3, 258), None)):
        hw = random_taps_2d(rng, shape)
        reset_launch_counts()
        got = fir2d_fixed_auto(xd, hw)
        torch.cuda.synchronize()
        run = f"config3_{shape[0]}x{shape[1]}"
        counts[run] = launch_counts()
        if kernel is None and any(counts[run].values()):
            raise AssertionError(f"{run} launched {counts[run]}")
        if kernel is not None:
            only(counts[run], kernel, 1, run)
        result[f"{run}_bit_exact"] = bool(np.array_equal(
            got.cpu().numpy(), fir2d_fixed_golden(x, hw)))
    result["launches"] = counts
    print(f"[chip_smoke] 2-D config 3 {json.dumps(result)}", flush=True)
    if not (bit_ok and rmse < 0.5 and ideal_err <= 1e-2
            and result["config3_3x129_bit_exact"]
            and result["config3_3x258_bit_exact"]):
        raise AssertionError(f"2-D config 3 failed a gate: {result}")
    return counts


FRAME_APPLY = {"fir2d_frame": fir2d_fixed_frame,
               "fir2d_oframe": fir2d_fixed_frame_overlap,
               "fir2d_bf16": fir2d_frame_overlap_bf16}


def run_frames(agree: dict) -> dict:
    """``bench_2d.py``'s streaming use at its geometry: FRAME_STEPS steps of
    two chained applies, ping-ponging two frames through ``scratch``, for
    sharpen5 and gauss5 on the overlapped frame (kernel F), the plain frame
    (kernel E) and the bf16 path (kernel G).  Each crop must equal
    ``fir2d_fixed_torch`` applied 2·FRAME_STEPS times on the card, each
    frame must still be a frame (pad zero, copies agreeing: it re-embeds to
    itself), and kernel G's frames must equal kernel F's.  Each kernel is
    also held against its plain version on one apply of the frame."""
    x = torch.from_numpy(np.random.default_rng(FRAME_SEED).integers(
        0, 256, size=(FRAME_SIZE, FRAME_SIZE), dtype=np.uint8)).cuda()
    counts = {}
    for name in ("sharpen5", "gauss5"):
        h = np.asarray(FILTER_BANK_2D[name])
        want = x
        for _ in range(2 * FRAME_STEPS):
            want = fir2d_fixed_torch(want, h)
        fir = FixedFir2d.from_numpy(h, QFormat(), "cuda")
        frames = {}
        for kind in KERNELS_2D:
            check_2d(agree, kind, x, fir, f"{kind} {name} "
                     f"{FRAME_SIZE}x{FRAME_SIZE}")
            a, core, block_rows = frame_of(kind, x, h.shape)
            b = torch.empty_like(a)
            run = f"frames_{name}_{kind}"
            reset_launch_counts()
            for _ in range(FRAME_STEPS):
                b = FRAME_APPLY[kind](a, h, core=core, block_rows=block_rows,
                                      scratch=b)
                a = FRAME_APPLY[kind](b, h, core=core, block_rows=block_rows,
                                      scratch=a)
            torch.cuda.synchronize()
            counts[run] = launch_counts()
            only(counts[run], kind, 2 * FRAME_STEPS, run)
            crop = crop_of(kind, a, h.shape, core)
            again, _, _ = frame_of(kind, crop, h.shape, block_rows)
            gates = {"crop_equals_torch": bool(torch.equal(crop, want)),
                     "fixed_point": bool(torch.equal(again, a))}
            if kind == "fir2d_bf16":
                gates["equals_kernel_f"] = bool(torch.equal(
                    a, frames["fir2d_oframe"]))
            frames[kind] = a
            print(f"[chip_smoke] 2-D frames {name} {kind} {tuple(a.shape)} "
                  f"x {2 * FRAME_STEPS} applies: {gates}", flush=True)
            if not all(gates.values()):
                raise AssertionError(f"{run} failed a gate: {gates}")
        del frames, want
    return counts


def time_2d(card: str, agree: dict) -> dict:
    """Per-apply CUDA-event medians at bench_2d.py's 8192² for kernels E,
    F and G (windows of FRAME_TIMING_LAUNCHES back-to-back applies into a
    second frame), ``fir2d_fixed_torch`` on the image, the plain versions
    and a ``copy_`` of the overlapped frame; then kernel E at
    E_TIMING_SHAPES (random taps from CONFIG3_SEED), each held against its
    plain version on that frame first."""
    x = torch.from_numpy(np.random.default_rng(FRAME_SEED).integers(
        0, 256, size=(FRAME_SIZE, FRAME_SIZE), dtype=np.uint8)).cuda()
    samples = FRAME_SIZE * FRAME_SIZE
    out = {}
    runs = {}
    for shape in E_TIMING_SHAPES:
        label = f"{shape[0]}x{shape[1]}"
        fir = FixedFir2d.from_numpy(random_taps_2d(
            np.random.default_rng(CONFIG3_SEED), shape), QFormat(), "cuda")
        check_2d(agree, "fir2d_frame", x, fir,
                 f"fir2d_frame {label} {FRAME_SIZE}x{FRAME_SIZE}")
        frame, core, _ = frame_of("fir2d_frame", x, shape)
        dst = torch.empty_like(frame)
        runs[label] = (lambda f=frame, c=core, d=dst, ff=fir:
                       fir2d_frame(f, ff, c, out=d))
        out.setdefault("nnz_e", {})[label] = int(
            np.count_nonzero(fir.h_fixed.cpu().numpy()))
        out.setdefault("frame_numel_e", {})[label] = frame.numel()
    for label, (m, lo, hi) in median_ms(runs, TIMING_REPS,
                                        FRAME_TIMING_LAUNCHES).items():
        print(f"[chip_smoke] time 2-D {label} fir2d_frame: median {m:.4f} ms "
              f"(min {lo:.4f}, max {hi:.4f}) {samples / m / 1e3:.1f} "
              f"Msamples/s an apply [{FRAME_SIZE}x{FRAME_SIZE} u8, Q4.12; "
              f"{card}]", flush=True)
        out.setdefault("fir2d_frame_e", {})[label] = m
    del runs
    for name in ("sharpen5", "gauss5"):
        h = np.asarray(FILTER_BANK_2D[name])
        fir = FixedFir2d.from_numpy(h, QFormat(), "cuda")
        runs, plain_runs = {}, {}
        for kind, (kernel, plain) in KERNELS_2D.items():
            frame, core, _ = frame_of(kind, x, h.shape)
            out.setdefault("frame_numel", {})[kind] = frame.numel()
            dst = torch.empty_like(frame)
            runs[kind] = (lambda k=kernel, f=frame, c=core, d=dst:
                          k(f, fir, c, out=d))
            plain_runs[kind] = lambda p=plain, f=frame, c=core: p(f, fir, c)
        runs["torch"] = lambda: fir2d_fixed_torch(x, h)
        frame = frame_of("fir2d_oframe", x, h.shape)[0]
        copy_dst = torch.empty_like(frame)
        runs["copy"] = lambda: copy_dst.copy_(frame)
        med = median_ms(runs, TIMING_REPS, FRAME_TIMING_LAUNCHES)
        med.update({f"{kind}_plain": v for kind, v in median_ms(
            plain_runs, PLAIN_LONG_CALLS, PLAIN_2D_CALLS).items()})
        for run, (m, lo, hi) in med.items():
            rate = (f"{2 * frame.numel() / m / 1e6:.1f} GB/s copied"
                    if run == "copy" else
                    f"{samples / m / 1e3:.1f} Msamples/s an apply")
            print(f"[chip_smoke] time 2-D {name} {run}: median {m:.4f} ms "
                  f"(min {lo:.4f}, max {hi:.4f}) {rate} "
                  f"[{FRAME_SIZE}x{FRAME_SIZE} u8, Q4.12; {card}]",
                  flush=True)
        out[name] = {run: m for run, (m, _, _) in med.items()}
    return out


def write_corpus(have_pil: bool) -> tuple[Path | None, list[str]]:
    """Render the corpus; PNGs when Pillow exists, else input vectors."""
    rng = np.random.default_rng(SEED)
    images = [(stem, render_image(kind, shape, rng))
              for stem, kind, shape in CORPUS]
    if have_pil:
        image_dir = WORK_DIR / "img"
        for stem, img in images:
            save_gray_png(image_dir / f"{stem}.png", img)
        return image_dir, []
    store = ArtifactStore(WORK_DIR / "artifacts")
    cases = []
    for idx, (stem, img) in enumerate(sorted(images, key=lambda s: s[0].lower())):
        case = store.case_name(idx, stem)
        save_npy(store.input_vector_path(case), img)
        cases.append({"case_name": case, "image_name": f"{stem}.png",
                      "width": int(img.shape[1]), "height": int(img.shape[0]),
                      "dtype": "uint8",
                      "data_npy": store.input_vector_path(case).name})
    write_json(store.manifest_path(), {
        "note": "FIR input vectors rendered in memory (no Pillow).",
        "num_images": len(cases), "cases": cases,
    })
    print("[chip_smoke] Pillow missing: stage 1 (PNG decode) and stage 5 "
          "(PNG restore) skipped; input vectors written directly", flush=True)
    return None, ["--skip-input", "--skip-restore"]


def check_fixed_outputs(store, goldens: dict) -> None:
    count = 0
    for in_path in store.iter_input_vectors():
        case = store.case_stem_of_input(in_path)
        x = np.load(in_path)
        for tap in (3, 5):
            for name, h in FILTER_BANKS[tap].items():
                key = (case, tap, name)
                if key not in goldens:
                    goldens[key] = fir1d_fixed_golden_rows(
                        x, np.asarray(h), QFormat())
                y = np.load(store.output_vector_path("fixed", tap, case, name))
                if not np.array_equal(y, goldens[key]):
                    raise AssertionError(f"fixed output {key} != host golden")
                count += 1
    if count != FIXED_OUTPUTS:
        raise AssertionError(f"{count} fixed outputs, expected {FIXED_OUTPUTS}")


def run_main_path(have_pil: bool) -> dict:
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    image_dir, skips = write_corpus(have_pil)
    root = WORK_DIR / "artifacts"
    store = ArtifactStore(root)
    argv = ["--artifact-root", str(root), "--device", "cuda"]
    if image_dir is not None:
        argv += ["--image-dir", str(image_dir)]

    # The main path is the 5-stage pipeline with the default backend
    # (kernel A), then the fixed stage under each other JAX backend name:
    # "pallas" (kernel B, which no 3- or 5-tap filter reaches through
    # "auto"), "mxu" (kernel A) and "tpu" (the int32 path, no kernel).
    reset_launch_counts()
    start = time.perf_counter()
    cli_main(argv + ["--backend", "auto"] + skips)
    auto_s = time.perf_counter() - start
    auto = launch_counts()
    print(f"[chip_smoke] main path --backend auto: {auto_s:.3f} s host clock, "
          f"launches {auto}", flush=True)
    if auto["fir_band"] < FIXED_OUTPUTS or any(
            auto[name] for name in KERNELS if name != "fir_band"):
        raise AssertionError(f"launch counts {auto}: expected fir_band >= "
                             f"{FIXED_OUTPUTS} and no other kernel")
    for tap in (3, 5):
        summary = store.report_dir(tap) / f"compare_{tap}tap_summary.json"
        if not summary.is_file():
            raise AssertionError(f"missing compare summary {summary}")
        overall = json.loads(summary.read_text())["overall"]
        print(f"[chip_smoke] {tap}tap compare: {overall['num_cases']} cases, "
              f"{overall['num_samples_total']} samples", flush=True)
    goldens: dict = {}
    check_fixed_outputs(store, goldens)
    print(f"[chip_smoke] {FIXED_OUTPUTS} fixed outputs == host golden "
          "(band kernel)", flush=True)
    launches = {"auto": auto}

    # The fixed stage alone again under the JAX package's other names: each
    # through its own kernel, "tpu" through torch ops alone.  The outputs
    # of the run before go first, so that each check reads this run's.
    for backend, kernel in FIXED_STAGE_RUNS:
        for tap in (3, 5):
            shutil.rmtree(store.vector_dir("fixed", tap))
        reset_launch_counts()
        start = time.perf_counter()
        cli_main([
            "--artifact-root", str(root), "--device", "cuda", "--backend",
            backend, "--skip-input", "--skip-ideal", "--skip-report",
            "--skip-restore", "--overwrite-vectors"])
        seconds = time.perf_counter() - start
        counts = launch_counts()
        print(f"[chip_smoke] fixed stage --backend {backend}: {seconds:.3f} s "
              f"host clock, launches {counts}", flush=True)
        if any(counts[name] for name in KERNELS if name != kernel) or (
                kernel is not None and counts[kernel] < FIXED_OUTPUTS):
            raise AssertionError(
                f"--backend {backend} launch counts {counts}: expected "
                + (f"{kernel} >= {FIXED_OUTPUTS} and no other kernel"
                   if kernel else "no kernel"))
        check_fixed_outputs(store, goldens)
        print(f"[chip_smoke] {FIXED_OUTPUTS} fixed outputs == host golden "
              f"(--backend {backend})", flush=True)
        launches[f"backend_{backend}"] = counts
    # The corpus and its outputs stay for phase 15's traced fixed stage.
    return launches


def run_stream(label: str, h: np.ndarray, num_blocks: int) -> dict:
    """One stream path with bench_streaming.py's gates: the timed scan,
    kill/resume at the midpoint, the stitch around it, scan-vs-blockwise."""
    qf = QFormat()
    channels, block = STREAM_CHANNELS, STREAM_BLOCK
    num_taps = int(h.size)
    block_fn = stream_source(channels, block, torch.device("cuda"))
    geometry = pick_window_split(channels, block, num_taps)
    reset_launch_counts()
    stream = Fir1DStream(h, channels, qf, "cuda")
    stream_scanned(stream, block_fn, num_blocks)  # warm-up of the same scan
    stream.reset()
    torch.cuda.synchronize()
    start = time.perf_counter()
    sums_full = stream_scanned(stream, block_fn, num_blocks)
    elapsed = time.perf_counter() - start
    final = stream.state
    total = channels * block * num_blocks

    half = num_blocks // 2
    first = Fir1DStream(h, channels, qf, "cuda")
    sums_a = stream_scanned(first, block_fn, half)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = WORK_DIR / f"stream_state_{label}.npz"
    first.state.save(ckpt)
    resumed = Fir1DStream(h, channels, qf, "cuda")  # "kill": state from disk
    resumed.state = FirStreamState.load(ckpt)
    sums_b = stream_scanned(resumed, block_fn, num_blocks - half,
                            start_block=half)
    resume_ok = bool(np.array_equal(np.concatenate([sums_a, sums_b]),
                                    sums_full))
    state_ok = bool(np.array_equal(resumed.state.carry, final.carry)
                    and resumed.state.samples_seen == final.samples_seen)

    # Blocks half-1 and half through process() against the offline core.
    stitch_ok, y_before = stitch(h, qf, channels, block, half, block_fn,
                                 torch.device("cuda"))
    cross_ok = bool(np.array_equal(sums_full[half - 1].astype(np.uint64),
                                   host_emit_checksums(y_before)))
    counts = launch_counts()
    ckpt.unlink()
    result = {
        "stream": label, "taps": num_taps, "block_shape": [channels, block],
        "blocks": num_blocks, "total_samples": total,
        "scan_mode": f"windowed{geometry}" if geometry else "unsplit",
        "elapsed_s": elapsed, "msamples_per_s": total / elapsed / 1e6,
        "resume_checksums_match": resume_ok, "resume_state_match": state_ok,
        "stitch_bit_exact": stitch_ok,
        "scan_vs_blockwise_checksums_match": cross_ok,
        "checksums_nonzero": bool(sums_full.any()), "launches": counts,
    }
    print(f"[chip_smoke] stream {json.dumps(result)}", flush=True)
    if not (resume_ok and state_ok and stitch_ok and cross_ok
            and result["checksums_nonzero"]):
        raise AssertionError(f"stream {label} failed a gate: {result}")
    return result


def time_kernels(card: str) -> dict:
    qf = QFormat()
    h = FILTER_BANKS[5]["sharpen"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    fir = FixedFir1d.from_numpy(h, qf, "cuda")
    fir_b = FixedFirDirect(h, qf, "cuda")
    runs = {
        "fir_band": lambda: fir(x),
        "fir_direct": lambda: fir_b(x),
        # The entry prepares the filter (quantize, encode, upload) a call.
        "fir_direct_entry": lambda: fir_direct(x, h, qf),
        "fir_direct_plain": lambda: fir_direct_plain(x, fir_b),
        "torch_direct": lambda: fir1d_fixed_rows_torch(x, h, qf),
    }
    x64 = x[:64].cpu().numpy()
    want64 = fir1d_fixed_golden_rows(x64, np.asarray(h), qf)
    outs = {name: fn() for name, fn in runs.items()}
    for name, out in outs.items():
        if not np.array_equal(out[:64].cpu().numpy(), want64):
            raise AssertionError(f"{name} != host golden on 64 rows")
        if not torch.equal(out, outs["torch_direct"]):
            raise AssertionError(f"{name} != torch_direct on the full array")
    del outs
    for _ in range(TIMING_WARMUP):
        for fn in runs.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for _ in range(TIMING_REPS):
        for name, fn in runs.items():  # interleaved, one card, one process
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TIMING_LAUNCHES):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / TIMING_LAUNCHES)
    samples = BENCH_SHAPE[0] * BENCH_SHAPE[1]
    medians = {}
    for name, ms in times.items():
        med = statistics.median(ms)
        medians[name] = med
        print(f"[chip_smoke] time {name}: median {med:.4f} ms of "
              f"{TIMING_REPS}x{TIMING_LAUNCHES} calls (min {min(ms):.4f}, "
              f"max {max(ms):.4f}) "
              f"{samples / med / 1e3:.1f} Msamples/s "
              f"{2 * samples / med / 1e6:.1f} GB/s effective "
              f"[{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} u8, 5-tap sharpen, Q4.12; "
              f"{card}]", flush=True)
    return medians


def time_band(card: str) -> dict:
    """Kernel A at BENCH_SHAPE for each of BAND_TIMING_TAPS (the banks'
    sharpen filters at 3 and 5 taps, Hamming low-passes beyond) and at 5
    taps on the stream's (4,000, 16,256) window rows, and kernel C's entry
    on A's low-passes at BAND_YARDSTICK_TAPS (keys ``("C", taps)``), each
    held against the plain int32 path on the card first, whose one call
    is timed too (keys ``("plain", taps)``); windows interleaved within the
    short-tap counts and within the rest."""
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    sub, _ = pick_window_split(STREAM_CHANNELS, STREAM_BLOCK, 5)
    win = torch.randint(0, 256, (STREAM_CHANNELS * STREAM_BLOCK // sub,
                                 sub + 256), dtype=torch.uint8, device="cuda",
                        generator=gen)
    runs, plain = {}, {}
    for taps in BAND_TIMING_TAPS:
        h = (np.asarray(FILTER_BANKS[taps]["sharpen"]) if taps in (3, 5)
             else design_lowpass(taps, 0.2))
        fir = FixedFir1d.from_numpy(h, qf, "cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fir1d_fixed_rows_torch(x, h, qf)
        end.record()
        end.synchronize()
        plain[("plain", taps)] = start.elapsed_time(end)
        if not torch.equal(fir(x), want):
            raise AssertionError(f"fir_band != plain int32 path at {taps} "
                                 "taps")
        runs[taps] = lambda f=fir: f(x)
        if taps in BAND_YARDSTICK_TAPS:
            fir_c = FixedFirWindow.from_numpy(h, qf, "cuda")
            if not torch.equal(fir_c(x), want):
                raise AssertionError(f"fir_window != plain int32 path at "
                                     f"{taps} taps")
            runs[("C", taps)] = lambda f=fir_c: f(x)
        del want
    fir5 = FixedFir1d.from_numpy(FILTER_BANKS[5]["sharpen"], qf, "cuda")
    if not torch.equal(fir5(win), fir1d_fixed_rows_torch(
            win, FILTER_BANKS[5]["sharpen"], qf)):
        raise AssertionError("fir_band != plain int32 path on the windows")
    runs["windows"] = lambda: fir5(win)
    # The short-tap route's calls apart from the digit planes' and C's.
    short = ("windows",
             *(t for t in BAND_TIMING_TAPS if t <= BAND_SHORT_MAX_TAPS))
    med = median_ms({k: v for k, v in runs.items() if k in short},
                    TIMING_REPS, TIMING_LAUNCHES)
    med.update(median_ms({k: v for k, v in runs.items() if k not in short},
                         TIMING_REPS, TIMING_LAUNCHES))
    for run, (m, lo, hi) in med.items():
        if run == "windows":
            what = (f"fir_band {run}: median {m:.4f} ms (min {lo:.4f}, max "
                    f"{hi:.4f}) [{win.shape[0]}x{win.shape[1]} u8, 5-tap "
                    f"sharpen")
        elif isinstance(run, tuple):
            what = (f"fir_band yardstick: fir_window {run[1]} taps: median "
                    f"{m:.4f} ms (min {lo:.4f}, max {hi:.4f}) [{BENCH_SHAPE[0]}"
                    f"x{BENCH_SHAPE[1]} u8, kernel A's filter")
        else:
            what = (f"fir_band {run}: median {m:.4f} ms (min {lo:.4f}, max "
                    f"{hi:.4f}) [{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} u8, {run} "
                    f"taps")
        print(f"[chip_smoke] time {what}, Q4.12; {card}]", flush=True)
    print("[chip_smoke] time fir_band's plain int32 path, one call each: "
          + ", ".join(f"{key[1]} taps {ms:.4f} ms" for key, ms in plain.items())
          + f" [{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} u8, Q4.12; {card}]",
          flush=True)
    return {**{run: m for run, (m, _, _) in med.items()}, **plain}


def event_ms(fn, calls: int) -> float:
    """Device time per call of ``calls`` back-to-back calls of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(runs: dict, reps: int, calls: int) -> dict:
    """Median per-call time of each run, windows interleaved across runs."""
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            times[name].append(event_ms(fn, calls))
    return {name: (statistics.median(ms), min(ms), max(ms))
            for name, ms in times.items()}


def time_long_taps(card: str) -> dict:
    """Kernels C and B and the plain path at 258, 1,001, 2,048 and 4,096
    taps, and kernel C on a 1,001-tap stream block."""
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    out = {}
    for num_taps in LONG_TIMING_TAPS:
        h = design_lowpass(num_taps, 0.2)
        window_fir = FixedFirWindow.from_numpy(h, qf, "cuda")
        direct_fir = FixedFirDirect(h, qf, "cuda")
        plain_ms, plain = [], None
        for _ in range(PLAIN_LONG_CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = fir1d_fixed_rows_torch(x, h, qf)
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
        want16 = fir1d_fixed_golden_rows(x[:16].cpu().numpy(), h, qf)
        for name, fir in (("fir_window", window_fir), ("fir_direct", direct_fir)):
            got = fir(x)
            if not torch.equal(got, plain):
                raise AssertionError(f"{name} != plain at {num_taps} taps")
            if not np.array_equal(got[:16].cpu().numpy(), want16):
                raise AssertionError(f"{name} != golden at {num_taps} taps")
        del plain
        runs = {"fir_window": lambda: window_fir(x),
                "fir_direct": lambda: direct_fir(x)}
        if num_taps == LONG_TAPS:
            # Kernel C at the shape the long-tap stream launches it on: a
            # block behind its carry, 16 × (4,000,000 + L − 1).
            block = torch.randint(
                0, 256, (STREAM_CHANNELS, STREAM_BLOCK + num_taps - 1),
                dtype=torch.uint8, device="cuda", generator=gen)
            runs["fir_window_block"] = lambda: window_fir(block)
        med = median_ms(runs, LONG_TIMING_REPS, LONG_TIMING_LAUNCHES)
        med["torch_direct"] = (statistics.median(plain_ms), min(plain_ms),
                               max(plain_ms))
        for name, (m, lo, hi) in med.items():
            shape = ((STREAM_CHANNELS, STREAM_BLOCK + num_taps - 1)
                     if name == "fir_window_block" else BENCH_SHAPE)
            print(f"[chip_smoke] time {name} {num_taps} taps: median {m:.4f} "
                  f"ms (min {lo:.4f}, max {hi:.4f}) "
                  f"{shape[0] * shape[1] / m / 1e3:.1f} "
                  f"Msamples/s [{shape[0]}x{shape[1]} u8, "
                  f"Q4.12 low-pass; {card}]", flush=True)
        out[num_taps] = {name: m for name, (m, _, _) in med.items()}
    return out


def time_direct_long(card: str) -> dict:
    """Kernel B at BENCH_SHAPE past kernel C's 4,096 taps, where it is the
    only route (DIRECT_TIMING_TAPS, ``design_lowpass(L, 0.25)``, Q4.12),
    each first held equal to its plain version on the card
    (DIRECT_PLAIN_ROWS rows at a time); returns each tap count's median and
    the nonzero quantized taps, for its bound."""
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    out = {}
    for num_taps in DIRECT_TIMING_TAPS:
        h = design_lowpass(num_taps, 0.25)
        fir = FixedFirDirect(h, qf, "cuda")
        got = fir(x)
        for r0 in range(0, x.shape[0], DIRECT_PLAIN_ROWS):
            rows = slice(r0, r0 + DIRECT_PLAIN_ROWS)
            if not torch.equal(got[rows], fir_direct_plain(x[rows], fir)):
                raise AssertionError(f"fir_direct != plain at {num_taps} taps,"
                                     f" rows {r0}..")
        del got
        m, lo, hi = median_ms({"fir_direct": lambda f=fir: f(x)},
                              LONG_TIMING_REPS, LONG_TIMING_LAUNCHES)[
                                  "fir_direct"]
        print(f"[chip_smoke] time fir_direct {num_taps} taps: median {m:.4f} "
              f"ms (min {lo:.4f}, max {hi:.4f}) "
              f"{x.numel() / m / 1e3:.1f} Msamples/s [{BENCH_SHAPE[0]}x"
              f"{BENCH_SHAPE[1]} u8, design_lowpass({num_taps}, 0.25), "
              f"Q4.12; {card}]", flush=True)
        out[num_taps] = {"ms": m, "nnz": int(np.count_nonzero(
            qf.quantize_coeffs(h)))}
    return out


def time_stream_step(card: str, sustained_ms: float) -> dict:
    """The 5-tap stream's windowed step split into its parts with CUDA
    events recorded between them in a loop of STEP_BLOCKS blocks.

    The loop is device-bound, so the host runs ahead and each pair of
    events brackets the part's device time; the first STEP_SKIP blocks,
    while the host gets ahead, are left out of the medians.  Kernel D's
    plain version is timed over windows of back-to-back calls.
    """
    qf = QFormat()
    channels, block = STREAM_CHANNELS, STREAM_BLOCK
    sub, g = pick_window_split(channels, block, 5)
    block_fn = stream_source(channels, block, torch.device("cuda"))
    fir = FixedFir1d.from_numpy(FILTER_BANKS[5]["sharpen"], qf, "cuda")
    carry = torch.zeros((channels, 128), dtype=torch.uint8, device="cuda")
    parts = ("block", "window_rows", "fir_band", "checksums")
    sums = torch.empty((STEP_BLOCKS, 3), dtype=torch.int64, device="cuda")
    weights = _checksum_weights(block, torch.device("cuda"))  # once a scan
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
              for _ in range(STEP_BLOCKS)]
    win = None
    for b, ev in enumerate(events):
        ev[0].record()
        x = block_fn(b)
        ev[1].record()
        win = window_rows(x, carry, sub, g)
        ev[2].record()
        y_win = fir(win)
        ev[3].record()
        sums[b] = _weighted_sums(
            _windowed_column_sums(y_win, channels, sub, 5), weights)
        ev[4].record()
    torch.cuda.synchronize()
    split = {part: statistics.median(
        ev[i].elapsed_time(ev[i + 1]) for ev in events[STEP_SKIP:])
        for i, part in enumerate(parts)}
    split["step"] = statistics.median(
        ev[0].elapsed_time(ev[4]) for ev in events[STEP_SKIP:])
    x = block_fn(0)
    split["bytes"] = float(x.numel() + carry.numel() + win.numel())
    split["window_rows_plain"] = median_ms(
        {"plain": lambda: window_rows_plain(x, carry, sub, g)},
        TIMING_REPS, TIMING_LAUNCHES)["plain"][0]
    print(f"[chip_smoke] stream step split (ms per block, device time, "
          f"median of blocks {STEP_SKIP}-{STEP_BLOCKS - 1}): block source "
          f"{split['block']:.4f}, kernel D {split['window_rows']:.4f}, FIR "
          f"(kernel A, {win.shape[0]}x{win.shape[1]}) {split['fir_band']:.4f}"
          f", checksums {split['checksums']:.4f}; step {split['step']:.4f} "
          f"against {sustained_ms:.4f} per block sustained by the scan; "
          f"kernel D plain {split['window_rows_plain']:.4f} [{card}]",
          flush=True)
    return split


class FloatAgreement:
    """Counts float kernel-vs-plain comparisons, the largest |difference|
    and the smallest SNR against the float64 plain version."""

    def __init__(self):
        self.count = 0
        self.max_abs_err = 0.0
        self.min_snr_db = float("inf")

    def check(self, got: torch.Tensor, want: torch.Tensor, label: str,
              min_snr_db: float) -> None:
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        err = (float((got.to(torch.float64) - want).abs().max())
               if got.numel() else 0.0)
        snr = snr_on_device(want, got)
        self.count += 1
        self.max_abs_err = max(self.max_abs_err, err)
        self.min_snr_db = min(self.min_snr_db, snr)
        if not snr >= min_snr_db:
            raise AssertionError(f"{label}: kernel vs plain SNR {snr:.1f} dB "
                                 f"< {min_snr_db} dB (max |diff| {err:.3g})")


def fm_planes(rng: np.random.Generator, channels: int, time_len: int,
              k_f: float, band: float = 1.0) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """FM-modulated I/Q planes on the card, with the band-limited message
    of tests/test_demod_chain.py:198-203 (white noise low-passed at 0.05,
    scaled to a peak of 1), which its bf16 bound assumes; ``band`` scales
    the message's cutoff and the deviation ``k_f``."""
    msg = fir1d_ideal_rows_torch(torch.from_numpy(rng.standard_normal(
        (channels, time_len)).astype(np.float32)).cuda(),
        design_lowpass(63, 0.05 * band))
    msg = (msg / msg.abs().max()).cpu().numpy()
    re, im = fm_modulate(msg, k_f * band)
    return (torch.from_numpy(re.astype(np.float32)).cuda(),
            torch.from_numpy(im.astype(np.float32)).cuda())


def chain_config(up: int, down: int, rs_taps: int, ch_taps: int,
                 **kwargs) -> ChainConfig:
    return ChainConfig(resample_up=up, resample_down=down,
                       resample_taps=rs_taps, channelizer_taps=ch_taps,
                       **kwargs)


def check_chain_kernels(agree: dict, fm: tuple) -> None:
    """Kernels H, I and J against their float64 plain versions on the
    card: H and I >= 120 dB, J >= 95 dB in "highest", and in "bf16"
    > 40 dB against the f32 chain's plain version (> 60 dB against its
    own), over the grids and at the main path's shapes."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for num_taps in FLOAT_TAPS:
        fir = FloatFir1d(rng.standard_normal(num_taps) / np.sqrt(num_taps),
                         "cuda")
        for n in FLOAT_WIDTHS:
            for x in (torch.from_numpy(rng.integers(
                    0, 256, size=(ROWS, n), dtype=np.uint8)).cuda(),
                      torch.randn((ROWS, n), device="cuda", generator=gen)):
                agree["fir_float"].check(
                    fir_float(x, fir), fir_float_plain(x, fir),
                    f"fir_float L={num_taps} N={n} {x.dtype}", 120.0)
    for up, down, num_taps in RESAMPLE_RATES:
        rs = PolyphaseResampler(design_lowpass(
            num_taps, 0.9 / max(up, down), gain=up), up, down, "cuda")
        for n in RESAMPLE_WIDTHS:
            x = torch.randn((ROWS, n), device="cuda", generator=gen)
            agree["resample"].check(resample(x, rs), resample_plain(x, rs),
                                    f"resample {up}/{down} L={num_taps} "
                                    f"N={n}", 120.0)
    check_long_branch(gen)
    for geometries, narrow in ((CHAIN_GEOMETRIES, False),
                               (CHAIN_LOW_RATES, True)):
        for up, down, rs_taps, ch_taps, channels in geometries:
            cfg = chain_config(up, down, rs_taps, ch_taps)
            re, im = fm_planes(rng, channels, 3 * 1024 * down // up + 333,
                               cfg.demod_k_f, up / down if narrow else 1.0)
            check_chain_modes(agree, re, im, cfg,
                              f"chain {up}/{down} {rs_taps}+{ch_taps} "
                              f"C={channels}")

    # The main path's shapes: config 5's 32 × 2 M resample, 32 × 1.33 M
    # channelizer and 16 × 2 M chain.
    cfg = ChainConfig()
    x = torch.cat(fm, dim=0)
    rs = PolyphaseResampler(cfg.resample_filter(), 2, 3, "cuda")
    both = resample(x, rs)
    agree["resample"].check(both, resample_plain(x, rs),
                            f"resample main {tuple(x.shape)}", 120.0)
    fir = FloatFir1d(cfg.channelizer_filter(), "cuda")
    agree["fir_float"].check(fir_float(both, fir), fir_float_plain(both, fir),
                             f"fir_float main {tuple(both.shape)}", 120.0)
    del x, both
    check_chain_modes(agree, *fm, cfg, "chain main")
    torch.cuda.synchronize()
    print("[chip_smoke] chain kernels: " + ", ".join(
        f"{name} {agree[name].count} comparisons (min SNR "
        f"{agree[name].min_snr_db:.1f} dB, max |diff| "
        f"{agree[name].max_abs_err:.3g})"
        for name in ("fir_float", "resample", "chain_fused",
                     "chain_fused_bf16", "chain_fused_bf16_own")), flush=True)


def check_long_branch(gen: torch.Generator) -> None:
    """Kernel I at RESAMPLE_LONG_BRANCH, each output within the bound of
    a recursive f32 sum of J products with one rounding each, J u / (1 -
    J u) times the sum of their magnitudes (u = 2^-24), against float64."""
    up, down, num_taps = RESAMPLE_LONG_BRANCH
    h = design_lowpass(num_taps, 0.9 / max(up, down), gain=up)
    rs = PolyphaseResampler(h, up, down, "cuda")
    rs_abs = PolyphaseResampler(np.abs(h), up, down, "cuda")
    u = 2.0 ** -24
    gamma = rs.branch_len * u / (1 - rs.branch_len * u)
    for n in RESAMPLE_WIDTHS:
        x = torch.randn((ROWS, n), device="cuda", generator=gen)
        want, got = resample_plain(x, rs), resample(x, rs)
        err = (got.to(torch.float64) - want).abs()
        bound = gamma * resample_plain(x.abs(), rs_abs)
        if not bool((err <= bound).all()):
            raise AssertionError(f"resample {up}/{down} L={num_taps} N={n}: "
                                 "past the f32 summation bound")
        print(f"[chip_smoke] resample {up}/{down} L={num_taps} N={n}: SNR "
              f"{snr_on_device(want, got):.1f} dB, max |diff| "
              f"{float(err.max()):.3g}, at most "
              f"{float((err / bound.clamp_min(1e-300)).max()):.3g} of the "
              "bound", flush=True)


def check_chain_modes(agree: dict, re: torch.Tensor, im: torch.Tensor,
                      cfg: ChainConfig, label: str) -> None:
    """Kernel J in "highest" and "bf16" against the plain versions."""
    args = (cfg.resample_filter(), cfg.channelizer_filter(), cfg.resample_up,
            cfg.resample_down, cfg.demod_k_f)
    chain = FusedChain(*args, precision="highest", device="cuda")
    want = chain_fused_plain(re, im, chain)
    got = chain_fused(re, im, chain)
    agree["chain_fused"].check(got, want, f"{label} highest", 95.0)
    if float(got[:, 0].abs().max()) != 0.0:
        raise AssertionError(f"{label}: message 0 is not 0")
    chain = FusedChain(*args, precision="bf16", device="cuda")
    got = chain_fused(re, im, chain)
    agree["chain_fused_bf16"].check(got, want, f"{label} bf16 vs f32", 40.0)
    agree["chain_fused_bf16_own"].check(got, chain_fused_plain(re, im, chain),
                                        f"{label} bf16", 60.0)


def run_config5(fm: tuple) -> tuple[dict, dict]:
    """BASELINE config 5 at full size through ``chain_forward``: "auto"
    through kernel J alone, staged "mxu" through kernels I and H alone, on
    bench_configs.py's seeded noise planes and on FM planes (fused within
    90 dB SNR of staged there), then the 2-channel message recovery."""
    cfg = ChainConfig()
    staged_cfg = dataclasses.replace(cfg, channelizer_backend="mxu")
    rng = np.random.default_rng(CONFIG5_SEED)
    noise = tuple(torch.from_numpy(rng.standard_normal(
        (CONFIG5_CHANNELS, CONFIG5_TIME)).astype(np.float32)).cuda()
        for _ in range(2))
    out_len = -(-CONFIG5_TIME * cfg.resample_up // cfg.resample_down)
    counts, outs = {}, {}
    for signal, planes in (("noise", noise), ("fm", fm)):
        for path, config in (("auto", cfg), ("staged", staged_cfg)):
            run = f"config5_{signal}_{path}"
            reset_launch_counts()
            outs[run] = y = chain_forward(*planes, config)
            torch.cuda.synchronize()
            counts[run] = launch_counts()
            if tuple(y.shape) != (CONFIG5_CHANNELS, out_len) or \
                    not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{run}: shape {tuple(y.shape)} or "
                                     "non-finite messages")
        only(counts[f"config5_{signal}_auto"], "chain_fused", 1,
             f"config 5 {signal} auto")
        staged = counts[f"config5_{signal}_staged"]
        if staged["resample"] < 1 or staged["fir_float"] < 1 or any(
                staged[k] for k in KERNELS if k not in ("resample",
                                                        "fir_float")):
            raise AssertionError(f"config 5 {signal} staged launches "
                                 f"{staged}: expected kernels I and H only")
    result = {
        "fused_vs_staged_snr_db_fm": snr_on_device(outs["config5_fm_staged"],
                                                 outs["config5_fm_auto"]),
        "fused_vs_staged_snr_db_noise": snr_on_device(
            outs["config5_noise_staged"], outs["config5_noise_auto"]),
    }
    del outs

    # bench_configs.py:233-249: two tones, recovered at the output rate.
    t = np.arange(200_000)
    message = np.stack([0.4 * np.cos(2 * np.pi * 0.001 * t),
                        0.3 * np.sin(2 * np.pi * 0.0015 * t)])
    re, im = fm_modulate(message, cfg.demod_k_f)
    reset_launch_counts()
    out = chain_forward(torch.from_numpy(re.astype(np.float32)).cuda(),
                        torch.from_numpy(im.astype(np.float32)).cuda(), cfg)
    torch.cuda.synchronize()
    counts["config5_message"] = launch_counts()
    out = out.cpu().numpy().astype(np.float64)
    expected = 0.4 * np.cos(2 * np.pi * 0.001 * np.arange(out.shape[1]) * 1.5)
    core = slice(300, -300)
    result["message_corr"] = float(np.corrcoef(out[0, core],
                                               expected[core])[0, 1])
    result["launches"] = counts
    print(f"[chip_smoke] config 5 {json.dumps(result)}", flush=True)
    if not (result["fused_vs_staged_snr_db_fm"] > 90.0
            and result["message_corr"] > 0.99
            and counts["config5_message"]["resample"] >= 1
            and counts["config5_message"]["fir_float"] >= 1):
        raise AssertionError(f"config 5 failed a gate: {result}")
    return counts, result


def time_chain(card: str, fm: tuple) -> dict:
    """CUDA-event medians at config 5's shapes: kernel I on the stacked
    32 × 2 M planes, kernel H on the 32 × 1,333,334 resampled planes, the
    demod, kernel J on 16 × 2 M in both modes, their plain versions,
    ``F.conv1d`` of the channelizer's taps (TF32 off: the same f32
    function as kernel H), kernel I's function through ``F.conv1d`` (P
    output channels at stride Q, interleaved; TF32 off), both chains end
    to end through ``chain_forward`` and a ``copy_`` of the stacked
    input."""
    cfg = ChainConfig()
    re, im = fm
    x = torch.cat([re, im], dim=0)
    h_rs, h_ch = cfg.resample_filter(), cfg.channelizer_filter()
    rs = PolyphaseResampler(h_rs, 2, 3, "cuda")
    both = resample(x, rs)
    fir = FloatFir1d(h_ch, "cuda")
    ch = fir_float(both, fir)
    re_ch, im_ch = ch[:CONFIG5_CHANNELS], ch[CONFIG5_CHANNELS:]
    chain = FusedChain(h_rs, h_ch, 2, 3, cfg.demod_k_f, precision="highest",
                       device="cuda")
    chain_bf16 = FusedChain(h_rs, h_ch, 2, 3, cfg.demod_k_f,
                            precision="bf16", device="cuda")
    re_bf16, im_bf16 = re.to(torch.bfloat16), im.to(torch.bfloat16)
    left = h_ch.size - 1 - h_ch.size // 2
    weight = torch.as_tensor(h_ch[::-1].copy(), dtype=torch.float32,
                             device="cuda").view(1, 1, -1)
    conv = F.conv1d(both.unsqueeze(1), weight, padding=left).squeeze(1)
    conv_snr = snr_on_device(fir_float_plain(both, fir), conv)
    if not conv_snr >= 100.0:
        raise AssertionError(f"F.conv1d is not the channelizer's function "
                             f"(SNR {conv_snr:.1f} dB against kernel H's "
                             "plain version)")
    rs_weight, rs_pad = conv1d_resampler(rs)
    rs_conv_snr = snr_on_device(resample_plain(x[:2], rs),
                              conv1d_resample(x[:2], rs_weight, rs_pad, rs))
    if not rs_conv_snr >= 100.0:
        raise AssertionError(f"the F.conv1d resampler is not kernel I's "
                             f"function (SNR {rs_conv_snr:.1f} dB against "
                             "its plain version)")
    copy_dst = torch.empty_like(x)
    staged_cfg = dataclasses.replace(cfg, channelizer_backend="mxu")
    runs = {
        "resample": lambda: resample(x, rs),
        "fir_float": lambda: fir_float(both, fir),
        "demod": lambda: fm_demodulate(re_ch, im_ch, cfg.demod_k_f),
        "chain_fused": lambda: chain_fused(re, im, chain),
        "chain_fused_bf16": lambda: chain_fused(re_bf16, im_bf16, chain_bf16),
        "conv1d": lambda: F.conv1d(both.unsqueeze(1), weight, padding=left),
        "resample_conv1d": lambda: conv1d_resample(x, rs_weight, rs_pad, rs),
        "copy": lambda: copy_dst.copy_(x),
    }
    med = median_ms(runs, CHAIN_TIMING_REPS, CHAIN_TIMING_LAUNCHES)
    med.update(median_ms({
        "resample_plain": lambda: resample_plain(x, rs),
        "fir_float_plain": lambda: fir_float_plain(both, fir),
        "chain_fused_plain": lambda: chain_fused_plain(re, im, chain),
        "chain_auto": lambda: chain_forward(re, im, cfg),
        "chain_staged": lambda: chain_forward(re, im, staged_cfg),
    }, 3, PLAIN_CHAIN_CALLS))
    out_len = both.shape[1]
    samples = CONFIG5_CHANNELS * out_len
    for run, (m, lo, hi) in med.items():
        rate = (f"{2 * x.numel() * 4 / m / 1e6:.1f} GB/s copied"
                if run == "copy" else
                f"{samples / m / 1e3:.1f} Mmessages/s (of config 5's chain)")
        print(f"[chip_smoke] time chain {run}: median {m:.4f} ms (min "
              f"{lo:.4f}, max {hi:.4f}) {rate} [{CONFIG5_CHANNELS} x "
              f"{CONFIG5_TIME} complex f32, 2/3 x 63 + 63 taps; {card}]",
              flush=True)
    result = {run: m for run, (m, _, _) in med.items()}
    result["conv1d_snr_db"] = conv_snr
    result["resample_conv1d_snr_db"] = rs_conv_snr
    # Work of each timed call, for its bound.
    branch_nnz = (rs.taps != 0).sum(dim=1).cpu().numpy()
    _, branch, _, _ = _plan(CONFIG5_TIME, 2, 3, h_rs.size)
    rs_fmas = int(branch_nnz[branch].sum())  # per row
    f32 = 4
    result["work"] = {
        "resample": (x.numel() * f32 + both.numel() * f32,
                     2.0 * 2 * CONFIG5_CHANNELS * rs_fmas),
        "fir_float": (2 * both.numel() * f32,
                      2.0 * both.numel() * int(np.count_nonzero(h_ch))),
        "demod": (3 * samples * f32, 0.0),
        "chain_fused": (x.numel() * f32 + samples * f32,
                        2.0 * 2 * CONFIG5_CHANNELS
                        * (rs_fmas + out_len * int(np.count_nonzero(h_ch)))),
    }
    result["work"]["chain_fused_bf16"] = (
        x.numel() * 2 + samples * f32, result["work"]["chain_fused"][1])
    result["copy_bytes_per_s"] = 2 * x.numel() * f32 / (med["copy"][0] / 1e3)
    return result


class U8Agreement(Agreement):
    """u8 outputs of kernels L and M against their plain versions' float64
    results through the same output stage: within 1 (an f32 and an f64 sum
    on either side of a rounding tie), on under 0.1% of the samples."""

    def __init__(self):
        super().__init__()
        self.max_share = 0.0

    def check_stage(self, got: torch.Tensor, want64: torch.Tensor,
                    label: str, share: float = 1e-3) -> None:
        want = _u8_stage(want64.to(torch.float32))
        self.check(got, want, label, tolerance=1)
        differ = (float((got != want).to(torch.float64).mean())
                  if got.numel() else 0.0)
        self.max_share = max(self.max_share, differ)
        if not differ < share:
            raise AssertionError(f"{label}: {differ:.4%} of u8 outputs differ "
                                 f"from the plain version's (limit {share})")


def check_fft_kernels(agree: dict, agree_u8: dict) -> None:
    """Kernels K, L and M against their float64 plain versions on the
    card, SNR >= 120 dB, over the grids of phase 12; K also within
    2e-4·max|want| of the float64 FFT (tests/test_fft_pallas.py:45-49)."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for nfft in FFT_SIZES:
        for batch in FFT_BATCHES:
            xr = torch.randn((batch, nfft), device="cuda", generator=gen)
            xi = torch.randn((batch, nfft), device="cuda", generator=gen)
            for mode, im, inverse in (("complex", xi, False),
                                      ("real", None, False),
                                      ("inverse", xi, True)):
                label = f"fft_rows nfft={nfft} B={batch} {mode}"
                got = torch.stack(fft_rows(xr, im, inverse=inverse))
                agree["fft_rows"].check(got, torch.stack(fft_rows_plain(
                    xr, im, inverse=inverse)), label, 120.0)
                x64 = torch.complex(xr.double(), torch.zeros_like(
                    xr, dtype=torch.float64) if im is None else im.double())
                ref = torch.fft.ifft(x64) if inverse else torch.fft.fft(x64)
                err = float((torch.complex(got[0].double(), got[1].double())
                             - ref).abs().max())
                if not err <= 2e-4 * float(ref.abs().max()):
                    raise AssertionError(f"{label}: max |got - fft| {err:.3g}"
                                         " over 2e-4 max|want|")
    cells = [(nfft, taps) for nfft in OSFILT_SIZES for taps in OSFILT_TAPS
             if taps <= nfft]
    cells += [(pick_nfft(taps), taps) for taps in OSFILT_LONG_TAPS]
    for nfft, taps in cells:
        spec = FilterSpectrum(rng.uniform(0.0, 2.0 / taps, taps), nfft,
                              device="cuda")
        seg = torch.from_numpy(rng.integers(
            0, 256, size=(OSFILT_SEGMENTS, nfft), dtype=np.uint8)).cuda()
        want = osfilt_plain(seg, spec)
        for x in (seg, seg.to(torch.float32)):
            label = f"osfilt nfft={nfft} L={taps} {x.dtype}"
            agree["osfilt"].check(osfilt(x, spec, out_u8=False), want, label,
                                  120.0)
            agree_u8["osfilt"].check_stage(osfilt(x, spec, out_u8=True), want,
                                           label)
    for channels, time_len, taps, off in STREAM_FFT_CASES:
        h = stream_taps(taps)
        tables = FilterSpectrum(h, STREAM_NFFT,
                                d=_stream_geometry(taps, off)[1],
                                device="cuda")
        shape = (channels, time_len + off)
        label = f"osfilt_stream C={channels} T={time_len} L={taps} off={off}"
        x = torch.randn(shape, device="cuda", generator=gen)
        agree["osfilt_stream"].check(
            osfilt_stream(x, tables, off=off, out_len=time_len, out_u8=False),
            osfilt_stream_plain(x, tables, off=off, out_len=time_len), label,
            120.0)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
        agree_u8["osfilt_stream"].check_stage(
            osfilt_stream(x, tables, off=off, out_len=time_len, out_u8=True),
            osfilt_stream_plain(x, tables, off=off, out_len=time_len), label)
    torch.cuda.synchronize()
    print("[chip_smoke] FFT kernels: " + ", ".join(
        f"{name} {a.count} comparisons (min SNR {a.min_snr_db:.1f} dB, max "
        f"|diff| {a.max_abs_err:.3g})" for name, a in agree.items())
        + "; u8: " + ", ".join(
            f"{name} {a.count} (max |diff| {a.max_abs_err}, at most "
            f"{a.max_share:.4%} differing)" for name, a in agree_u8.items()),
        flush=True)


def stream_taps(taps: int) -> np.ndarray:
    """Phase 12's stream filters: a low-pass; one tap passes through, and
    two are an irrational pair (a symmetric pair halves the sum of two
    integers, which would put half the u8 outputs on rounding ties)."""
    if taps == 1:
        return np.array([1.0])
    if taps == 2:
        golden = (np.sqrt(5.0) - 1.0) / 2.0
        return np.array([golden, 1.0 - golden])
    return design_lowpass(taps, 0.2)


def run_config4(agree: dict) -> tuple[dict, dict, tuple]:
    """BASELINE config 4 at full size (phase 13): ``fir_overlap_save_pallas``
    through kernel M alone, against the float64 FIR (> 70 dB, the config's
    gate), the ``torch.fft`` overlap-save (>= 90 dB) and kernel M's plain
    version (>= 120 dB); the shard-local call over 4 blocks (>= 90 dB
    against the unsharded output); the quantized u8 path against kernel A
    (within 1 on under 2%, tests/test_fft_pallas.py:130-132); the filter's
    frequency response measured through ``fft_rows_pallas`` (kernel K),
    within 1e-3 of ``|DFT(h)|`` at every bin."""
    rng = np.random.default_rng(CONFIG4_SEED)
    x_u8 = torch.from_numpy(rng.integers(
        0, 256, size=(CONFIG4_CHANNELS, CONFIG4_TIME), dtype=np.uint8)).cuda()
    x = x_u8.to(torch.float32)
    h = design_lowpass(CONFIG4_TAPS, 0.25)
    counts, result = {}, {}
    reset_launch_counts()
    y = fir_overlap_save_pallas(x, h)
    torch.cuda.synchronize()
    counts["config4"] = launch_counts()
    only(counts["config4"], "osfilt_stream", 1, "config 4")
    if (tuple(y.shape) != tuple(x.shape) or y.dtype != torch.float32
            or not bool(torch.isfinite(y).all())):
        raise AssertionError(f"config 4: {y.dtype} {tuple(y.shape)} or "
                             "non-finite output")
    result["snr_db_vs_ideal"] = snr_on_device(ideal_rows64(x, h), y)
    result["snr_db_vs_torch_fft"] = snr_on_device(fir_overlap_save(x, h), y)
    tables = FilterSpectrum(h, STREAM_NFFT,
                            d=_stream_geometry(CONFIG4_TAPS, 0)[1],
                            device="cuda")
    agree["osfilt_stream"].check(
        y, osfilt_stream_plain(x, tables, off=0, out_len=CONFIG4_TIME),
        f"osfilt_stream config 4 {tuple(x.shape)}", 120.0)

    # The shard-local call of parallel/fft_sharded.py:80-82, :133-142: each
    # time block with its halo (zeros at the stream's ends), off = L-1-c.
    halo = CONFIG4_TAPS - 1 - CONFIG4_TAPS // 2
    block = CONFIG4_TIME // CONFIG4_SHARDS
    blocks = [_zero_extended(x, b * block - halo, block + 2 * halo)
              for b in range(CONFIG4_SHARDS)]
    reset_launch_counts()
    parts = [fir_overlap_save_stream(xb, h, off=halo, out_len=block)
             for xb in blocks]
    torch.cuda.synchronize()
    counts["config4_shards"] = launch_counts()
    only(counts["config4_shards"], "osfilt_stream", CONFIG4_SHARDS,
         "config 4 shard-local")
    result["shards_snr_db_vs_unsharded"] = snr_on_device(y, torch.cat(parts, 1))
    result["shard_hop"] = stream_plan(CONFIG4_TAPS, halo)[0]
    del blocks, parts

    reset_launch_counts()
    y_q = fir_overlap_save_quantized_pallas(x_u8, h)
    torch.cuda.synchronize()
    counts["config4_u8"] = launch_counts()
    only(counts["config4_u8"], "osfilt_stream", 1, "config 4 u8")
    diff = (y_q.to(torch.int16)
            - fir1d_fixed_rows_auto(x_u8, h).to(torch.int16)).abs()
    result["u8_max_diff_vs_kernel_a"] = int(diff.max())
    result["u8_share_differing_vs_kernel_a"] = float(
        (diff != 0).to(torch.float64).mean())
    del y_q, diff

    # The response: the cross-spectrum of output and input over 8,192-point
    # rows (mean removed), over the input's power, against |DFT(h)|.
    n = RESPONSE_NFFT
    rows = CONFIG4_TIME // n
    xb = (x[:, : rows * n] - x.mean()).reshape(-1, n)
    yb = (y[:, : rows * n] - y.mean()).reshape(-1, n)
    reset_launch_counts()
    spectra = [fft_rows_pallas(b) for b in (xb, yb)]
    torch.cuda.synchronize()
    counts["config4_response"] = launch_counts()
    only(counts["config4_response"], "fft_rows", 2, "config 4 response")
    agree["fft_rows"].check(
        torch.stack(spectra[0]),
        torch.stack(fft_rows_plain(xb, None, inverse=False)),
        f"fft_rows config 4 rows {tuple(xb.shape)}", 120.0)
    big_x, big_y = (torch.complex(re.double(), im.double())
                    for re, im in spectra)
    del spectra, xb, yb
    gain = ((big_y * big_x.conj()).sum(0)
            / big_x.abs().square().sum(0)).abs()[: n // 2 + 1]
    design = torch.as_tensor(np.abs(np.fft.fft(h, n))[: n // 2 + 1],
                             device="cuda")
    result["response_max_err"] = float((gain - design).abs().max())
    result["launches"] = counts
    del big_x, big_y, y
    print(f"[chip_smoke] config 4 {json.dumps(result)}", flush=True)
    if not (result["snr_db_vs_ideal"] > 70.0
            and result["snr_db_vs_torch_fft"] >= 90.0
            and result["shards_snr_db_vs_unsharded"] >= 90.0
            and result["u8_max_diff_vs_kernel_a"] <= 1
            and result["u8_share_differing_vs_kernel_a"] < 0.02
            and result["response_max_err"] < 1e-3):
        raise AssertionError(f"config 4 failed a gate: {result}")
    return counts, result, (x_u8, x, h)


def run_chain_fft(agree: dict, fm: tuple, card: str) -> tuple[dict, dict]:
    """The chain on config 5's FM planes with the ``"pallas"`` channelizer
    (kernels I then M alone, >= 90 dB against staged ``"mxu"``) and a
    259-tap channelizer under ``"auto"`` (kernels I then L alone, >= 90 dB
    against the ``torch.fft`` channelizer); kernels M and L against their
    plain versions at the shapes the chain gives them; CUDA-event medians
    of both chains end to end and of M and L at those shapes."""
    cfg = ChainConfig()
    long_cfg = dataclasses.replace(cfg, channelizer_taps=259)
    runs = {"chain_pallas": (dataclasses.replace(
                cfg, channelizer_backend="pallas"), "osfilt_stream",
                dataclasses.replace(cfg, channelizer_backend="mxu")),
            "chain_auto_259": (long_cfg, "osfilt", dataclasses.replace(
                long_cfg, channelizer_backend="jnp"))}
    counts, result = {}, {}
    for run, (config, kernel, reference) in runs.items():
        reset_launch_counts()
        y = chain_forward(*fm, config)
        torch.cuda.synchronize()
        counts[run] = c = launch_counts()
        if c["resample"] < 1 or c[kernel] < 1 or any(
                c[k] for k in KERNELS if k not in ("resample", kernel)):
            raise AssertionError(f"{run} launches {c}: expected kernels I "
                                 f"and {kernel} only")
        result[f"{run}_snr_db"] = snr_on_device(chain_forward(*fm, reference),
                                              y)
    both = resample(torch.cat(fm, dim=0), PolyphaseResampler(
        cfg.resample_filter(), 2, 3, "cuda"))
    h = cfg.channelizer_filter()
    tables = FilterSpectrum(h, STREAM_NFFT, d=_stream_geometry(h.size, 0)[1],
                            device="cuda")
    agree["osfilt_stream"].check(
        osfilt_stream(both, tables, off=0, out_len=both.shape[1],
                      out_u8=False),
        osfilt_stream_plain(both, tables, off=0, out_len=both.shape[1]),
        f"osfilt_stream chain {tuple(both.shape)}", 120.0)
    h_long = long_cfg.channelizer_filter()
    seg, _, _ = _osfilt_segments(both, h_long.size, pick_nfft(h_long.size))
    spec = FilterSpectrum(h_long, pick_nfft(h_long.size), device="cuda")
    agree["osfilt"].check(osfilt(seg, spec, out_u8=False),
                          osfilt_plain(seg, spec),
                          f"osfilt chain segments {tuple(seg.shape)}", 120.0)
    med = median_ms({
        "osfilt_stream_chain": lambda: osfilt_stream(
            both, tables, off=0, out_len=both.shape[1], out_u8=False),
        "osfilt_chain": lambda: osfilt(seg, spec, out_u8=False),
    }, CHAIN_TIMING_REPS, CHAIN_TIMING_LAUNCHES)
    med.update(median_ms({run: (lambda c=config: chain_forward(*fm, c))
                          for run, (config, _, _) in runs.items()},
                         3, PLAIN_CHAIN_CALLS))
    shapes = {"osfilt_stream_chain": f"{tuple(both.shape)} stream",
              "osfilt_chain": f"{tuple(seg.shape)} segments"}
    for run, (m, lo, hi) in med.items():
        print(f"[chip_smoke] time chain fft {run}: median {m:.4f} ms (min "
              f"{lo:.4f}, max {hi:.4f}) [{shapes.get(run, 'config 5')}; "
              f"{card}]", flush=True)
        result[f"{run}_ms"] = m
    result["launches"] = counts
    print(f"[chip_smoke] chain FFT channelizers {json.dumps(result)}",
          flush=True)
    if not (result["chain_pallas_snr_db"] >= 90.0
            and result["chain_auto_259_snr_db"] >= 90.0):
        raise AssertionError(f"chain FFT channelizers failed a gate: {result}")
    return counts, result


def time_fft(card: str, agree: dict, x_u8: torch.Tensor, x: torch.Tensor,
             h: np.ndarray) -> dict:
    """CUDA-event medians at config 4: kernel M (f32 in and out; u8 in and
    out), kernel L over the stream framed at a pinned nfft of 2,048,
    kernel K at 8,192 × 2,048 and 1,024 × 16,384 complex, their plain
    versions, ``torch.fft.fft``, ``F.conv1d`` of the 63 taps (TF32 off:
    the same f32 function), the ``torch.fft`` overlap-save, the entry
    ``fir_overlap_save_pallas`` end to end and a ``copy_`` of the f32
    input; with the work of each timed call for its bound."""
    d = _stream_geometry(h.size, 0)[1]
    tables = FilterSpectrum(h, STREAM_NFFT, d=d, device="cuda")
    nfft = CONFIG4_PINNED_NFFT
    seg, _, _ = _osfilt_segments(x, h.size, nfft)
    spec = FilterSpectrum(h, nfft, device="cuda")
    agree["osfilt"].check(osfilt(seg, spec, out_u8=False),
                          osfilt_plain(seg, spec),
                          f"osfilt config 4 segments {tuple(seg.shape)}",
                          120.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    planes = {n: (torch.randn((rows, n), device="cuda", generator=gen),
                  torch.randn((rows, n), device="cuda", generator=gen))
              for rows, n in FFT_TIMING_SHAPES}
    for n, (xr, xi) in planes.items():
        agree["fft_rows"].check(
            torch.stack(fft_rows(xr, xi, inverse=False)),
            torch.stack(fft_rows_plain(xr, xi, inverse=False)),
            f"fft_rows {tuple(xr.shape)}", 120.0)
    cplx = {n: torch.complex(*p) for n, p in planes.items()}
    left = h.size - 1 - h.size // 2
    weight = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                             device="cuda").view(1, 1, -1)
    x3 = x.unsqueeze(1)
    conv_snr = snr_on_device(
        osfilt_stream(x, tables, off=0, out_len=x.shape[1], out_u8=False),
        F.conv1d(x3, weight, padding=left).squeeze(1))
    if not conv_snr >= 100.0:
        raise AssertionError(f"F.conv1d is not config 4's function (SNR "
                             f"{conv_snr:.1f} dB against kernel M)")
    copy_dst = torch.empty_like(x)
    out_len = x.shape[1]
    runs = {
        "osfilt_stream": lambda: osfilt_stream(x, tables, off=0,
                                               out_len=out_len, out_u8=False),
        "osfilt_stream_u8": lambda: osfilt_stream(
            x_u8, tables, off=0, out_len=out_len, out_u8=True),
        "osfilt": lambda: osfilt(seg, spec, out_u8=False),
        **{f"fft_rows_{n}": (lambda p=p: fft_rows(*p, inverse=False))
           for n, p in planes.items()},
        **{f"torch_fft_{n}": (lambda c=c: torch.fft.fft(c))
           for n, c in cplx.items()},
        "conv1d": lambda: F.conv1d(x3, weight, padding=left),
        "torch_fft_overlap_save": lambda: fir_overlap_save(x, h),
        "entry": lambda: fir_overlap_save_pallas(x, h),
        "copy": lambda: copy_dst.copy_(x),
    }
    med = median_ms(runs, FFT_TIMING_REPS, FFT_TIMING_LAUNCHES)
    med.update(median_ms({
        "osfilt_stream_plain": lambda: osfilt_stream_plain(
            x, tables, off=0, out_len=out_len),
        "osfilt_plain": lambda: osfilt_plain(seg, spec),
        **{f"fft_rows_plain_{n}": (lambda p=p: fft_rows_plain(
            *p, inverse=False)) for n, p in planes.items()},
    }, 3, PLAIN_FFT_CALLS))
    shapes = {"osfilt": f"{seg.shape[0]} x {nfft} segments",
              **{f"{kind}_{n}": f"{xr.shape[0]} x {n} complex"
                 for n, (xr, _) in planes.items()
                 for kind in ("fft_rows", "fft_rows_plain", "torch_fft")}}
    shapes["osfilt_plain"] = shapes["osfilt"]
    for run, (m, lo, hi) in med.items():
        shape = shapes.get(run, f"{CONFIG4_CHANNELS} x {CONFIG4_TIME} stream")
        print(f"[chip_smoke] time fft {run}: median {m:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f}) [{shape}; {card}]", flush=True)
    result = {run: m for run, (m, _, _) in med.items()}
    result["conv1d_snr_db"] = conv_snr
    # M's work is the least any 512-point overlap-save does: a window
    # every 512 - L + 1 outputs, whatever placement a kernel takes.
    windows = CONFIG4_CHANNELS * -(-out_len // stream_plan(h.size, 0)[0])
    result["windows"] = windows

    def transform_ops(n: int) -> float:
        return 5.0 * n * np.log2(n)

    def filter_ops(n: int) -> float:
        """A real window or segment: the filter is real, so two of them
        share one complex forward transform, product and inverse, and
        each costs half of 2 * transform_ops(n) + 6 n."""
        return transform_ops(n) + 3.0 * n

    result["work"] = {
        "osfilt_stream": (2.0 * x.numel() * 4,
                          windows * filter_ops(STREAM_NFFT)),
        "osfilt_stream_u8": (2.0 * x.numel(),
                             windows * filter_ops(STREAM_NFFT)),
        "osfilt": (2.0 * seg.numel() * 4, seg.shape[0] * filter_ops(nfft)),
        **{f"fft_rows_{n}": (16.0 * xr.numel(), xr.shape[0] * transform_ops(n))
           for n, (xr, _) in planes.items()},
    }
    return result


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shard_blocks(x: torch.Tensor, shards: int, left: int, right: int,
                 dim: int) -> list[torch.Tensor]:
    """Each shard's extended block along ``dim`` of a 2-D tensor, sliced
    from the global tensor with zero edges at its ends: what the halo ring
    delivers."""
    width = x.shape[dim] // shards
    xp = F.pad(x, (left, right) if dim == 1 else (0, 0, left, right))
    return [xp.narrow(dim, i * width, width + left + right).contiguous()
            for i in range(shards)]


class Phase14:
    """Phase 14's runs, each between a zeroing and a reading of the launch
    counts, and its gates."""

    def __init__(self):
        self.counts, self.result = {}, {}

    def launched(self, run: str, fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        self.counts[run] = launch_counts()
        return out

    def only(self, run: str, name: str, at_least: int) -> None:
        only(self.counts[run], name, at_least, f"phase 14 {run}")

    def equal(self, run: str, got: torch.Tensor, want: torch.Tensor) -> None:
        same = bool(torch.equal(got, want))
        self.result[f"{run}_equal"] = same
        if not same:
            differ = got.shape == want.shape and int((got != want).sum())
            raise AssertionError(f"phase 14 {run}: not equal to the "
                                 f"unsharded call ({differ} values differ)")

    def config4(self, run: str, got: torch.Tensor, want: torch.Tensor,
                ideal: torch.Tensor) -> None:
        """Phase 13's gates: > 70 dB against the float64 FIR, within 2e-2
        of the unsharded call (tests/test_expert_fft_sharded.py:65)."""
        snr = snr_on_device(ideal, got)
        err = float((got - want).abs().max())
        self.result[f"{run}_snr_db_vs_ideal"] = snr
        self.result[f"{run}_max_abs_vs_unsharded"] = err
        if not (snr > 70.0 and err <= 2e-2):
            raise AssertionError(f"phase 14 {run}: {snr:.1f} dB, max |diff| "
                                 f"{err:.3g} against the unsharded call")


def run_parallel(card: str, x4: torch.Tensor, h4: np.ndarray,
                 fm: tuple) -> tuple[dict, dict, dict]:
    """Phase 14: the ``parallel/`` entries through a world of 1 (a real
    NCCL group) at full width, the shard-local steps over PARALLEL_SHARDS
    emulated time shards, ``PipelinedChain`` over config 5, and the
    sharded calls' CUDA-event medians beside the unsharded ones."""
    p = Phase14()
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x1 = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                       generator=gen)
    h5 = np.asarray(FILTER_BANKS[5]["sharpen"])
    fir5 = FixedFir1d.from_numpy(h5, qf, "cuda")
    want1 = fir5(x1)
    bank = np.asarray([FILTER_BANKS[5][name] for name in
                       ("moving_avg", "simple_lp", "edge", "sharpen")])
    x2 = torch.from_numpy(np.random.default_rng(FRAME_SEED).integers(
        0, 256, size=(FRAME_SIZE, FRAME_SIZE), dtype=np.uint8)).cuda()
    h2 = np.asarray(FILTER_BANK_2D["sharpen5"])
    want2 = fir2d_fixed_auto(x2, h2)
    h2_e = random_taps_2d(np.random.default_rng(CONFIG3_SEED),
                          E_TIMING_SHAPES[0])
    cfg = ChainConfig()
    up, down = cfg.resample_up, cfg.resample_down
    re, im = (plane[:, :PARALLEL_CHAIN_TIME].contiguous() for plane in fm)
    fused_args = (cfg.resample_filter(), cfg.channelizer_filter(), up, down,
                  cfg.demod_k_f)
    want_fused = chain_forward_fused(re, im, *fused_args)
    want4 = fir_overlap_save_pallas(x4, h4)
    ideal4 = ideal_rows64(x4, h4)
    x_long = x4[:, :PARALLEL_LONG_TIME].contiguous()
    h_long = design_lowpass(PARALLEL_LONG_TAPS, 0.25)

    if not initialize_multihost(
            coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
            process_id=0, device="cuda"):
        raise AssertionError("initialize_multihost made no process group")
    try:
        mesh = make_mesh({"data": 1, "time": 1})
        stage_mesh = make_mesh({"stage": 1})
        print(f"[chip_smoke] parallel: world {dist.get_world_size()} "
              f"({dist.get_backend()}), meshes {mesh} and {stage_mesh}",
              flush=True)

        # A world of 1 through the public entries, at full width.
        y = p.launched("parallel_config4", lambda: fir_overlap_save_sharded(
            x4, h4, mesh=mesh, backend="pallas").to_local())
        p.only("parallel_config4", "osfilt_stream", 1)
        p.config4("parallel_config4", y, want4, ideal4)
        del y
        want_long = fir_overlap_save_pallas(x_long, h_long)
        y = p.launched("parallel_config4_259tap",
                       lambda: fir_overlap_save_sharded(
                           x_long, h_long, mesh=mesh,
                           backend="pallas").to_local())
        p.only("parallel_config4_259tap", "osfilt", 1)
        p.config4("parallel_config4_259tap", y, want_long,
                  ideal_rows64(x_long, h_long))

        y = p.launched("parallel_fir1d", lambda: fir1d_fixed_sharded(
            x1, h5, mesh=mesh).to_local())
        p.only("parallel_fir1d", "fir_band", 1)
        p.equal("parallel_fir1d", y, want1)

        y = p.launched("parallel_fir2d", lambda: fir2d_fixed_sharded(
            x2, h2, mesh=mesh).to_local())
        p.only("parallel_fir2d", "fir2d_oframe", 1)
        p.equal("parallel_fir2d", y, want2)
        y = p.launched("parallel_fir2d_e", lambda: fir2d_fixed_sharded(
            x2, h2_e, mesh=mesh).to_local())
        p.only("parallel_fir2d_e", "fir2d_frame", 1)
        p.equal("parallel_fir2d_e", y, fir2d_fixed_auto(x2, h2_e))

        back = p.launched("parallel_reshard", lambda: time_to_channel(
            channel_to_time(x1, mesh=mesh, axis="time"), mesh=mesh,
            axis="time").to_local())
        p.equal("parallel_reshard", back, x1)
        del back

        y = p.launched("parallel_bank", lambda: filter_bank_fixed_sharded(
            x1, bank, mesh=mesh, expert_axis="data").to_local())
        p.only("parallel_bank", "fir_band", len(bank))
        for f, h in enumerate(bank):
            p.equal(f"parallel_bank_{f}", y[f],
                    FixedFir1d.from_numpy(h, qf, "cuda")(x1))
        del y

        stage_firs = [FixedFir1d.from_numpy(h, qf, "cuda") for h in bank]
        mb = x1.reshape(PARALLEL_SPMD_MICROBATCHES, -1, x1.shape[1])
        y = p.launched("parallel_spmd", lambda: spmd_pipeline(
            lambda s, x: stage_firs[s](x), mb, mesh=stage_mesh).to_local())
        p.only("parallel_spmd", "fir_band", len(mb))
        want = mb
        for fir in stage_firs[: stage_mesh.size()]:
            want = torch.stack([fir(m) for m in want])
        p.equal("parallel_spmd", y, want)
        del y, want

        y = p.launched("parallel_chain", lambda: chain_forward_sharded(
            re, im, cfg, mesh=mesh).to_local())
        p.only("parallel_chain", "chain_fused", 1)
        p.equal("parallel_chain", y, chain_forward(re, im, cfg))
        y = p.launched("parallel_chain_time",
                       lambda: chain_forward_time_sharded(
                           re, im, cfg, mesh=mesh,
                           halo_mult=PARALLEL_HALO_MULT).to_local())
        p.only("parallel_chain_time", "chain_fused", 1)
        p.equal("parallel_chain_time", y, want_fused)

        times = time_parallel(card, {
            "config4": (lambda: fir_overlap_save_sharded(
                            x4, h4, mesh=mesh, backend="pallas"),
                        lambda: fir_overlap_save_pallas(x4, h4)),
            "config4_259tap": (lambda: fir_overlap_save_sharded(
                                   x_long, h_long, mesh=mesh,
                                   backend="pallas"),
                               lambda: fir_overlap_save_pallas(x_long,
                                                               h_long)),
            "fir1d": (lambda: fir1d_fixed_sharded(x1, h5, mesh=mesh),
                      lambda: fir1d_fixed_rows_auto(x1, h5)),
            "fir2d": (lambda: fir2d_fixed_sharded(x2, h2, mesh=mesh),
                      lambda: fir2d_fixed_auto(x2, h2)),
            "fir2d_e": (lambda: fir2d_fixed_sharded(x2, h2_e, mesh=mesh),
                        lambda: fir2d_fixed_auto(x2, h2_e)),
            "bank": (lambda: filter_bank_fixed_sharded(x1, bank, mesh=mesh),
                     lambda: [fir1d_fixed_rows_auto(x1, h) for h in bank]),
            "reshard_round_trip": (
                lambda: time_to_channel(channel_to_time(
                    x1, mesh=mesh, axis="time"), mesh=mesh, axis="time"),
                lambda: x1.clone()),
            "spmd": (lambda: spmd_pipeline(lambda s, x: stage_firs[s](x), mb,
                                           mesh=stage_mesh),
                     lambda: [stage_firs[0](m) for m in mb]),
            "chain": (lambda: chain_forward_sharded(re, im, cfg, mesh=mesh),
                      lambda: chain_forward(re, im, cfg)),
            "chain_time": (lambda: chain_forward_time_sharded(
                               re, im, cfg, mesh=mesh,
                               halo_mult=PARALLEL_HALO_MULT),
                           lambda: chain_forward_fused(re, im, *fused_args)),
        })
    finally:
        dist.destroy_process_group()
    del x_long, want_long

    # PARALLEL_SHARDS emulated time shards through the shard-local steps.
    shards = PARALLEL_SHARDS
    left4 = CONFIG4_TAPS - 1 - CONFIG4_TAPS // 2
    plan = LocalOverlapSave.prepare(h4, None, "pallas", torch.device("cuda"))
    blocks = shard_blocks(x4, shards, left4, CONFIG4_TAPS // 2, 1)
    y = p.launched("parallel_config4_shards", lambda: torch.cat([
        _overlap_save_local(b, plan, x4.shape[1] // shards) for b in blocks],
        dim=1))
    p.only("parallel_config4_shards", "osfilt_stream", shards)
    p.config4("parallel_config4_shards", y, want4, ideal4)
    del blocks, y, want4, ideal4

    y = p.launched("parallel_fir1d_shards", lambda: torch.cat([
        _fir1d_local(b, fir5, 2, 2)
        for b in shard_blocks(x1, shards, 2, 2, 1)], dim=1))
    p.only("parallel_fir1d_shards", "fir_band", shards)
    p.equal("parallel_fir1d_shards", y, want1)

    margins = top, bottom, left, right = _margins_2d(*h2.shape)
    fir2 = prepare_fixed_fir2d(h2, qf, "cuda")
    y = p.launched("parallel_fir2d_shards", lambda: torch.cat([
        torch.cat([_fir2d_local(b, fir2, margins)
                   for b in shard_blocks(rows, 2, left, right, 1)], dim=1)
        for rows in shard_blocks(x2, 2, top, bottom, 0)], dim=0))
    p.only("parallel_fir2d_shards", "fir2d_oframe", 4)
    p.equal("parallel_fir2d_shards", y, want2)

    h_in = 128 * down * PARALLEL_HALO_MULT
    h_out = 128 * up * PARALLEL_HALO_MULT
    out_local = PARALLEL_CHAIN_TIME // shards * up // down
    fused = FusedChain(*fused_args, precision=cfg.fused_precision,
                       device="cuda")
    planes = list(zip(shard_blocks(re, shards, h_in, h_in, 1),
                      shard_blocks(im, shards, h_in, h_in, 1)))
    y = p.launched("parallel_chain_time_shards", lambda: torch.cat([
        _chain_time_local(re_b, im_b, fused,
                          (h_out - s * out_local,
                           h_out + out_local * (shards - s)),
                          h_out, out_local, first=s == 0)
        for s, (re_b, im_b) in enumerate(planes)], dim=1))
    p.only("parallel_chain_time_shards", "chain_fused", shards)
    p.equal("parallel_chain_time_shards", y, want_fused)
    del planes, y

    p.result.update(run_pipelined_chain(p, fm, cfg, card))
    p.result["launches"] = p.counts
    print(f"[chip_smoke] parallel {json.dumps(p.result)}", flush=True)
    return p.counts, p.result, times


def run_pipelined_chain(p: Phase14, fm: tuple, cfg: ChainConfig,
                        card: str) -> dict:
    """``PipelinedChain`` over config 5 in microbatches of two channels
    (I/Q stacked as four rows): resample (kernel I), channelizer (kernel
    H), demod, each stage on its own CUDA stream; pipelined and
    ``force_sequential`` results equal, both wall times printed."""
    up, down = cfg.resample_up, cfg.resample_down
    rs = PolyphaseResampler(cfg.resample_filter(), up, down, "cuda")
    ch = FloatFir1d(cfg.channelizer_filter(), "cuda")
    pipe = PipelinedChain([
        lambda x: resample(x, rs),
        lambda x: fir_float(x, ch),
        lambda x: fm_demodulate(x[: x.shape[0] // 2], x[x.shape[0] // 2:],
                                cfg.demod_k_f)])
    step = CONFIG5_CHANNELS // PARALLEL_MICROBATCHES
    batches = [torch.cat([plane[c : c + step] for plane in fm])
               for c in range(0, CONFIG5_CHANNELS, step)]
    pipe.run_microbatches(batches[:2])  # warm-up
    walls, outs = {}, {}
    for mode in ("pipelined", "sequential", "sequential", "pipelined"):
        run = f"parallel_pipeline_{mode}"
        torch.cuda.synchronize()
        start = time.perf_counter()
        reset_launch_counts()
        outs[mode] = pipe.run_microbatches(
            batches, force_sequential=mode == "sequential")
        torch.cuda.synchronize()
        walls.setdefault(mode, []).append(time.perf_counter() - start)
        p.counts[run] = launch_counts()
        if p.counts[run]["resample"] < len(batches) or p.counts[run][
                "fir_float"] < len(batches) or any(
                p.counts[run][k] for k in KERNELS
                if k not in ("resample", "fir_float")):
            raise AssertionError(f"{run} launches {p.counts[run]}: expected "
                                 "kernels I and H only")
    for m, (a, b) in enumerate(zip(outs["pipelined"], outs["sequential"])):
        p.equal(f"parallel_pipeline_microbatch_{m}", a, b)
    staged = chain_forward(*fm, dataclasses.replace(
        cfg, channelizer_backend="mxu")).cpu()
    wall = {mode: min(ts) for mode, ts in walls.items()}
    result = {"pipeline_wall_s": wall,
              "pipeline_sequential_over_pipelined": wall["sequential"]
              / wall["pipelined"],
              "pipeline_equals_staged_chain": bool(torch.equal(
                  torch.cat(outs["pipelined"]), staged))}
    print(f"[chip_smoke] PipelinedChain config 5 in {len(batches)} "
          f"microbatches of {step} channels: pipelined "
          f"{wall['pipelined']:.4f} s, force_sequential "
          f"{wall['sequential']:.4f} s (best of 2, host clock, ratio "
          f"{result['pipeline_sequential_over_pipelined']:.3f}) [{card}]",
          flush=True)
    return result


def time_parallel(card: str, pairs: dict) -> dict:
    """CUDA-event medians of each sharded call (a world of 1) beside the
    unsharded call that computes the same outputs: ``pairs`` maps a name
    to the two calls."""
    med = median_ms({f"{name}_{side}": fn
                     for name, fns in pairs.items()
                     for side, fn in zip(("sharded", "unsharded"), fns)},
                    PARALLEL_TIMING_REPS, PARALLEL_TIMING_CALLS)
    times = {}
    for name in pairs:
        (ms, lo, hi), (un, un_lo, un_hi) = (med[f"{name}_sharded"],
                                            med[f"{name}_unsharded"])
        times[name] = {"sharded_ms": ms, "unsharded_ms": un}
        print(f"[chip_smoke] time parallel {name}: sharded (world 1) median "
              f"{ms:.4f} ms (min {lo:.4f}, max {hi:.4f}), unsharded "
              f"{un:.4f} ms (min {un_lo:.4f}, max {un_hi:.4f}), ratio "
              f"{ms / un:.3f} [{card}]", flush=True)
    return times


def determinism_entries(x: torch.Tensor, gen: torch.Generator) -> dict:
    """Each kernel's entry as a caller reaches it, at the main paths'
    shapes: A at 19,456 × 8,192 (``x``) at 5 and 257 taps (both routes),
    B at 5 and 4,097 taps, C at 1,001, D at the 5-tap stream's block, E, F
    and G on 8192² sharpen5 frames, H on 32 × 1,333,334 f32, I and J on
    config 5's planes, K at 8,192 × 2,048, L at 259 taps and M at config
    4's shape."""
    qf = QFormat()
    h5 = np.asarray(FILTER_BANKS[5]["sharpen"])
    sub, g = pick_window_split(STREAM_CHANNELS, STREAM_BLOCK, 5)
    block = torch.randint(0, 256, (STREAM_CHANNELS, STREAM_BLOCK),
                          dtype=torch.uint8, device="cuda", generator=gen)
    carry = torch.randint(0, 256, (STREAM_CHANNELS, 128), dtype=torch.uint8,
                          device="cuda", generator=gen)
    image = torch.randint(0, 256, (FRAME_SIZE, FRAME_SIZE), dtype=torch.uint8,
                          device="cuda", generator=gen)
    h2d = np.asarray(FILTER_BANK_2D["sharpen5"])
    frame, (t0, h_img, w_img, rows) = pad_frame(image, h2d.shape[0])
    oframe, (o_t0, o_h, o_w, o_rows) = pad_frame_overlap(image, *h2d.shape)
    rows_f32 = torch.randn((2 * CONFIG5_CHANNELS, 1_333_334), device="cuda",
                           generator=gen)
    re, im = (torch.randn((CONFIG5_CHANNELS, CONFIG5_TIME), device="cuda",
                          generator=gen) for _ in range(2))
    fft_re, fft_im = (torch.randn(FFT_TIMING_SHAPES[0], device="cuda",
                                  generator=gen) for _ in range(2))
    x4 = torch.randint(0, 256, (CONFIG4_CHANNELS, CONFIG4_TIME),
                       dtype=torch.uint8, device="cuda",
                       generator=gen).to(torch.float32)
    cfg = ChainConfig()
    return {
        "fir_band": lambda: (
            fir1d_fixed_rows_auto(x, h5, qf),
            fir1d_fixed_rows_auto(x, design_lowpass(BAND_MAX_TAPS, 0.2), qf)),
        "copy_rows": lambda: copy_rows_(x.clone()),
        "fir_direct": lambda: (
            fir1d_fixed_rows_pallas(x, h5, qf),
            fir1d_fixed_rows_pallas(x, design_lowpass(
                DIRECT_DETERMINISM_TAPS, 0.25), qf)),
        "fir_window": lambda: fir1d_fixed_rows_mxu_window(
            x, design_lowpass(LONG_TAPS, 0.2), qf),
        "window_rows": lambda: window_rows_pallas(block, carry, sub, g),
        "fir2d_frame": lambda: fir2d_fixed_frame(
            frame, h2d, core=(t0, h_img, w_img), block_rows=rows),
        "fir2d_oframe": lambda: fir2d_fixed_frame_overlap(
            oframe, h2d, core=(o_t0, o_h, o_w), block_rows=o_rows),
        "fir2d_bf16": lambda: fir2d_frame_overlap_bf16(
            oframe, h2d, core=(o_t0, o_h, o_w), block_rows=o_rows),
        "fir_float": lambda: fir1d_ideal_rows_band(rows_f32,
                                                   design_lowpass(63, 0.2)),
        "resample": lambda: resample_poly_band(
            re, cfg.resample_filter(), cfg.resample_up, cfg.resample_down),
        "chain_fused": lambda: chain_forward(re, im, cfg),
        "fft_rows": lambda: fft_rows_pallas(fft_re, fft_im),
        "osfilt": lambda: fir_overlap_save_pallas(
            x4[:, :PARALLEL_LONG_TIME],
            design_lowpass(OSFILT_DETERMINISM_TAPS, 0.25)),
        "osfilt_stream": lambda: fir_overlap_save_pallas(
            x4, design_lowpass(CONFIG4_TAPS, 0.25)),
    }


def fixed_digests(store: ArtifactStore) -> dict:
    return {f"{tap}/{path.name}": hashlib.sha256(path.read_bytes()).hexdigest()
            for tap in (3, 5)
            for path in sorted(store.vector_dir("fixed", tap).glob("*.npy"))}


def interval_union(spans: list) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def read_trace(trace_dir: Path) -> dict:
    """Kernel A's launches, the device's kernel and copy time, and the
    device busy share from the ``torch.profiler`` trace in ``trace_dir``:
    the union of the GPU kernel and memcpy intervals over the span from
    the first to the last event of the profiled region."""
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}, found "
                             f"{[f.name for f in files]}")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    a_events = [e for e in kernels
                if any(name in e["name"] for name in KERNEL_A_NAMES)]
    # The host-side call (runtime or driver API) each launch correlates to.
    host_calls = {e["args"]["correlation"]: f"{e['cat']}:{e['name']}"
                  for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
    a_calls = [host_calls.get(e.get("args", {}).get("correlation"))
               for e in a_events]
    by_copy: dict = {}
    for e in copies:
        entry = by_copy.setdefault(e["name"], {"events": 0, "ms": 0.0,
                                               "bytes": 0})
        entry["events"] += 1
        entry["ms"] += e["dur"] / 1e3
        entry["bytes"] += e.get("args", {}).get("bytes", 0)
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy_us = interval_union([(e["ts"], e["ts"] + e["dur"])
                              for e in kernels + copies])
    return {
        "file_bytes": files[0].stat().st_size,
        "events": len(events),
        "kernel_a_events": len(a_events),
        "kernel_a_names": sorted({e["name"] for e in a_events}),
        "kernel_a_with_host_launch": sum(call is not None for call in a_calls),
        "kernel_a_launch_calls": sorted({c for c in a_calls if c}),
        "kernel_a_device_ms": sum(e["dur"] for e in a_events) / 1e3,
        "kernel_events": len(kernels),
        "kernel_device_ms": sum(e["dur"] for e in kernels) / 1e3,
        "memcpy_events": len(copies),
        "memcpy_device_ms": sum(e["dur"] for e in copies) / 1e3,
        "memcpy_by_kind": by_copy,
        "window_ms": (hi - lo) / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (hi - lo),
    }


def run_traced_fixed_stage(card: str) -> tuple[dict, dict]:
    """The CLI's fixed stage alone over phase 4's corpus with ``--backend
    auto --profile``: kernel A alone, the fixed outputs' bytes unchanged,
    and at least FIXED_OUTPUTS of A's kernels in the trace."""
    root = WORK_DIR / "artifacts"
    store = ArtifactStore(root)
    trace_dir = WORK_DIR / "trace"
    before = fixed_digests(store)
    if len(before) != FIXED_OUTPUTS:
        raise AssertionError(f"{len(before)} fixed outputs before the traced "
                             f"run, expected {FIXED_OUTPUTS}")
    reset_launch_counts()
    start = time.perf_counter()
    cli_main(["--artifact-root", str(root), "--device", "cuda", "--backend",
              "auto", "--skip-input", "--skip-ideal", "--skip-report",
              "--skip-restore", "--overwrite-vectors", "--profile",
              str(trace_dir)])
    traced_s = time.perf_counter() - start
    counts = launch_counts()
    only(counts, "fir_band", FIXED_OUTPUTS, "traced fixed stage")
    if fixed_digests(store) != before:
        raise AssertionError("the traced fixed stage wrote other bytes")
    summary = {"host_s": traced_s, **read_trace(trace_dir)}
    print(f"[chip_smoke] traced fixed stage (--backend auto --profile): "
          f"{json.dumps(summary)} [{card}]", flush=True)
    if summary["kernel_a_events"] < FIXED_OUTPUTS:
        raise AssertionError(f"{summary['kernel_a_events']} kernel-A events "
                             f"in the trace, expected >= {FIXED_OUTPUTS}")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, summary


def run_tools(card: str, band_ms: float) -> tuple[dict, dict]:
    """Phase 15: the ported host tools, ``nan_guard``,
    ``assert_deterministic``, ``trace`` and ``chained_throughput`` on the
    card.  Returns the traced run's launch counts and the phase's
    results."""
    qf = QFormat()
    h5 = np.asarray(FILTER_BANKS[5]["sharpen"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    result: dict = {}

    # 1. The C++ fixed-point oracle against kernel A, bit for bit.
    y = fir1d_fixed_rows_auto(x, h5, qf)
    x_host = x.cpu().numpy()
    start = time.perf_counter()
    oracle = native.fir1d_fixed_rows_native(x_host, h5, qf)
    result["oracle_host_s"] = time.perf_counter() - start
    compare = native.bit_compare_u8(y, oracle)
    print(f"[chip_smoke] C++ oracle vs kernel A at {BENCH_SHAPE[0]}x"
          f"{BENCH_SHAPE[1]} u8, 5-tap sharpen, Q4.12: {json.dumps(compare)}; "
          f"oracle {result['oracle_host_s']:.3f} s host clock "
          f"({x.numel() / result['oracle_host_s'] / 1e6:.1f} Msamples/s) "
          f"[{card}]", flush=True)
    if not compare["bit_exact"]:
        raise AssertionError(f"kernel A != the C++ oracle: {compare}")
    result["oracle_compare"] = compare
    del y, x_host, oracle

    # 2. The native radix-2 FFT against kernel K on one row.
    xr, xi = (torch.randn((1, NATIVE_FFT_POINTS), device="cuda",
                          generator=gen) for _ in range(2))
    yr, yi = fft_rows_pallas(xr, xi)
    nr, ni = native.fft_radix2_native(xr[0], xi[0])
    want = nr + 1j * ni
    got = yr[0].cpu().double().numpy() + 1j * yi[0].cpu().double().numpy()
    result["native_fft_snr_db"] = float(10 * np.log10(
        np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)))
    print(f"[chip_smoke] native FFT vs kernel K, one {NATIVE_FFT_POINTS}-point "
          f"complex row: {result['native_fft_snr_db']:.2f} dB", flush=True)
    if not result["native_fft_snr_db"] >= 120.0:
        raise AssertionError(f"kernel K vs the native FFT: "
                             f"{result['native_fft_snr_db']:.2f} dB < 120")

    # 3. Every kernel, through its entry, byte for byte over two runs.
    start = time.perf_counter()
    result["deterministic"] = {}
    for name, entry in determinism_entries(x, gen).items():
        reset_launch_counts()
        assert_deterministic(entry)
        torch.cuda.synchronize()
        only(launch_counts(), name, 2, f"determinism of {name}")
        result["deterministic"][name] = True
    print(f"[chip_smoke] deterministic over two runs: "
          f"{sorted(result['deterministic'])} "
          f"({time.perf_counter() - start:.1f} s)", flush=True)

    # 4. nan_guard: the float paths run clean under it; a NaN raises, from
    # an aten op and from the kernels' wrappers.
    cfg = ChainConfig()
    staged_cfg = dataclasses.replace(cfg, channelizer_backend="mxu")
    re, im = fm_planes(np.random.default_rng(CONFIG5_SEED + 15),
                       CONFIG5_CHANNELS, GUARD_CHAIN_TIME, cfg.demod_k_f)
    x4 = torch.randint(0, 256, (CONFIG4_CHANNELS, GUARD_CONFIG4_TIME),
                       dtype=torch.uint8, device="cuda",
                       generator=gen).to(torch.float32)
    guarded = {}
    with nan_guard():
        for run, fn in (
                ("chain_auto", lambda: chain_forward(re, im, cfg)),
                ("chain_staged", lambda: chain_forward(re, im, staged_cfg)),
                ("config4", lambda: fir_overlap_save_pallas(
                    x4, design_lowpass(CONFIG4_TAPS, 0.25))),
                ("fft_rows", lambda: fft_rows_pallas(xr, xi))):
            reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            guarded[run] = {k: v for k, v in launch_counts().items() if v}
    expected = {"chain_auto": {"chain_fused"},
                "chain_staged": {"resample", "fir_float"},
                "config4": {"osfilt_stream"}, "fft_rows": {"fft_rows"}}
    if {run: set(counts) for run, counts in guarded.items()} != expected:
        raise AssertionError(f"guarded runs launched {guarded}, expected "
                             f"{expected}")
    fir = FloatFir1d(design_lowpass(63, 0.2), "cuda")
    row = torch.ones((1, 4096), device="cuda")
    row[0, 1234] = float("nan")
    raised = {}
    for run, fn in (("aten 0/0", lambda: torch.zeros((), device="cuda") / 0.0),
                    ("kernel fir_float", lambda: fir_float(row, fir)),
                    ("kernel fft_rows", lambda: fft_rows(row, None,
                                                         inverse=False))):
        reset_launch_counts()
        try:
            with nan_guard():
                fn()
        except FloatingPointError as exc:
            raised[run] = str(exc)
        else:
            raise AssertionError(f"nan_guard let a NaN through: {run}")
        kernel = run.split()[-1]
        if run.startswith("kernel") and (kernel not in raised[run]
                                         or launch_counts()[kernel] != 1):
            raise AssertionError(f"{run}: raised {raised[run]!r} with "
                                 f"launches {launch_counts()}")
    result["nan_guard"] = {"clean": guarded, "raised": raised}
    print(f"[chip_smoke] nan_guard: {json.dumps(result['nan_guard'])}",
          flush=True)
    del re, im, x4

    # 5. The traced main path.
    counts, result["trace"] = run_traced_fixed_stage(card)

    # 6. chained_throughput on kernel A's headline step.
    band = FixedFir1d.from_numpy(h5, qf, "cuda")
    chained = chained_throughput(band, x, best_of=CHAINED_BEST_OF)
    ratio = chained["seconds_per_apply"] * 1e3 / band_ms
    result["chained"] = {**chained, "ratio_to_phase9_median": ratio,
                         "times": {str(k): v
                                   for k, v in chained["times"].items()}}
    print(f"[chip_smoke] chained_throughput kernel A {BENCH_SHAPE[0]}x"
          f"{BENCH_SHAPE[1]} u8, 5 taps: "
          f"{chained['samples_per_second']:.6g} samples/s, "
          f"{chained['seconds_per_apply'] * 1e3:.4f} ms an apply (phase 9 "
          f"median {band_ms:.4f} ms, ratio {ratio:.3f}), slopes "
          f"{[s * 1e3 for s in chained['slopes']]} ms [{card}]", flush=True)
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"chained_throughput {ratio:.3f}x phase 9's "
                             "median, outside 2x")
    return counts, result


def check_copy_rows(agree: Agreement, x: torch.Tensor, label: str) -> None:
    """Kernel N on ``x`` against its plain version on a clone: the same
    bytes, the same tensor and storage back, exactly one launch."""
    want = copy_rows_plain(x.clone())
    ptr, before = x.data_ptr(), copy_rows_.launches
    got = copy_rows_(x)
    torch.cuda.synchronize()
    if got is not x or got.data_ptr() != ptr:
        raise AssertionError(f"copy_rows_ {label}: returned another tensor")
    if copy_rows_.launches != before + 1:
        raise AssertionError(f"copy_rows_ {label}: "
                             f"{copy_rows_.launches - before} launches")
    agree.check(got, want, f"copy_rows {label}")


def check_copy_rows_apart(agree: Agreement, x: torch.Tensor,
                          label: str) -> None:
    """Kernel N out of place (``wft_copy_rows`` with two buffers): ``x``
    into a destination at its alignment mod 16 that holds ``~x``, between
    COPY_GUARD bytes of COPY_SENTINEL each side.  The destination must
    equal ``x`` and every guard byte stay as it was, so a kernel that
    drops its head, its tail or a chunk, or writes past either end,
    fails where the in-place identity cannot show it."""
    src = x.reshape(-1)
    n = src.numel()
    buf = torch.full((n + 2 * COPY_GUARD + 16,), COPY_SENTINEL,
                     dtype=torch.uint8, device=x.device)
    lead = COPY_GUARD + (x.data_ptr() - buf.data_ptr()) % 16
    dst = buf[lead : lead + n]
    dst.copy_(~src)
    lib = _build.load_library()
    code = lib.wft_copy_rows(src.data_ptr(), dst.data_ptr(), n,
                             _build.stream_of(x))
    _build.check_launch(lib, code, "copy_rows")
    torch.cuda.synchronize()
    agree.check(dst, src, f"copy_rows out of place {label}")
    guards = torch.cat([buf[:lead], buf[lead + n :]])
    if not bool((guards == COPY_SENTINEL).all()):
        raise AssertionError(f"copy_rows out of place {label}: wrote "
                             "outside its destination")


def run_copy_rows(card: str, agree: Agreement) -> dict:
    """Phase 16, kernel N: ``torch.equal`` to ``copy_rows_plain`` at the
    roofline's sizes, at awkward shapes and on views that start off a
    16-byte boundary, in place through ``copy_rows_`` and out of place
    (:func:`check_copy_rows_apart`); then its median time at
    COPY_TIMING_SHAPE beside
    ``dst.copy_(x)``, the plain version and the bound, refusing a time
    under COPY_MIN_BOUND_SHARE of the bound (an elided copy)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                             generator=gen)

    for rows in COPY_ROWS:
        x = rand(rows, 8192)
        check_copy_rows_apart(agree, x, f"{rows}x8192")
        check_copy_rows(agree, x, f"{rows}x8192")
    for shape in COPY_SHAPES:
        x = rand(*shape)
        check_copy_rows_apart(agree, x, f"{shape[0]}x{shape[1]}")
        check_copy_rows(agree, x, f"{shape[0]}x{shape[1]}")
    for offset in COPY_OFFSETS:
        base = rand(5 * 1001 + 16)
        view = base[offset : offset + 5 * 1001].view(5, 1001)
        label = f"5x1001 at byte offset {offset}"
        check_copy_rows_apart(agree, view, label)
        check_copy_rows(agree, view, label)
    x = rand(*COPY_TIMING_SHAPE)
    dst = torch.empty_like(x)
    med = median_ms({"copy_rows": lambda: copy_rows_(x),
                     "copy_": lambda: dst.copy_(x),
                     "plain": lambda: copy_rows_plain(x)},
                    TIMING_REPS, TIMING_LAUNCHES)
    bound_ms = bound(2 * x.numel(), 0, "int8")["bound_ms"]
    times = {name: m for name, (m, _, _) in med.items()}
    for name, (m, lo, hi) in med.items():
        print(f"[chip_smoke] time {name} {COPY_TIMING_SHAPE[0]}x"
              f"{COPY_TIMING_SHAPE[1]} u8: median {m:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f}); bound {bound_ms:.4f} ms [{card}]", flush=True)
    if times["copy_rows"] < COPY_MIN_BOUND_SHARE * bound_ms:
        raise AssertionError(
            f"copy_rows_ took {times['copy_rows']:.4f} ms, under "
            f"{COPY_MIN_BOUND_SHARE} of its {bound_ms:.4f} ms bound: the "
            "copy did not reach memory")
    return times


def bench_gates(name: str, line: dict) -> dict:
    """The gates of a bench's JSON line, each of which must be True."""
    gates = {"no_error": "error" not in line}
    if name in ("bench", "bench_2d"):
        gates["bit_exact_vs_golden"] = line.get("bit_exact_vs_golden")
    elif name == "bench_taps":
        gates.update({f"bit_exact_{taps}": d.get("bit_exact")
                      for taps, d in line.get("details", {}).items()})
    elif name == "bench_streaming":
        gates.update({gate: line.get(gate) for gate in bench_streaming.GATES})
    elif name == "bench_configs":
        gates.update({config: entry.get("pass")
                      for config, entry in line.get("configs", {}).items()})
    elif name == "bench_roofline":
        gates["probes"] = bool(line.get("probes"))
    elif name in ("bench_scaling_overhead", "bench_scaling_weak"):
        gates["bit_exact_vs_unsharded"] = line.get("bit_exact_vs_unsharded")
    return gates


def run_benches() -> tuple[dict, dict]:
    """Phase 16, the benches: each in its quick form through its ``main``
    in this process, its JSON line parsed and every gate held; the launch
    counts zeroed before each run and read after it."""
    counts, lines = {}, {}
    for name, main_fn, argv, kernels in BENCH_RUNS:
        start = time.perf_counter()
        reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        seconds = time.perf_counter() - start
        print(f"[chip_smoke] {name} {' '.join(argv)} (rc {rc}, "
              f"{seconds:.1f} s): {json.dumps(line)}", flush=True)
        gates = bench_gates(name, line)
        missing = [k for k in kernels if not counts[name][k]]
        if rc != 0 or not all(v is True for v in gates.values()) or missing:
            raise AssertionError(f"{name}: rc {rc}, gates {gates}, kernels "
                                 f"not launched {missing}")
        lines[name] = {"rc": rc, "seconds": seconds, "line": line}
    return counts, lines


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # Kernel G's plain version multiplies in f32 on the card, and the
    # channelizer's yardstick F.conv1d must compute kernel H's f32
    # function: no TF32 in either.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[chip_smoke] card: {card}", flush=True)
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    try:
        import PIL  # noqa: F401

        have_pil = True
    except ImportError:
        have_pil = False
    print(f"[chip_smoke] Pillow installed: {have_pil}", flush=True)

    phase("2 build")
    shutil.rmtree(_build.DEFAULT_BUILD_DIR, ignore_errors=True)
    start = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - start
    print(f"[chip_smoke] build: {build_s:.2f} s (nvcc {_build.find_nvcc()}, "
          f"{len(_build.kernel_sources())} sources)", flush=True)
    start = time.perf_counter()
    native.load_native()
    print(f"[chip_smoke] native tools build: {time.perf_counter() - start:.2f}"
          f" s ({_build.find_cxx()}, {len(_build.TOOLS_SOURCES)} sources)",
          flush=True)

    phase("3 kernels vs plain")
    agree = {name: Agreement() for name in KERNELS}
    check_kernels(agree)

    phase("4 main path")
    launches = run_main_path(have_pil)

    phase("5 stream 5-tap")
    stream_5tap = run_stream("5tap", np.asarray(FILTER_BANKS[5]["sharpen"]),
                             STREAM_BLOCKS)
    launches["stream_5tap"] = counts = stream_5tap["launches"]
    if (counts["window_rows"] < STREAM_BLOCKS or counts["fir_band"] < STREAM_BLOCKS
            or counts["fir_window"] or counts["fir_direct"]):
        raise AssertionError(f"5-tap stream launches {counts}: expected "
                             "kernels D and A only")

    phase("6 stream long-tap")
    launches[f"stream_{LONG_TAPS}tap"] = counts = run_stream(
        f"{LONG_TAPS}tap", design_lowpass(LONG_TAPS, 0.2),
        LONG_BLOCKS)["launches"]
    if (counts["fir_window"] < LONG_BLOCKS or counts["fir_band"]
            or counts["window_rows"] or counts["fir_direct"]):
        raise AssertionError(f"long-tap stream launches {counts}: expected "
                             "kernel C only")

    phase("7 2-D config 3")
    launches.update(run_config3())

    phase("8 2-D frames")
    launches.update(run_frames(agree))

    phase("9 times")
    medians = time_kernels(card)
    band_times = time_band(card)
    long_taps = time_long_taps(card)
    direct_long = time_direct_long(card)
    sustained_ms = (STREAM_CHANNELS * STREAM_BLOCK
                    / stream_5tap["msamples_per_s"] / 1e3)
    split = time_stream_step(card, sustained_ms)
    times_2d = time_2d(card, agree)

    phase("10 chain kernels vs plain")
    cfg5 = ChainConfig()
    fm = fm_planes(np.random.default_rng(CONFIG5_SEED + 1), CONFIG5_CHANNELS,
                   CONFIG5_TIME, cfg5.demod_k_f)
    chain_agree = {name: FloatAgreement() for name in (
        "fir_float", "resample", "chain_fused", "chain_fused_bf16",
        "chain_fused_bf16_own")}
    check_chain_kernels(chain_agree, fm)

    phase("11 config 5")
    counts5, config5 = run_config5(fm)
    launches.update(counts5)
    times_chain = time_chain(card, fm)

    phase("12 FFT kernels vs plain")
    fft_agree = {name: FloatAgreement()
                 for name in ("fft_rows", "osfilt", "osfilt_stream")}
    fft_agree_u8 = {name: U8Agreement() for name in ("osfilt", "osfilt_stream")}
    check_fft_kernels(fft_agree, fft_agree_u8)

    phase("13 config 4")
    counts4, config4, (x4_u8, x4, h4) = run_config4(fft_agree)
    launches.update(counts4)
    counts_chain, chain_fft = run_chain_fft(fft_agree, fm, card)
    launches.update(counts_chain)
    times_fft = time_fft(card, fft_agree, x4_u8, x4, h4)
    del x4_u8

    phase("14 parallel")
    counts14, parallel, times14 = run_parallel(card, x4, h4, fm)
    launches.update(counts14)
    del x4, fm

    phase("15 tools")
    launches["traced_fixed_stage"], tools = run_tools(card, band_times[5])

    phase("16 benches")
    copy_agree = Agreement()
    copy_times = run_copy_rows(card, copy_agree)
    counts16, benches = run_benches()
    launches.update(counts16)
    print(f"[chip_smoke] phases done at {time.perf_counter() - START:.1f} s",
          flush=True)

    def counted(name: str) -> dict:
        runs = {f"launches_{run}": run_counts[name]
                for run, run_counts in launches.items()}
        return {"launches": sum(runs.values()), **runs}

    # Bounds of the timed calls, from this run's shapes and taps: each
    # input byte read once, each output byte written once; the integer
    # kernels' multiply-adds at the int8 rate and kernel G's (bf16 taps by
    # samples) at the bf16 rate, counting nonzero taps only.
    qf = QFormat()
    samples = BENCH_SHAPE[0] * BENCH_SHAPE[1]
    nnz_5 = int(np.count_nonzero(qf.quantize_coeffs(
        np.asarray(FILTER_BANKS[5]["sharpen"]))))
    nnz_taps = {taps: int(np.count_nonzero(qf.quantize_coeffs(
        design_lowpass(taps, 0.2))))
        for taps in (*LONG_TIMING_TAPS, *BAND_YARDSTICK_TAPS)}
    nnz_long = nnz_taps[LONG_TAPS]
    nnz_2d = int(np.count_nonzero(qf.quantize_coeffs(
        np.asarray(FILTER_BANK_2D["sharpen5"]))))
    frame_samples = FRAME_SIZE * FRAME_SIZE
    block_samples = STREAM_CHANNELS * (STREAM_BLOCK + LONG_TAPS - 1)
    bounds = {
        "fir_band": bound(2 * samples, 2 * nnz_5 * samples, "int8"),
        "fir_direct": bound(2 * samples, 2 * nnz_5 * samples, "int8"),
        "fir_window": bound(2 * samples, 2 * nnz_long * samples, "int8"),
        "fir_window_block": bound(2 * block_samples,
                                  2 * nnz_long * block_samples, "int8"),
        **{f"fir_window_{taps}": bound(2 * samples, 2 * nnz * samples, "int8")
           for taps, nnz in nnz_taps.items() if taps in LONG_TIMING_TAPS},
        **{f"fir_band_{taps}": bound(2 * samples, 2 * nnz_taps[taps] * samples,
                                     "int8")
           for taps in BAND_YARDSTICK_TAPS},
        **{f"fir_direct_{taps}": bound(2 * samples, 2 * d["nnz"] * samples,
                                       "int8")
           for taps, d in direct_long.items()},
        "window_rows": bound(split["bytes"], 0, "int8"),
        **{kind: bound(2 * times_2d["frame_numel"][kind],
                       2 * nnz_2d * frame_samples,
                       "bf16" if kind == "fir2d_bf16" else "int8")
           for kind in KERNELS_2D},
        **{f"fir2d_frame_{label}": bound(
            2 * times_2d["frame_numel_e"][label],
            2 * nnz * frame_samples, "int8")
           for label, nnz in times_2d["nnz_e"].items()},
        **{name: bound(*times_chain["work"][name], "f32")
           for name in ("fir_float", "resample", "chain_fused",
                        "chain_fused_bf16")},
        **{name: bound(*work, "f32")
           for name, work in times_fft["work"].items()},
    }
    bounds["fft_rows"] = bounds[f"fft_rows_{FFT_TIMING_SHAPES[0][1]}"]
    bounds["copy_rows"] = bound(
        2 * COPY_TIMING_SHAPE[0] * COPY_TIMING_SHAPE[1], 0, "int8")

    def bounded(name: str) -> dict:
        """The bound, the bytes it counts and those bytes' time at the
        rate this run's ``copy_`` of the chain's input reached."""
        b = bounds[name]
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bytes": b["bytes"], "bytes_at_copy_rate_ms":
                b["bytes"] / times_chain["copy_bytes_per_s"] * 1e3}

    kernels = [
        {"name": "fir_band", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/fir_band.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/fir_mxu.py:248",
         "also_replaces": "warmup_fir_filter_tpu/kernels/fir_mxu.py:371",
         **counted("fir_band"),
         "max_abs_err": agree["fir_band"].max_abs_err,
         "comparisons": agree["fir_band"].count,
         "ms": band_times[5], "plain_ms": medians["torch_direct"],
         **bounded("fir_band"), "library_ms": None,
         "ms_beside_plain": medians["fir_band"],
         "ms_stream_windows": split["fir_band"],
         "ms_stream_windows_alone": band_times["windows"],
         **{f"ms_{taps}tap": band_times[taps] for taps in BAND_TIMING_TAPS},
         **{f"yardstick_fir_window_ms_{taps}tap": band_times[("C", taps)]
            for taps in BAND_YARDSTICK_TAPS},
         **{f"plain_ms_{taps}tap": band_times[("plain", taps)]
            for taps in BAND_TIMING_TAPS},
         **{f"bound_ms_{taps}tap": bounds[f"fir_band_{taps}"]["bound_ms"]
            for taps in BAND_YARDSTICK_TAPS},
         **{f"share_of_bound_{taps}tap":
            bounds[f"fir_band_{taps}"]["bound_ms"] / band_times[taps]
            for taps in BAND_YARDSTICK_TAPS}},
        {"name": "fir_direct", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/fir_direct.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/fir_pallas.py:62",
         **counted("fir_direct"),
         "max_abs_err": agree["fir_direct"].max_abs_err,
         "comparisons": agree["fir_direct"].count,
         "ms": medians["fir_direct"], "plain_ms": medians["fir_direct_plain"],
         "int32_path_ms": medians["torch_direct"],
         "ms_entry": medians["fir_direct_entry"],
         **bounded("fir_direct"), "library_ms": None,
         **{f"ms_{taps}tap": long_taps[taps]["fir_direct"]
            for taps in LONG_TIMING_TAPS},
         **{f"{key}_{taps}tap": value
            for taps in DIRECT_TIMING_TAPS
            for key, value in (
                ("ms", direct_long[taps]["ms"]),
                ("bound_ms", bounds[f"fir_direct_{taps}"]["bound_ms"]),
                ("bound_by", bounds[f"fir_direct_{taps}"]["bound_by"]))}},
        {"name": "fir_window", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/fir_window.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/fir_mxu.py:792",
         **counted("fir_window"),
         "max_abs_err": agree["fir_window"].max_abs_err,
         "comparisons": agree["fir_window"].count,
         "ms": long_taps[LONG_TAPS]["fir_window"],
         "plain_ms": long_taps[LONG_TAPS]["torch_direct"],
         **bounded("fir_window"), "library_ms": None,
         "ms_stream_block": long_taps[LONG_TAPS]["fir_window_block"],
         "bound_ms_stream_block": bounds["fir_window_block"]["bound_ms"],
         **{f"{key}_{taps}tap": long_taps[taps][name]
            for taps in LONG_TIMING_TAPS
            for key, name in (("ms", "fir_window"),
                              ("plain_ms", "torch_direct"))},
         **{f"bound_ms_{taps}tap": bounds[f"fir_window_{taps}"]["bound_ms"]
            for taps in LONG_TIMING_TAPS}},
        {"name": "window_rows", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/window_copy.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/window_copy.py:47",
         **counted("window_rows"),
         "max_abs_err": agree["window_rows"].max_abs_err,
         "comparisons": agree["window_rows"].count,
         "ms": split["window_rows"], "plain_ms": split["window_rows_plain"],
         **bounded("window_rows"), "library_ms": None},
    ]
    for kind, source, line in (("fir2d_frame", "fir2d_frame.cu", 173),
                               ("fir2d_oframe", "fir2d_frame.cu", 571),
                               ("fir2d_bf16", "fir2d_bf16.cu", 1000)):
        kernels.append({
            "name": kind, "route": "cuda",
            "source": f"warmup_fir_filter_tpu_torch/csrc/{source}",
            "replaces": f"warmup_fir_filter_tpu/kernels/fir2d_mxu.py:{line}",
            **counted(kind), "max_abs_err": agree[kind].max_abs_err,
            "comparisons": agree[kind].count,
            "ms": times_2d["sharpen5"][kind],
            "plain_ms": times_2d["sharpen5"][f"{kind}_plain"],
            **bounded(kind), "library_ms": None,
            "torch_ms": times_2d["sharpen5"]["torch"],
            "copy_ms": times_2d["sharpen5"]["copy"],
            "ms_gauss5": times_2d["gauss5"][kind],
            **({f"{key}_{label}": value
                for label, ms in times_2d["fir2d_frame_e"].items()
                for key, value in (
                    ("ms", ms), ("bound_ms",
                                 bounds[f"fir2d_frame_{label}"]["bound_ms"]),
                    ("bound_by", bounds[f"fir2d_frame_{label}"]["bound_by"]))}
               if kind == "fir2d_frame" else {})})
    for name, source, replaces, plain, library in (
            ("fir_float", "fir_float.cu", "fir_float_mxu.py:106",
             "fir_float_plain", "conv1d"),
            ("resample", "resample.cu", "resample_mxu.py:96",
             "resample_plain", "resample_conv1d"),
            ("chain_fused", "chain_fused.cu", "chain_fused.py:133",
             "chain_fused_plain", None)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"warmup_fir_filter_tpu_torch/csrc/{source}",
            "replaces": f"warmup_fir_filter_tpu/kernels/{replaces}",
            **counted(name), "max_abs_err": chain_agree[name].max_abs_err,
            "min_snr_db": finite(chain_agree[name].min_snr_db),
            "comparisons": chain_agree[name].count,
            "ms": times_chain[name], "plain_ms": times_chain[plain],
            **bounded(name),
            "library_ms": times_chain[library] if library else None})
    kernels[-2].update({
        "library_call": "F.pad, F.conv1d (P output channels at stride Q, "
                        "TF32 off), interleave",
        "library_snr_db": times_chain["resample_conv1d_snr_db"]})
    kernels[-1].update({
        "ms_bf16": times_chain["chain_fused_bf16"],
        "bound_ms_bf16": bounds["chain_fused_bf16"]["bound_ms"],
        "min_snr_db_bf16_vs_f32": finite(
            chain_agree["chain_fused_bf16"].min_snr_db),
        "ms_chain_auto": times_chain["chain_auto"],
        "ms_chain_staged": times_chain["chain_staged"],
        "ms_demod": times_chain["demod"], "copy_ms": times_chain["copy"]})

    def fft_kernel(name: str, source: str, replaces: int, also: tuple,
                   ms: float, plain_ms: float, library_ms: float,
                   **extra) -> dict:
        return {
            "name": name, "route": "cuda",
            "source": f"warmup_fir_filter_tpu_torch/csrc/{source}",
            "replaces": f"warmup_fir_filter_tpu/kernels/fft_pallas.py:{replaces}",
            "also_replaces": [f"warmup_fir_filter_tpu/kernels/fft_pallas.py:"
                              f"{line}" for line in also],
            **counted(name), "max_abs_err": fft_agree[name].max_abs_err,
            "min_snr_db": finite(fft_agree[name].min_snr_db),
            "comparisons": fft_agree[name].count, "ms": ms,
            "plain_ms": plain_ms, **bounded(name), "library_ms": library_ms,
            **extra}

    (_, n_a), *others = FFT_TIMING_SHAPES
    t = times_fft
    kernels += [
        fft_kernel("fft_rows", "fft_rows.cu", 406, (418, 424),
                   t[f"fft_rows_{n_a}"], t[f"fft_rows_plain_{n_a}"],
                   t[f"torch_fft_{n_a}"], shape=list(FFT_TIMING_SHAPES[0]),
                   **{f"{key}_{n}": value for _, n in others
                      for key, value in (
                          ("ms", t[f"fft_rows_{n}"]),
                          ("plain_ms", t[f"fft_rows_plain_{n}"]),
                          ("library_ms", t[f"torch_fft_{n}"]),
                          ("bound_ms", bounds[f"fft_rows_{n}"]["bound_ms"]))}),
        fft_kernel("osfilt", "osfilt.cu", 519, (436,), t["osfilt"],
                   t["osfilt_plain"], t["conv1d"], nfft=CONFIG4_PINNED_NFFT,
                   ms_chain_shape=chain_fft["osfilt_chain_ms"],
                   ms_chain_auto_259=chain_fft["chain_auto_259_ms"],
                   max_abs_err_u8=fft_agree_u8["osfilt"].max_abs_err,
                   share_differing_u8=fft_agree_u8["osfilt"].max_share),
        fft_kernel("osfilt_stream", "osfilt_stream.cu", 622, (),
                   t["osfilt_stream"], t["osfilt_stream_plain"], t["conv1d"],
                   ms_u8=t["osfilt_stream_u8"], windows=t["windows"],
                   bound_ms_u8=bounds["osfilt_stream_u8"]["bound_ms"],
                   torch_fft_overlap_save_ms=t["torch_fft_overlap_save"],
                   entry_ms=t["entry"], copy_ms=t["copy"],
                   max_abs_err_u8=fft_agree_u8["osfilt_stream"].max_abs_err,
                   share_differing_u8=fft_agree_u8["osfilt_stream"].max_share,
                   config4={key: value for key, value in config4.items()
                            if key != "launches"},
                   chain_pallas_vs_staged_snr_db=chain_fft[
                       "chain_pallas_snr_db"],
                   ms_chain_shape=chain_fft["osfilt_stream_chain_ms"],
                   ms_chain_pallas=chain_fft["chain_pallas_ms"]),
    ]
    kernels.append({
        "name": "copy_rows", "route": "cuda",
        "source": "warmup_fir_filter_tpu_torch/csrc/copy_rows.cu",
        "replaces": "bench_roofline.py:46",
        "also_replaces": ["bench_roofline.py:54", "bench_roofline.py:62"],
        **counted("copy_rows"), "max_abs_err": copy_agree.max_abs_err,
        "comparisons": copy_agree.count, "ms": copy_times["copy_rows"],
        "plain_ms": copy_times["plain"], **bounded("copy_rows"),
        "library_ms": copy_times["copy_"],
        "library_call": "dst.copy_(x), out of place",
        "shape": list(COPY_TIMING_SHAPE),
        "benches": {name: {"seconds": b["seconds"], "value": b["line"].get(
            "value")} for name, b in benches.items()}})
    # Phase 14's sharded paths: each run's launches of the kernel, and the
    # sharded (world 1) and unsharded medians where the run was timed.
    by_name = {kernel["name"]: kernel for kernel in kernels}
    for name, runs in (
            ("fir_band", ("fir1d", "bank", "spmd", "fir1d_shards")),
            ("fir2d_oframe", ("fir2d", "fir2d_shards")),
            ("fir2d_frame", ("fir2d_e",)),
            ("chain_fused", ("chain", "chain_time", "chain_time_shards")),
            ("osfilt_stream", ("config4", "config4_shards")),
            ("osfilt", ("config4_259tap",)),
            ("resample", ("pipeline_pipelined", "pipeline_sequential")),
            ("fir_float", ("pipeline_pipelined", "pipeline_sequential"))):
        by_name[name]["sharded_path"] = {
            run: {"launches": counts14[f"parallel_{run}"][name],
                  **times14.get(run, {})} for run in runs}
    by_name["resample"]["sharded_path"]["pipeline_wall_s"] = parallel[
        "pipeline_wall_s"]
    # Phase 15: every kernel byte-identical over two runs of its entry; A
    # against the C++ oracle, traced and timed by chained_throughput; K
    # against the native FFT.
    for kernel in kernels:
        kernel["deterministic"] = tools["deterministic"][kernel["name"]]
    trace = tools["trace"]
    by_name["fir_band"].update({
        "oracle_bit_exact": tools["oracle_compare"]["bit_exact"],
        "oracle_host_s": tools["oracle_host_s"],
        "ms_chained_throughput": tools["chained"]["seconds_per_apply"] * 1e3,
        "trace_events": trace["kernel_a_events"],
        "trace_device_ms": trace["kernel_a_device_ms"],
        "traced_fixed_stage_busy_share": trace["busy_share"]})
    by_name["fft_rows"]["native_fft_snr_db"] = tools["native_fft_snr_db"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
