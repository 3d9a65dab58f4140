"""Ranks of the port's sharded entries, for ``tests/test_torch_parallel.py``
and for cards.

One rank of a world (started by :func:`spawn_world`)::

    python tests/test_torch_parallel_worker.py rank RANK WORLD PORT OUT.npz DEVICE

joins the world through the port's ``initialize_multihost(...,
device=DEVICE)`` (``cpu``: gloo; ``cuda``: NCCL, a card a rank), builds the
meshes of its world with ``make_mesh`` and runs every case of :data:`CASES`
for that world through the port's sharded entries, on the inputs of
:func:`make_inputs`.  Rank 0 writes each case's gathered output to
``OUT.npz`` under ``<case>/<name>``; a case that must be refused records the
exception's type and message instead.

On a machine with four cards, the same cases over NCCL, held against the
outputs of the gloo worlds (from ``worlds cpu`` on any host)::

    python tests/test_torch_parallel_worker.py worlds cuda OUT_DIR
    python tests/test_torch_parallel_worker.py compare GLOO_DIR OUT_DIR

The module defines the cases and their inputs for the test file too; it
has no test functions, imports nothing of JAX, and does nothing on
import.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np

WORKER = Path(__file__).resolve()
REPO_ROOT = WORKER.parent.parent

#: The mesh of each world size and name.
MESHES = {
    "world1": {"data": 1, "time": 1},
    "time2": {"data": 1, "time": 2},
    "time4": {"data": 1, "time": 4},
    "dt22": {"data": 2, "time": 2},
    "stage2": {"stage": 2},
    "stage4": {"stage": 4},
}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    mesh: str
    kind: str
    params: tuple = ()

    @property
    def world(self) -> int:
        return int(np.prod(list(MESHES[self.mesh].values())))

    def param(self, key, default=None):
        return dict(self.params).get(key, default)


def _case(name, mesh, kind, **params) -> Case:
    return Case(name, mesh, kind, tuple(sorted(params.items())))


#: The JAX parallel tests' cases at the mesh shapes a world of 1, 2 or 4
#: holds.  ``shape`` is the global input, ``taps`` names the filter
#: (:func:`make_inputs`), ``reject`` marks a case the entry must refuse.
CASES = [
    # fir1d_fixed_sharded (tests/test_parallel_halo.py)
    _case("fir1d_sharpen5_time4", "time4", "fir1d", taps="sharpen5",
          shape=(4, 4 * 40)),
    _case("fir1d_sharpen3_time2", "time2", "fir1d", taps="sharpen3",
          shape=(4, 2 * 40)),
    _case("fir1d_edge5_dt22", "dt22", "fir1d", taps="edge5",
          shape=(6, 2 * 64)),
    _case("fir1d_even4_time4", "time4", "fir1d", taps="even4",
          shape=(3, 4 * 32)),
    _case("fir1d_single_tap_time4", "time4", "fir1d", taps="one",
          shape=(2, 4 * 16)),
    _case("fir1d_wrap_dt22", "dt22", "fir1d", taps="wrap3", acc_bits=16,
          shape=(4, 2 * 48)),
    _case("fir1d_half_shard_time4", "time4", "fir1d", taps="moving_avg5",
          shape=(2, 4 * 8)),
    _case("fir1d_shard_as_narrow_as_halo_time4", "time4", "fir1d",
          taps="lowpass9", shape=(2, 4 * 4)),
    _case("fir1d_300tap_time2", "time2", "fir1d", taps="lowpass300",
          shape=(2, 2 * 400)),
    _case("fir1d_world1", "world1", "fir1d", taps="sharpen5",
          shape=(3, 50)),
    _case("fir1d_halo_wider_than_shard_time4", "time4", "fir1d",
          taps="lowpass9", shape=(2, 4 * 2), reject="ValueError"),
    _case("fir1d_indivisible_time4", "time4", "fir1d", taps="one",
          shape=(2, 102), reject="ValueError"),
    # fir2d_fixed_sharded (tests/test_parallel_halo.py::Test2DSharded)
    _case("fir2d_gauss5_dt22", "dt22", "fir2d", taps="gauss5",
          shape=(2 * 24, 2 * 32)),
    _case("fir2d_gauss5_time4", "time4", "fir2d", taps="gauss5",
          shape=(24, 4 * 32)),
    _case("fir2d_sharpen5_time2", "time2", "fir2d", taps="sharpen5_2d",
          shape=(20, 2 * 24)),
    _case("fir2d_even_corners_dt22", "dt22", "fir2d", taps="even2x4",
          shape=(2 * 16, 2 * 40)),
    _case("fir2d_tall_dt22", "dt22", "fir2d", taps="tall9x3",
          shape=(2 * 8, 2 * 16)),
    _case("fir2d_world1", "world1", "fir2d", taps="gauss5",
          shape=(17, 23)),
    _case("fir2d_indivisible_dt22", "dt22", "fir2d", taps="gauss5",
          shape=(31, 2 * 32), reject="ValueError"),
    _case("fir2d_halo_wider_than_shard_time4", "time4", "fir2d",
          taps="wide3x9", shape=(8, 4 * 2), reject="ValueError"),
    # The halo rings themselves: zero edges at the ends of each axis.
    _case("halo1d_time4", "time4", "halo1d", shape=(3, 4 * 8), widths=(2, 3)),
    _case("halo1d_time2", "time2", "halo1d", shape=(2, 2 * 5), widths=(4, 1)),
    _case("halo1d_world1", "world1", "halo1d", shape=(2, 7), widths=(3, 2)),
    _case("halo2d_dt22", "dt22", "halo2d", shape=(2 * 6, 2 * 8),
          widths=(1, 2, 2, 1)),
    _case("halo2d_time4", "time4", "halo2d", shape=(5, 4 * 6),
          widths=(2, 1, 3, 3)),
    # filter_bank_fixed_sharded (tests/test_expert_fft_sharded.py)
    _case("bank_dt22", "dt22", "bank", axis="data", shape=(6, 200)),
    _case("bank_time4", "time4", "bank", axis="time", shape=(6, 200)),
    _case("bank_time2", "time2", "bank", axis="time", shape=(3, 77)),
    _case("bank_indivisible_time4", "time4", "bank", axis="time",
          shape=(2, 32), bank=3, reject="ValueError"),
    _case("bank_not_2d_time4", "time4", "bank", axis="time", shape=(2, 32),
          bank=0, reject="ValueError"),
    # channel_to_time / time_to_channel (tests/test_reshard.py)
    _case("reshard_u8_time4", "time4", "reshard", axis="time",
          shape=(8, 64), dtype="uint8"),
    _case("reshard_f32_dt22", "dt22", "reshard", axis="data",
          shape=(8, 64), dtype="float32"),
    _case("reshard_i32_time2", "time2", "reshard", axis="time",
          shape=(16, 32), dtype="int32"),
    _case("reshard_indivisible_time4", "time4", "reshard", axis="time",
          shape=(6, 64), dtype="float32", reject="ValueError"),
    # fir_overlap_save_sharded (tests/test_expert_fft_sharded.py)
    _case("os_jnp_time4", "time4", "overlap_save", backend="jnp",
          taps="uniform63", shape=(3, 4 * 2048)),
    _case("os_jnp_dt22", "dt22", "overlap_save", backend="jnp",
          taps="uniform31", shape=(4, 2 * 1024)),
    _case("os_jnp_identity_nfft64_time4", "time4", "overlap_save",
          backend="jnp", taps="identity9", nfft=64, shape=(2, 4 * 100)),
    _case("os_pallas_dt22", "dt22", "overlap_save", backend="pallas",
          taps="uniform63", shape=(4, 2 * 2048)),
    _case("os_pallas_259tap_time2", "time2", "overlap_save",
          backend="pallas", taps="uniform259", shape=(2, 2 * 2048)),
    _case("os_jnp_two_steps_seeded_time2", "time2", "overlap_save",
          backend="jnp", taps="uniform31", steps=2, seed=1.5,
          shape=(2, 2 * 1024)),
    _case("os_pallas_world1", "world1", "overlap_save", backend="pallas",
          taps="uniform63", shape=(2, 3000)),
    _case("os_unknown_backend_time4", "time4", "overlap_save",
          backend="cuda", taps="uniform31", shape=(2, 400),
          reject="ValueError"),
    _case("os_indivisible_time4", "time4", "overlap_save", backend="jnp",
          taps="uniform31", shape=(2, 101), reject="ValueError"),
    # spmd_pipeline (tests/test_spmd_pipeline.py)
    _case("spmd_float_stage4", "stage4", "spmd", stages="affine",
          shape=(7, 4, 16)),
    _case("spmd_float_stage2", "stage2", "spmd", stages="affine",
          shape=(5, 3, 8)),
    _case("spmd_switch_stage4", "stage4", "spmd", stages="switch",
          shape=(5, 2, 8)),
    _case("spmd_fixed_stage2", "stage2", "spmd", stages="fixed3",
          shape=(6, 3, 32)),
    _case("spmd_fixed_stage4", "stage4", "spmd", stages="fixed5",
          shape=(5, 2, 40)),
    _case("spmd_one_batch_stage4", "stage4", "spmd", stages="plus_one",
          shape=(1, 2, 4)),
    _case("spmd_three_batches_stage4", "stage4", "spmd", stages="plus_one",
          shape=(3, 2, 4)),
    _case("spmd_empty_stage2", "stage2", "spmd", stages="identity",
          shape=(0, 2, 4)),
    # models/chain.py (tests/test_demod_chain.py)
    _case("chain_sharded_dt22", "dt22", "chain", taps=33, shape=(8, 1200)),
    _case("chain_sharded_over_time_axis_time2", "time2", "chain", taps=63,
          axis="time", shape=(4, 900)),
    _case("chain_fused_sharded_dt22", "dt22", "chain", taps=63,
          backend="fused", shape=(16, 2000)),
    _case("chain_indivisible_dt22", "dt22", "chain", taps=63, shape=(3, 600),
          reject="ValueError"),
    _case("chain_time_time2", "time2", "chain_time", shape=(8, 2 * 2304)),
    _case("chain_time_time4", "time4", "chain_time", shape=(8, 4 * 2304)),
    _case("chain_time_channels_dt22", "dt22", "chain_time", axis="data",
          shape=(16, 2 * 1920)),
    _case("chain_time_phase_misaligned_time2", "time2", "chain_time",
          shape=(8, 2 * 12289), reject="ValueError"),
    _case("chain_time_halo_wider_than_shard_time2", "time2", "chain_time",
          shape=(8, 2 * 1152), reject="ValueError"),
]

CASE_NAMES = [case.name for case in CASES]


def case_named(name: str) -> Case:
    return next(case for case in CASES if case.name == name)


def filter_taps(name: str, rng: np.random.Generator) -> np.ndarray:
    """The filter a case names: the banks and shapes of the JAX tests."""
    from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
    from warmup_fir_filter_tpu_torch.ops.fir2d import FILTER_BANK_2D
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    named = {
        "sharpen5": FILTER_BANKS[5]["sharpen"],
        "sharpen3": FILTER_BANKS[3]["sharpen"],
        "edge5": FILTER_BANKS[5]["edge"],
        "moving_avg5": FILTER_BANKS[5]["moving_avg"],
        "even4": [0.25] * 4,
        "one": [1.0],
        "wrap3": [7.5, -8.0, 7.5],
        "identity9": np.eye(1, 9, 4)[0],
        "gauss5": FILTER_BANK_2D["gauss5"],
        "sharpen5_2d": FILTER_BANK_2D["sharpen5"],
    }
    if name in named:
        return np.asarray(named[name], np.float64)
    if name.startswith("lowpass"):
        return design_lowpass(int(name[7:]), 0.4)
    if name.startswith("uniform"):
        taps = int(name[7:])
        return rng.uniform(-0.1, 0.1, taps) if taps <= 31 else \
            rng.uniform(-0.2, 0.2, taps)
    shapes = {"even2x4": (2, 4), "tall9x3": (9, 3), "wide3x9": (3, 9)}
    return rng.uniform(-0.5, 0.5, shapes[name])


def _fm_planes(rng, channels, time, k_f=0.05):
    msg = rng.uniform(-1, 1, size=(channels, time))
    phase = 2 * np.pi * k_f * np.cumsum(msg, axis=-1)
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def make_inputs(case: Case) -> dict[str, np.ndarray]:
    """The case's inputs, from a generator seeded by its name."""
    rng = np.random.default_rng(zlib.crc32(case.name.encode()))
    shape = case.param("shape")
    if case.kind in ("chain", "chain_time"):
        re, im = _fm_planes(rng, *shape)
        return {"re": re, "im": im}
    if case.kind == "spmd":
        if case.param("stages").startswith("fixed"):
            return {"x": rng.integers(0, 256, size=shape, dtype=np.uint8)}
        return {"x": rng.normal(size=shape).astype(np.float32)}
    if case.kind == "reshard":
        dtype = np.dtype(case.param("dtype"))
        if dtype == np.uint8:
            return {"x": rng.integers(0, 256, size=shape, dtype=np.uint8)}
        if dtype == np.int32:
            return {"x": np.arange(np.prod(shape), dtype=np.int32)
                    .reshape(shape)}
        return {"x": rng.normal(size=shape).astype(np.float32)}
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    if case.kind == "bank":
        count = case.param("bank", 4)
        bank = (np.ones(5) if count == 0 else
                rng.uniform(-0.5, 0.5, (count, 5)) + np.eye(count, 5, 2))
        return {"x": x, "h": bank}
    if case.kind in ("halo1d", "halo2d"):
        return {"x": x}
    return {"x": x, "h": filter_taps(case.param("taps"), rng)}


# ---------------------------------------------------------------- the rank


def _stage_fn(kind: str):
    """The port's stage function of a spmd case."""
    import torch

    from warmup_fir_filter_tpu_torch.kernels.dispatch import (
        fir1d_fixed_rows_auto,
    )

    if kind == "affine":
        return lambda s, x: x * 2.0 + float(s)
    if kind == "switch":
        branches = [lambda x: x + 1.0, lambda x: x * 3.0, torch.tanh,
                    lambda x: x - 0.5]
        return lambda s, x: branches[s](x)
    if kind == "plus_one":
        return lambda s, x: x + 1.0
    if kind == "identity":
        return lambda s, x: x
    bank = stage_bank(kind)
    return lambda s, x: fir1d_fixed_rows_auto(x, bank[s])


def stage_bank(kind: str) -> np.ndarray:
    """The filters of a fixed spmd case's stages, one a stage."""
    from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS

    names = (["simple_lp", "moving_avg"] if kind == "fixed3" else
             ["moving_avg", "simple_lp", "edge", "sharpen"])
    return np.asarray([FILTER_BANKS[int(kind[5:])][n] for n in names])


def run_case(case: Case, arrays: dict, mesh) -> dict[str, np.ndarray]:
    """The case through the port's entry; every rank calls it."""
    import dataclasses as dc

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from warmup_fir_filter_tpu_torch.models import chain
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.parallel import (
        channel_to_time,
        exchange_halo_1d,
        exchange_halo_2d,
        filter_bank_fixed_sharded,
        fir1d_fixed_sharded,
        fir2d_fixed_sharded,
        fir_overlap_save_sharded,
        spmd_pipeline,
        time_to_channel,
    )
    from warmup_fir_filter_tpu_torch.parallel.fft_sharded import (
        make_overlap_save_step,
    )
    from warmup_fir_filter_tpu_torch.parallel.mesh import (
        as_dtensor,
        local_block,
    )

    p = case.param
    x = arrays.get("x")
    if case.kind == "fir1d":
        qf = QFormat(acc_bits=p("acc_bits", 32))
        return {"y": fir1d_fixed_sharded(x, arrays["h"], qf, mesh=mesh)}
    if case.kind == "fir2d":
        return {"y": fir2d_fixed_sharded(x, arrays["h"], mesh=mesh)}
    if case.kind == "halo1d":
        spec = ("data", "time")
        left, right = p("widths")
        ext = exchange_halo_1d(local_block(x, mesh, spec), mesh=mesh,
                               axis_name="time", left_width=left,
                               right_width=right)
        return {"ext": as_dtensor(ext, mesh, spec)}
    if case.kind == "halo2d":
        spec = ("data", "time")
        top, bottom, left, right = p("widths")
        ext = exchange_halo_2d(local_block(x, mesh, spec), mesh=mesh,
                               row_axis="data", col_axis="time",
                               top_width=top, bottom_width=bottom,
                               left_width=left, right_width=right)
        return {"ext": as_dtensor(ext, mesh, spec)}
    if case.kind == "bank":
        return {"y": filter_bank_fixed_sharded(x, arrays["h"], mesh=mesh,
                                               expert_axis=p("axis"))}
    if case.kind == "reshard":
        axis = p("axis")
        dim = mesh.mesh_dim_names.index(axis)
        placed = [Replicate()] * mesh.ndim
        flipped = channel_to_time(x, mesh=mesh, axis=axis)
        back = time_to_channel(flipped, mesh=mesh, axis=axis)
        # The layout, against DTensor's own redistribution of the input.
        source = DTensor.from_local(local_block(x, mesh, (axis, None)), mesh,
                                    [*placed[:dim], Shard(0),
                                     *placed[dim + 1:]])
        want_flipped = source.redistribute(
            mesh, [*placed[:dim], Shard(1), *placed[dim + 1:]])
        layout_ok = (
            list(flipped.placements) == list(want_flipped.placements)
            and torch.equal(flipped.to_local(), want_flipped.to_local())
            and list(back.placements) == list(source.placements)
            and torch.equal(back.to_local(), source.to_local()))
        ok = torch.tensor([int(layout_ok)], device=back.device)
        torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
        return {"flipped": flipped, "back": back, "layout_ok": ok}
    if case.kind == "overlap_save":
        h, steps = arrays["h"], p("steps", 1)
        if steps == 1:
            return {"y": fir_overlap_save_sharded(
                x, h, mesh=mesh, nfft=p("nfft"), backend=p("backend"))}
        run = make_overlap_save_step(h, mesh=mesh, backend=p("backend"),
                                     steps=steps)
        return {"y": run(x, seed=p("seed"))}
    if case.kind == "spmd":
        y = spmd_pipeline(_stage_fn(p("stages")), torch.from_numpy(x),
                          mesh=mesh)
        return {"y": y}
    config = chain.ChainConfig()
    if case.kind == "chain":
        config = dc.replace(config, channelizer_taps=p("taps"),
                            channelizer_backend=p("backend", "auto"))
        return {"y": chain.chain_forward_sharded(
            arrays["re"], arrays["im"], config, mesh=mesh,
            channel_axis=p("axis", "data"))}
    return {"y": chain.chain_forward_time_sharded(
        arrays["re"], arrays["im"], config, mesh=mesh,
        channel_axis=p("axis"))}


def _gathered(value) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(value, DTensor):
        value = value.full_tensor()
    return value.cpu().numpy() if hasattr(value, "cpu") else np.asarray(value)


def run_rank(rank: int, world: int, port: str, out_path: str,
             device: str) -> int:
    import torch

    from warmup_fir_filter_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
    )

    torch.set_num_threads(1)
    if not initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                                num_processes=world, process_id=rank,
                                device=device):
        raise RuntimeError("initialize_multihost made no process group")
    meshes = {}
    outputs = {}
    for case in CASES:
        if case.world != world:
            continue
        if case.mesh not in meshes:
            meshes[case.mesh] = make_mesh(MESHES[case.mesh],
                                          device_type=device)
        try:
            result = run_case(case, make_inputs(case), meshes[case.mesh])
        except (ValueError, KeyError, TypeError) as exc:
            if not case.param("reject"):
                raise
            outputs[f"{case.name}/raised"] = np.array(type(exc).__name__)
            outputs[f"{case.name}/message"] = np.array(str(exc))
            continue
        for key, value in result.items():
            outputs[f"{case.name}/{key}"] = _gathered(value)
        print(f"rank {rank}: {case.name} done", flush=True)
    if rank == 0:
        np.savez(out_path, **outputs)
    torch.distributed.destroy_process_group()
    print(f"[OK] rank {rank} of {world}", flush=True)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_world(world: int, out: Path, device: str,
                prefix: str = "") -> list[subprocess.Popen]:
    """The ranks of one world, each running ``prefix`` (code executed
    before the worker, such as an import blocker) and then this module."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO_ROOT)
    code = prefix + (
        "import runpy, sys\n"
        f"sys.argv = [{str(WORKER)!r}] + sys.argv[1:]\n"
        f"runpy.run_path({str(WORKER)!r}, run_name='__main__')\n")
    return [subprocess.Popen(
        [sys.executable, "-c", code, "rank", str(rank), str(world),
         str(port), str(out), device],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def run_worlds(device: str, out_dir: Path, timeout_s: float = 600) -> int:
    """Every world of :data:`CASES` in turn; ``out_dir/out<world>.npz``."""
    if device == "cuda":  # build the kernels once, not in every rank
        from warmup_fir_filter_tpu_torch import _build

        _build.load_library()
    out_dir.mkdir(parents=True, exist_ok=True)
    failed = 0
    for world in sorted({case.world for case in CASES}):
        procs = spawn_world(world, out_dir / f"out{world}.npz", device)
        try:
            logs = [proc.communicate(timeout=timeout_s)[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode:
                failed += 1
                print(f"world {world} rank {rank} rc={proc.returncode}:\n"
                      f"{log}", flush=True)
        print(f"world {world} on {device}: "
              f"{'ok' if not failed else 'FAILED'}", flush=True)
    return 1 if failed else 0


def compare_case(case: Case, want: dict, got: dict) -> dict:
    """One case's outputs from two runs, at the bounds the test file holds
    each to the JAX functions: fixed-point and data movement equal, the
    FFT filter within 2e-2 and > 80 dB, the chains within 1e-5 and > 90 dB
    (> 95 for the fused time-sharded one).  A dB figure needs signal and
    noise; without one the two outputs must be equal."""
    name = case.name
    if case.param("reject"):
        same = str(want[f"{name}/raised"]) == str(got[f"{name}/raised"])
        return {"ok": same, "raised": str(got[f"{name}/raised"])}
    keys = [k for k in want if k.startswith(f"{name}/")]
    result = {"ok": True}
    for key in keys:
        a = want[key].astype(np.float64)
        b = got[key].astype(np.float64)
        if a.shape != b.shape:
            return {"ok": False, "shape": [a.shape, b.shape]}
        err = float(np.abs(a - b).max()) if a.size else 0.0
        noise = float(np.square(a - b).mean()) if a.size else 0.0
        power = float(np.square(a).mean()) if a.size else 0.0
        snr = 10 * np.log10(power / noise) if noise and power else None
        result[key.split("/")[1]] = {"max_abs_diff": err, "snr_db": snr}
        exact = case.kind not in ("overlap_save", "chain", "chain_time") \
            and not (case.kind == "spmd" and case.param("stages") == "switch")
        if exact:
            ok = np.array_equal(want[key], got[key])
        elif case.kind == "spmd":
            ok = np.allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            atol, bound = ((2e-2, 80.0) if case.kind == "overlap_save" else
                           (1e-5, 95.0 if case.kind == "chain_time"
                            else 90.0))
            ok = err <= atol and (np.array_equal(a, b) if snr is None
                                  else snr > bound)
        result["ok"] = result["ok"] and bool(ok)
    return result


def compare_worlds(want_dir: Path, got_dir: Path) -> int:
    loaded = {}
    results = {}
    for case in CASES:
        for d in (want_dir, got_dir):
            key = (d, case.world)
            if key not in loaded:
                loaded[key] = dict(np.load(d / f"out{case.world}.npz"))
        results[case.name] = compare_case(
            case, loaded[(want_dir, case.world)],
            loaded[(got_dir, case.world)])
    bad = [name for name, r in results.items() if not r["ok"]]
    print(json.dumps(results), flush=True)
    print(f"compared {len(results)} cases of {want_dir} and {got_dir}: "
          f"{len(results) - len(bad)} agree, mismatched {bad}", flush=True)
    return 1 if bad else 0


def main(argv: list[str]) -> int:
    if str(REPO_ROOT) not in sys.path:  # run as a script from tests/
        sys.path.insert(0, str(REPO_ROOT))
    mode = argv[1]
    if mode == "rank":
        return run_rank(int(argv[2]), int(argv[3]), argv[4], argv[5],
                        argv[6])
    if mode == "worlds":
        return run_worlds(argv[2], Path(argv[3]))
    if mode == "compare":
        return compare_worlds(Path(argv[2]), Path(argv[3]))
    raise SystemExit(f"unknown mode {mode!r}; expected rank, worlds or "
                     "compare")


if __name__ == "__main__":
    sys.exit(main(sys.argv))
