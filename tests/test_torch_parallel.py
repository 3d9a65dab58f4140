"""The port's multi-device layer (``warmup_fir_filter_tpu_torch/parallel``
and the sharded chains) against the JAX package's.

- **Gloo worlds.**  A module fixture spawns worlds of 1, 2 and 4 ranks of
  ``tests/test_torch_parallel_worker.py`` (JAX and the JAX package
  blocked, as ``tests/test_torch_dispatch.py::BLOCK_JAX`` blocks them),
  each running every case of its world through the port's entries, while
  this process computes the JAX functions' results on the conftest's
  8-device virtual CPU mesh at the same mesh shapes (Pallas in interpret
  mode, as the JAX tests run it) and saves them to an ``.npz``.  One test
  per case compares rank 0's gathered output with them, at the JAX tests'
  bounds: fixed paths ``np.array_equal``; the overlap-save within 2e-2 of
  the unsharded FFT path and > 70 dB from the ideal FIR, ``"pallas"``
  within 5e-2 and > 80 dB of ``"jnp"``; ``chain_forward_sharded`` within
  1e-5 of the port's unsharded chain (equal for ``"fused"``) and > 90 dB
  from the JAX one; ``chain_forward_time_sharded`` equal to the port's
  unsharded ``chain_forward_fused`` and > 95 dB from the JAX one.  A halo wider than its shard raises
  ``ValueError`` in the port where the JAX function raises ``TypeError``.
- **In-process.**  Each shard-local step, with its halos sliced in by hand
  (zero edges at the ends, what the ring delivers), against the JAX
  function; ``PipelinedChain`` on the CPU (results, window bound,
  rejections); ``initialize_multihost``, ``make_mesh`` and
  ``global_mesh_axes`` without a process group.
"""

import dataclasses
import subprocess
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_parallel_worker as worker
from test_torch_dispatch import BLOCK_JAX
from warmup_fir_filter_tpu.kernels import chain_fused as jax_fused
from warmup_fir_filter_tpu.models import chain as jax_chain
from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
from warmup_fir_filter_tpu.ops.fftfilt import fir_overlap_save
from warmup_fir_filter_tpu.ops.fir1d import (
    fixed_fir_prehaloed_i32 as jax_prehaloed,
    pad_rows_same_mode as jax_pad_rows,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat as JaxQFormat
from warmup_fir_filter_tpu.parallel import expert as jax_expert
from warmup_fir_filter_tpu.parallel import fft_sharded as jax_fft_sharded
from warmup_fir_filter_tpu.parallel import halo as jax_halo
from warmup_fir_filter_tpu.parallel import make_mesh as jax_make_mesh
from warmup_fir_filter_tpu.parallel import reshard as jax_reshard
from warmup_fir_filter_tpu.parallel.pipeline_parallel import (
    PipelinedChain as JaxPipelinedChain,
)
from warmup_fir_filter_tpu.parallel.spmd_pipeline import (
    spmd_pipeline as jax_spmd_pipeline,
)
from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
    FusedChain,
    chain_forward_fused,
)
from warmup_fir_filter_tpu_torch.kernels.dispatch import (
    prepare_fixed_fir,
    prepare_fixed_fir2d,
)
from warmup_fir_filter_tpu_torch.models import chain
from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.parallel import (
    PipelinedChain,
    distributed,
    initialize_multihost,
    make_mesh,
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

#: Wall-clock guard of the spawned worlds (``tests/test_multihost.py``).
SPAWN_TIMEOUT_S = 150


# ------------------------------------------------------- JAX references


def _jax_mesh(case):
    return jax_make_mesh(worker.MESHES[case.mesh],
                         devices=jax.devices()[: case.world])


def _raised(fn) -> dict:
    try:
        fn()
    except Exception as exc:  # the JAX function's refusal, by type
        return {"raised": np.array(type(exc).__name__)}
    return {"raised": np.array("")}


def _jax_halo(case, x, mesh):
    spec = P("data", "time")
    if case.kind == "halo1d":
        left, right = case.param("widths")
        body = partial(jax_halo.exchange_halo_1d, axis_name="time",
                       left_width=left, right_width=right)
    else:
        top, bottom, left, right = case.param("widths")
        body = partial(jax_halo.exchange_halo_2d, row_axis="data",
                       col_axis="time", top_width=top, bottom_width=bottom,
                       left_width=left, right_width=right)
    run = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
    return np.asarray(jax.jit(run)(x))


def _jax_stage_fn(kind: str):
    if kind == "affine":
        return lambda s, x: x * 2.0 + s.astype(jnp.float32)
    if kind == "switch":
        branches = [lambda x: x + 1.0, lambda x: x * 3.0, jnp.tanh,
                    lambda x: x - 0.5]
        return lambda s, x: jax.lax.switch(s, branches, x)
    if kind == "plus_one":
        return lambda s, x: x + 1.0
    if kind == "identity":
        return lambda s, x: x
    qf = JaxQFormat()
    bank = jnp.asarray(np.stack([qf.quantize_coeffs(h).astype(np.int32)
                                 for h in worker.stage_bank(kind)]))
    taps = bank.shape[1]

    def stage(s, x_u8):
        xp = jax_pad_rows(x_u8.astype(jnp.int32), taps)
        return jax_prehaloed(xp, bank[s], taps, qf.frac_bits, qf.acc_bits)

    return stage


def _jax_fused(re, im, precision: str = "bf16x3"):
    """The JAX fused chain in interpret mode; the smallest superblock keeps
    it quick."""
    cfg = jax_chain.ChainConfig()
    return np.asarray(jax_fused.chain_forward_fused(
        re, im, cfg.resample_filter(), cfg.channelizer_filter(),
        cfg.resample_up, cfg.resample_down, cfg.demod_k_f,
        precision=precision, seg_tiles=8, interpret=True))


def _chain_config(case):
    cfg = dataclasses.replace(
        jax_chain.ChainConfig(), channelizer_taps=case.param("taps", 63),
        channelizer_backend=case.param("backend", "auto"))
    return cfg


def jax_reference(case, arrays: dict) -> dict:
    """The JAX function's result (or refusal) for a case."""
    mesh = _jax_mesh(case)
    p, x = case.param, arrays.get("x")
    if case.kind == "fir1d":
        qf = JaxQFormat(acc_bits=p("acc_bits", 32))
        run = partial(jax_halo.fir1d_fixed_sharded, x, arrays["h"], qf,
                      mesh=mesh)
    elif case.kind == "fir2d":
        run = partial(jax_halo.fir2d_fixed_sharded, x, arrays["h"],
                      mesh=mesh)
    elif case.kind == "bank":
        run = partial(jax_expert.filter_bank_fixed_sharded, x, arrays["h"],
                      mesh=mesh, expert_axis=p("axis"))
    elif case.kind in ("halo1d", "halo2d"):
        return {"ext": _jax_halo(case, x, mesh)}
    elif case.kind == "reshard":
        if p("reject"):
            return _raised(lambda: jax_reshard.channel_to_time(
                x, mesh=mesh, axis=p("axis")))
        flipped = jax_reshard.channel_to_time(x, mesh=mesh, axis=p("axis"))
        back = jax_reshard.time_to_channel(flipped, mesh=mesh,
                                           axis=p("axis"))
        return {"flipped": np.asarray(flipped), "back": np.asarray(back)}
    elif case.kind == "overlap_save":
        h = arrays["h"]
        if p("reject"):
            return _raised(lambda: jax_fft_sharded.fir_overlap_save_sharded(
                x, h, mesh=mesh, backend=p("backend")))
        run_jnp = jax_fft_sharded.make_overlap_save_step(
            h, mesh=mesh, nfft=p("nfft"), steps=p("steps", 1))
        x_sharded = jax.device_put(
            jnp.asarray(x, jnp.float32),
            NamedSharding(mesh, P("data", "time")))
        single = np.asarray(jnp.asarray(x, jnp.float32) + np.float32(
            p("seed", 0.0)))
        for _ in range(p("steps", 1)):
            single = np.asarray(fir_overlap_save(single, h))
        return {"sharded_jnp": np.asarray(run_jnp(x_sharded,
                                                  p("seed", 0.0))),
                "single": single,
                "ideal": fir1d_ideal_golden_rows(x, h)}
    elif case.kind == "spmd":
        out = jax_spmd_pipeline(_jax_stage_fn(p("stages")), x, mesh=mesh)
        return {"y": np.asarray(out)}
    elif case.kind == "chain":
        cfg = _chain_config(case)
        re, im = arrays["re"], arrays["im"]
        axis = p("axis", "data")
        if p("reject"):
            return _raised(lambda: jax_chain.chain_forward_sharded(
                re, im, cfg, mesh=mesh, channel_axis=axis))
        if p("backend") == "fused":
            # The JAX sharded run equals its unsharded one
            # (tests/test_demod_chain.py).
            y = _jax_fused(re, im, precision="highest")
        else:
            y = jax_chain.chain_forward_sharded(re, im, cfg, mesh=mesh,
                                                channel_axis=axis)
        return {"y": np.asarray(y)}
    else:  # chain_time
        re, im = arrays["re"], arrays["im"]
        if p("reject"):
            return _raised(lambda: jax_chain.chain_forward_time_sharded(
                re, im, jax_chain.ChainConfig(), mesh=mesh))
        # The JAX time-sharded chain is bit-equal to its unsharded fused
        # chain at the config's precision (tests/test_demod_chain.py).
        return {"y": _jax_fused(re, im)}
    if p("reject"):
        return _raised(run)
    return {"y": np.asarray(run())}


# ---------------------------------------------------------- the worlds


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    """Spawn the worlds, compute the JAX references meanwhile, and collect
    both: ``(outputs by world, failures by world, references)``."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = {case.name: worker.make_inputs(case) for case in worker.CASES}
    worlds = sorted({case.world for case in worker.CASES})
    start = time.monotonic()
    procs = {world: worker.spawn_world(world, tmp / f"out{world}.npz", "cpu",
                                       prefix=BLOCK_JAX)
             for world in worlds}
    try:
        refs = {}
        for case in worker.CASES:
            for key, value in jax_reference(case, inputs[case.name]).items():
                refs[f"{case.name}/{key}"] = value
        np.savez(tmp / "references.npz", **refs)
        failures = {}
        for world, ranks in procs.items():
            logs = []
            for rank, proc in enumerate(ranks):
                left = SPAWN_TIMEOUT_S - (time.monotonic() - start)
                out, _ = proc.communicate(timeout=max(left, 1))
                if proc.returncode != 0:
                    logs.append(f"rank {rank} rc={proc.returncode}:\n{out}")
            if logs:
                failures[world] = "\n---\n".join(logs)
    except subprocess.TimeoutExpired:
        failures = {world: "the gloo workers timed out"
                    for world in worlds}
    finally:
        for ranks in procs.values():
            for proc in ranks:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    outputs = {world: dict(np.load(tmp / f"out{world}.npz"))
               for world in worlds if world not in failures}
    return outputs, failures, dict(np.load(tmp / "references.npz")), inputs


def _fixed_equal(got, ref, name):
    np.testing.assert_array_equal(got[f"{name}/y"], ref[f"{name}/y"])


def _port_chain(case, arrays):
    cfg = dataclasses.replace(
        chain.ChainConfig(), channelizer_taps=case.param("taps", 63),
        channelizer_backend=case.param("backend", "auto"))
    return chain.chain_forward(torch.from_numpy(arrays["re"]),
                               torch.from_numpy(arrays["im"]), cfg).numpy()


def _port_fused(arrays):
    cfg = chain.ChainConfig()
    return chain_forward_fused(
        torch.from_numpy(arrays["re"]), torch.from_numpy(arrays["im"]),
        cfg.resample_filter(), cfg.channelizer_filter(), cfg.resample_up,
        cfg.resample_down, cfg.demod_k_f).numpy()


@pytest.mark.parametrize("name", worker.CASE_NAMES)
def test_sharded_entry_matches_jax(parallel_run, name):
    outputs, failures, ref, inputs = parallel_run
    case = worker.case_named(name)
    assert case.world not in failures, failures.get(case.world)
    got = outputs[case.world]
    p = case.param
    if p("reject"):
        assert str(got.get(f"{name}/raised")) == p("reject"), (
            f"the port did not refuse: {sorted(got)}")
        # The JAX function refuses too; a halo wider than its shard fails
        # there with a TypeError from its clamped slice.
        want = ("TypeError" if "halo_wider" in name and case.kind in (
            "fir1d", "fir2d") else "ValueError")
        assert str(ref[f"{name}/raised"]) == want
        return
    if case.kind in ("fir1d", "fir2d", "bank"):
        _fixed_equal(got, ref, name)
    elif case.kind in ("halo1d", "halo2d"):
        np.testing.assert_array_equal(got[f"{name}/ext"], ref[f"{name}/ext"])
    elif case.kind == "reshard":
        x = inputs[name]["x"]
        for key in ("flipped", "back"):
            np.testing.assert_array_equal(got[f"{name}/{key}"], x)
            np.testing.assert_array_equal(got[f"{name}/{key}"],
                                          ref[f"{name}/{key}"])
        assert int(got[f"{name}/layout_ok"][0]) == 1
    elif case.kind == "overlap_save":
        y = got[f"{name}/y"].astype(np.float64)
        if p("taps") == "identity9":
            np.testing.assert_allclose(y, inputs[name]["x"], atol=1e-3)
        if p("backend") == "pallas":
            want = ref[f"{name}/sharded_jnp"].astype(np.float64)
            np.testing.assert_allclose(y, want, atol=5e-2)
            assert snr_db(want, y) > 80.0
        else:
            np.testing.assert_allclose(y, ref[f"{name}/single"], atol=2e-2)
            np.testing.assert_allclose(y, ref[f"{name}/sharded_jnp"],
                                       atol=2e-2)
        if p("steps", 1) == 1:
            assert snr_db(ref[f"{name}/ideal"], y) > 70.0
    elif case.kind == "spmd":
        y, want = got[f"{name}/y"], ref[f"{name}/y"]
        assert y.shape == want.shape == tuple(p("shape"))
        if p("stages").startswith("fixed"):
            np.testing.assert_array_equal(y, want)
        else:
            np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)
    elif case.kind == "chain":
        y = got[f"{name}/y"]
        single = _port_chain(case, inputs[name])
        if p("backend") == "fused":
            np.testing.assert_array_equal(y, single)
            assert snr_db(ref[f"{name}/y"].astype(np.float64), y) > 95.0
        else:
            np.testing.assert_allclose(y, single, atol=1e-5)
            assert snr_db(ref[f"{name}/y"].astype(np.float64), y) > 90.0
    else:
        y = got[f"{name}/y"]
        np.testing.assert_array_equal(y, _port_fused(inputs[name]))
        assert snr_db(ref[f"{name}/y"].astype(np.float64), y) > 95.0


# ------------------------------------------------------ shard-local steps


def _shard_blocks(x, shards: int, left: int, right: int, dim: int = -1):
    """Each time shard's extended block, sliced from the global array with
    zero edges at the stream's ends: what the halo ring delivers."""
    width = x.shape[dim] // shards
    pad = [(0, 0)] * x.ndim
    pad[dim] = (left, right)
    xp = np.pad(x, pad)
    return [np.take(xp, np.arange(i * width, (i + 1) * width + left + right),
                    axis=dim) for i in range(shards)]


@pytest.mark.parametrize("taps", ["one", "even4", "sharpen5", "lowpass9",
                                  "lowpass300"])
def test_fir1d_step_over_sliced_halos_matches_jax(rng, require_devices, taps):
    h = worker.filter_taps(taps, rng)
    shards, qf = 4, QFormat(acc_bits=20)
    x = rng.integers(0, 256, size=(3, shards * max(h.size, 24)),
                     dtype=np.uint8)
    left, right = h.size - 1 - h.size // 2, h.size // 2
    fir = prepare_fixed_fir(h, qf, "cpu")
    got = np.concatenate([
        _fir1d_local(torch.from_numpy(block), fir, left, right).numpy()
        for block in _shard_blocks(x, shards, left, right)], axis=1)
    mesh = jax_make_mesh({"data": 1, "time": shards},
                         devices=require_devices(shards))
    want = np.asarray(jax_halo.fir1d_fixed_sharded(
        x, h, JaxQFormat(acc_bits=20), mesh=mesh))
    np.testing.assert_array_equal(got, want)
    # The interior step: the block's own same-mode output, exact where
    # no neighbour sample is needed.
    inner = _fir1d_local(torch.from_numpy(x), fir, 0, 0).numpy()
    np.testing.assert_array_equal(inner[:, left : x.shape[1] - right],
                                  want[:, left : x.shape[1] - right])


@pytest.mark.parametrize("taps", ["gauss5", "even2x4", "tall9x3"])
def test_fir2d_step_over_sliced_halos_matches_jax(rng, require_devices, taps):
    h = worker.filter_taps(taps, rng)
    top, bottom, left, right = margins = _margins_2d(*h.shape)
    x = rng.integers(0, 256, size=(2 * 12, 2 * 20), dtype=np.uint8)
    rows = _shard_blocks(x, 2, top, bottom, dim=0)
    fir = prepare_fixed_fir2d(h, QFormat(), "cpu")
    got = np.concatenate([
        np.concatenate([
            _fir2d_local(torch.from_numpy(block), fir, margins).numpy()
            for block in _shard_blocks(row_block, 2, left, right)], axis=1)
        for row_block in rows], axis=0)
    mesh = jax_make_mesh({"data": 2, "time": 2}, devices=require_devices(4))
    np.testing.assert_array_equal(
        got, np.asarray(jax_halo.fir2d_fixed_sharded(x, h, mesh=mesh)))


@pytest.mark.parametrize("backend,taps", [("jnp", 63), ("pallas", 63),
                                          ("pallas", 259)])
def test_overlap_save_step_over_sliced_halos(rng, require_devices, backend,
                                             taps):
    """Kernel M's route (``off = L-1-c``), kernel L's past 257 taps and
    ``torch.fft``'s, each over four shards' extended blocks."""
    h = rng.uniform(-0.2, 0.2, taps)
    shards = 4
    x = rng.integers(0, 256, size=(2, shards * 1500), dtype=np.uint8)
    plan = LocalOverlapSave.prepare(h, None, backend, torch.device("cpu"))
    assert plan.stream == (backend == "pallas" and taps <= 257)
    left, right = taps - 1 - taps // 2, taps // 2
    got = np.concatenate([
        _overlap_save_local(torch.from_numpy(b.astype(np.float32)), plan,
                            x.shape[1] // shards).numpy()
        for b in _shard_blocks(x, shards, left, right)], axis=1)
    mesh = jax_make_mesh({"data": 1, "time": shards},
                         devices=require_devices(shards))
    want = np.asarray(jax_fft_sharded.fir_overlap_save_sharded(
        x, h, mesh=mesh), np.float64)
    np.testing.assert_allclose(got, want, atol=2e-2 if backend == "jnp"
                               else 5e-2)
    assert snr_db(want, got) > 80.0
    assert snr_db(fir1d_ideal_golden_rows(x, h), got) > 70.0


def test_chain_time_step_over_sliced_halos_is_bit_equal(rng):
    """Four time shards of the fused chain's step, each extended by H_in
    and windowed by its global resampled bounds, equal the unsharded
    fused chain bit for bit, and the JAX fused chain within 95 dB."""
    cfg = chain.ChainConfig()
    shards, t_local, halo_mult = 4, 1920, 4
    re, im = worker._fm_planes(rng, 8, shards * t_local)
    up, down = cfg.resample_up, cfg.resample_down
    h_in, h_out = 128 * down * halo_mult, 128 * up * halo_mult
    out_local = t_local * up // down
    fused = FusedChain(cfg.resample_filter(), cfg.channelizer_filter(), up,
                       down, cfg.demod_k_f)
    parts = []
    for s, (re_b, im_b) in enumerate(zip(
            _shard_blocks(re, shards, h_in, h_in),
            _shard_blocks(im, shards, h_in, h_in))):
        bounds = (h_out - s * out_local,
                  h_out + out_local * (shards - s))
        parts.append(chain._chain_time_local(
            torch.from_numpy(re_b), torch.from_numpy(im_b), fused, bounds,
            h_out, out_local, first=s == 0).numpy())
    y = np.concatenate(parts, axis=1)
    np.testing.assert_array_equal(y, _port_fused({"re": re, "im": im}))
    assert snr_db(_jax_fused(re, im).astype(np.float64), y) > 95.0


# ---------------------------------------------------- PipelinedChain


def test_pipelined_chain_matches_sequential_and_jax(rng):
    stages = [lambda x: x * 2.0, torch.tanh, lambda x: x.sum(dim=-1)]
    jax_stages = [lambda x: x * 2.0, jnp.tanh, lambda x: x.sum(axis=-1)]
    batches = [rng.normal(size=(4, 16)).astype(np.float32) for _ in range(5)]
    pipe = PipelinedChain(stages, devices=["cpu"])
    out = pipe.run_microbatches(batches)
    seq = pipe.run_microbatches(batches, force_sequential=True)
    want = JaxPipelinedChain(jax_stages, devices=jax.devices()[:3]
                             ).run_microbatches(batches)
    for got, again, ref, batch in zip(out, seq, want, batches):
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got.numpy(),
                                   np.tanh(batch * 2.0).sum(axis=-1),
                                   rtol=1e-4, atol=1e-4)


def test_pipelined_chain_placements_cycle_the_devices():
    pipe = PipelinedChain([lambda x: x] * 3, devices=["cpu", "meta"])
    assert pipe.placements == [torch.device("cpu"), torch.device("meta"),
                               torch.device("cpu")]
    single = PipelinedChain([lambda x: x + 1], devices=["cpu"])
    out = single.run_microbatches([np.zeros((2, 2), np.float32)])
    np.testing.assert_array_equal(out[0].numpy(), np.ones((2, 2)))


class _Logged:
    """A last-stage output that logs its retirement (``.cpu()``)."""

    def __init__(self, log):
        self.log = log

    def cpu(self):
        self.log.append(-1)
        return self


@pytest.mark.parametrize("num_stages", [2, 3])
def test_pipelined_chain_in_flight_window_bounds_and_matches(rng,
                                                             num_stages):
    """At most ``max_in_flight`` microbatches sit between admission and
    retirement, or the pipeline's depth less one where the window is
    smaller (the executor then waits on the oldest activation)."""
    batches = [rng.normal(size=(3, 8)).astype(np.float32) for _ in range(7)]
    middle = [lambda x: x + 1.0] * (num_stages - 2)
    for window in (1, 2, 5):
        stages = [lambda x: x * 2.0, *middle, lambda x: x + 1.0]
        out = PipelinedChain(stages, devices=["cpu"]).run_microbatches(
            batches, max_in_flight=window)
        for got, batch in zip(out, batches):
            np.testing.assert_allclose(got.numpy(),
                                       batch * 2.0 + (num_stages - 1),
                                       rtol=1e-6)
        log = []  # +1 at each admission, -1 at each retirement

        def admit(x):
            log.append(1)
            return x

        tracked = [admit, *middle, lambda x: _Logged(log)]
        PipelinedChain(tracked, devices=["cpu"]).run_microbatches(
            batches, max_in_flight=window)
        peak = max(np.cumsum(log))
        assert log.count(1) == log.count(-1) == len(batches)
        assert peak <= max(window, num_stages - 1)
        if window >= num_stages - 1:
            assert peak == min(window, len(batches))


def test_pipelined_chain_rejections():
    with pytest.raises(ValueError, match="stages"):
        PipelinedChain([])
    with pytest.raises(ValueError, match="no devices"):
        PipelinedChain([lambda x: x], devices=[])
    pipe = PipelinedChain([lambda x: x], devices=["cpu"])
    with pytest.raises(ValueError, match="max_in_flight"):
        pipe.run_microbatches([np.zeros(2)], max_in_flight=0)
    # The default devices are the cards: without CUDA it raises and runs
    # nothing on the host.
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PipelinedChain([lambda x: x])


# ------------------------------------------- process group and meshes


def test_initialize_multihost_single_process_is_a_no_op(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                 "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("initialized a group"))
    assert initialize_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost(device="cuda") is False


def test_initialize_multihost_reads_the_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29512")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert initialize_multihost(device="cpu") is True
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert initialize_multihost("10.0.0.1:1234", device="cpu") is True
    assert calls == [
        (("gloo",), {"init_method": "tcp://127.0.0.1:29512",
                     "world_size": 4, "rank": 3}),
        (("gloo",), {"init_method": "tcp://10.0.0.1:1234", "world_size": 2,
                     "rank": 1}),
    ]


def test_initialize_multihost_never_falls_back(monkeypatch):
    for name in ("JAX_PROCESS_ID", "RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("initialized a group"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        initialize_multihost("127.0.0.1:1", 2, 0, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        initialize_multihost("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="device"):
        initialize_multihost("127.0.0.1:1", 2, 0, device="tpu")
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost("127.0.0.1:1", 2, device="cpu")


def test_make_mesh_needs_a_process_group_and_global_axes():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh({"data": 1, "time": 1}, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(device_type="tpu")
    assert distributed.global_mesh_axes() == {"data": 1, "time": 1}
    with pytest.raises(ValueError, match="must divide device count 1"):
        distributed.global_mesh_axes(2)
