"""The port's checkpointable streaming against the JAX package's.

Every case of ``tests/test_streaming.py`` that does not test an item the
port leaves out (the row-split step and ``auto_rows_split``: a split runs
the default step, as the JAX function does off its accelerator), run through
``warmup_fir_filter_tpu_torch.ops.streaming``; checkpoints saved by either
package and resumed by the other; ``stream_scanned`` of both packages on
the same data (the unsplit step, the windowed step of kernels D and A in
their plain versions, and a 300-tap filter); and the checksums mod 2^32 at
a size where unmasked int64 sums would overflow.

Tolerance: every comparison is ``np.array_equal`` (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops import streaming as jax_streaming
from warmup_fir_filter_tpu_torch.kernels import fir_band, window_copy
from warmup_fir_filter_tpu_torch.kernels.dispatch import prepare_fixed_fir
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.streaming import (
    Fir1DStream,
    FirStreamState,
    _emit_windowed_checksums,
    _stream_step,
    _stream_step_mxu,
    _stream_step_windowed,
    default_emit_checksums,
    host_emit_checksums,
    pick_window_split,
    stream_scanned,
)


def _stream_all(stream, x, block):
    chunks = [
        stream.process(x[:, i : i + block])
        for i in range(0, x.shape[1], block)
    ]
    chunks.append(stream.flush())
    return np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("block", [1, 7, 32, 100])
@pytest.mark.parametrize("tap", [3, 5])
def test_streaming_equals_offline(rng, tap, block):
    h = np.asarray(FILTER_BANKS[tap]["sharpen"])
    x = rng.integers(0, 256, size=(3, 100), dtype=np.uint8)
    stream = Fir1DStream(h, channels=3, device="cpu")
    emitted = _stream_all(stream, x, block)
    offline = fir1d_fixed_golden_rows(x, h)
    center = tap // 2
    # Emitted stream is the offline output delayed by `center` samples.
    np.testing.assert_array_equal(emitted[:, center:center + 100], offline)


def test_checkpoint_resume_bit_exact(rng, tmp_path):
    h = np.asarray(FILTER_BANKS[5]["edge"])
    x = rng.integers(0, 256, size=(2, 240), dtype=np.uint8)

    s1 = Fir1DStream(h, channels=2, device="cpu")
    full = np.concatenate(
        [s1.process(x[:, :120]), s1.process(x[:, 120:]), s1.flush()], axis=1
    )

    s2 = Fir1DStream(h, channels=2, device="cpu")
    part1 = s2.process(x[:, :120])
    s2.state.save(tmp_path / "ckpt.npz")

    s3 = Fir1DStream(h, channels=2, device="cpu")
    s3.state = FirStreamState.load(tmp_path / "ckpt.npz")
    part2 = np.concatenate([s3.process(x[:, 120:]), s3.flush()], axis=1)

    np.testing.assert_array_equal(np.concatenate([part1, part2], 1), full)
    assert s3.state.samples_seen == 240 + 2  # +flush zeros


def test_reset_zeroes_delay_line(rng):
    h = np.asarray(FILTER_BANKS[3]["moving_avg"])
    x = rng.integers(0, 256, size=(1, 50), dtype=np.uint8)
    stream = Fir1DStream(h, channels=1, device="cpu")
    first = stream.process(x)
    stream.reset()
    second = stream.process(x)
    np.testing.assert_array_equal(first, second)


def test_single_tap_stream(rng):
    x = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
    stream = Fir1DStream([1.0], channels=2, device="cpu")
    np.testing.assert_array_equal(stream.process(x), x)
    assert stream.flush().shape == (2, 0)


def test_custom_qformat_stream(rng):
    qf = QFormat(acc_bits=16, frac_bits=8)
    h = np.array([7.5, -8.0, 7.5])
    x = rng.integers(0, 256, size=(2, 64), dtype=np.uint8)
    stream = Fir1DStream(h, channels=2, qformat=qf, device="cpu")
    emitted = _stream_all(stream, x, 16)
    offline = fir1d_fixed_golden_rows(x, h, qf)
    np.testing.assert_array_equal(emitted[:, 1:65], offline)


def test_wrong_channel_count_rejected():
    stream = Fir1DStream([0.5], channels=2, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        stream.process(np.zeros((3, 8), np.uint8))


def test_wide_accumulator_and_missing_cuda_rejected(monkeypatch):
    with pytest.raises(ValueError, match="acc_bits=40"):
        Fir1DStream([0.5], channels=1, qformat=QFormat(acc_bits=40),
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Fir1DStream([0.5], channels=1, device="cuda")


def test_default_device_is_the_card(monkeypatch):
    """With no ``device`` the stream runs on the card, as the JAX stream
    runs on its accelerator: without CUDA it raises and names
    ``device="cpu"``; nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Fir1DStream(np.ones(5) / 5, 2)
    assert Fir1DStream(np.ones(5) / 5, 2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("tap", [1, 5, 300])
def test_process_matches_jax_process(rng, tap):
    """The same blocks through both packages' ``process``: outputs and
    state equal after every block (at 300 taps both blocks are shorter
    than the delay line)."""
    h = rng.uniform(-0.2, 0.2, size=tap) if tap > 5 else \
        np.asarray(FILTER_BANKS[5]["sharpen"])[:tap]
    port = Fir1DStream(h, 3, device="cpu")
    ref = jax_streaming.Fir1DStream(h, 3)
    for width in (250, 1):
        x = rng.integers(0, 256, size=(3, width), dtype=np.uint8)
        np.testing.assert_array_equal(port.process(x), ref.process(x))
        np.testing.assert_array_equal(port.state.carry, ref.state.carry)
        assert port.state.samples_seen == ref.state.samples_seen
    np.testing.assert_array_equal(port.flush(), ref.flush())


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoints_resume_across_packages(rng, tmp_path, saver):
    """One package saves mid-stream, the other loads into a fresh stream
    and continues; the outputs and final state equal an uninterrupted
    run's."""
    h = np.asarray(FILTER_BANKS[5]["edge"])
    x = rng.integers(0, 256, size=(4, 300), dtype=np.uint8)
    whole = jax_streaming.Fir1DStream(h, 4)
    want = np.concatenate([whole.process(x[:, :130]), whole.process(x[:, 130:]),
                           whole.flush()], axis=1)

    if saver == "jax":
        a = jax_streaming.Fir1DStream(h, 4)
        b = Fir1DStream(h, 4, device="cpu")
        b_state_cls = FirStreamState
    else:
        a = Fir1DStream(h, 4, device="cpu")
        b = jax_streaming.Fir1DStream(h, 4)
        b_state_cls = jax_streaming.FirStreamState
    part1 = a.process(x[:, :130])
    a.state.save(tmp_path / "ckpt.npz")
    b.state = b_state_cls.load(tmp_path / "ckpt.npz")
    assert b.state.carry.dtype == np.int32
    part2 = np.concatenate([b.process(x[:, 130:]), b.flush()], axis=1)
    np.testing.assert_array_equal(np.concatenate([part1, part2], axis=1), want)
    np.testing.assert_array_equal(b.state.carry, whole.state.carry)
    assert b.state.samples_seen == whole.state.samples_seen == 302


def _hash_blocks(channels, width):
    """The hash generator of ``test_streaming.py:98-111`` in numpy and JAX."""
    def numpy_block(b):
        col = np.arange(width, dtype=np.uint32)[None, :]
        row = np.arange(channels, dtype=np.uint32)[:, None]
        with np.errstate(over="ignore"):
            v = (col * np.uint32(747796405) + row * np.uint32(2891336453)
                 + np.uint32(b) * np.uint32(2654435761))
            v = (v ^ (v >> np.uint32(13))) * np.uint32(1274126177)
        return ((v >> np.uint32(8)) & np.uint32(255)).astype(np.uint8)

    def jax_block(b):
        base = b.astype(jnp.uint32) * jnp.uint32(2654435761)
        col = jax.lax.broadcasted_iota(jnp.uint32, (channels, width), 1)
        row = jax.lax.broadcasted_iota(jnp.uint32, (channels, width), 0)
        v = (col * jnp.uint32(747796405)
             + row * jnp.uint32(2891336453) + base)
        v = (v ^ (v >> 13)) * jnp.uint32(1274126177)
        return ((v >> 8) & jnp.uint32(255)).astype(jnp.uint8)

    return (lambda b: torch.from_numpy(numpy_block(b))), jax_block


def test_scan_matches_blockwise_process():
    h = np.array([0.25, 1.0, -0.5, 0.125, 0.0625])
    channels, width, blocks = 4, 96, 5
    block_fn, _ = _hash_blocks(channels, width)

    scanned = Fir1DStream(h, channels, device="cpu")
    sums = stream_scanned(scanned, block_fn, blocks)
    assert sums.shape == (blocks, 3) and sums.dtype == np.uint32

    manual = Fir1DStream(h, channels, device="cpu")
    for b in range(blocks):
        y = manual.process(block_fn(b).numpy())
        np.testing.assert_array_equal(sums[b].astype(np.uint64),
                                      host_emit_checksums(y))
    np.testing.assert_array_equal(manual.state.carry, scanned.state.carry)
    assert manual.state.samples_seen == scanned.state.samples_seen


def test_scan_resume_from_checkpoint(tmp_path):
    h = np.array([0.5, 1.0, 0.5])
    channels, width, blocks = 2, 64, 6
    block_fn, _ = _hash_blocks(channels, width)

    full = Fir1DStream(h, channels, device="cpu")
    sums_full = stream_scanned(full, block_fn, blocks)

    a = Fir1DStream(h, channels, device="cpu")
    sums_a = stream_scanned(a, block_fn, 3)
    a.state.save(tmp_path / "ck.npz")
    b = Fir1DStream(h, channels, device="cpu")
    b.state = FirStreamState.load(tmp_path / "ck.npz")
    sums_b = stream_scanned(b, block_fn, 3, start_block=3)
    np.testing.assert_array_equal(np.concatenate([sums_a, sums_b]), sums_full)
    np.testing.assert_array_equal(b.state.carry, full.state.carry)


def test_scan_matches_jax_scan_on_hash_blocks():
    """Both packages' own generator and scan: equal checksums and state."""
    h = np.array([0.25, 1.0, -0.5, 0.125, 0.0625])
    port_fn, jax_fn = _hash_blocks(4, 96)
    port = Fir1DStream(h, 4, device="cpu")
    ref = jax_streaming.Fir1DStream(h, 4)
    got = stream_scanned(port, port_fn, 5, start_block=2)
    want = np.asarray(jax_streaming.stream_scanned(ref, jax_fn, 5,
                                                   start_block=2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.state.carry, ref.state.carry)
    assert port.state.samples_seen == ref.state.samples_seen


def _both_scans(h, data, **kwargs):
    """``stream_scanned`` of the port and of the JAX package over the same
    device-resident blocks."""
    blocks, channels, _ = data.shape
    dev = jnp.asarray(data)
    port = Fir1DStream(h, channels, device="cpu")
    ref = jax_streaming.Fir1DStream(h, channels)
    got = stream_scanned(port, lambda b: torch.from_numpy(data[b]), blocks,
                         **kwargs)
    want = np.asarray(jax_streaming.stream_scanned(
        ref, lambda b: jax.lax.dynamic_index_in_dim(dev, b, keepdims=False),
        blocks, **kwargs))
    return got, want, port.state, ref.state


@pytest.mark.parametrize("rows_split", [None, "pallas", "auto", 1, 2, 4])
def test_scan_matches_jax_5tap(rng, rows_split):
    """The unsplit step and the windowed step (kernel D then kernel A, in
    their plain versions on the CPU) at the JAX test's (4, 16384); every
    row split the JAX function takes gives its checksums and carry."""
    h = np.asarray(FILTER_BANKS[5]["sharpen"])
    data = rng.integers(0, 256, size=(3, 4, 16_384), dtype=np.uint8)
    got, want, port_state, ref_state = _both_scans(h, data,
                                                   rows_split=rows_split)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_state.carry, ref_state.carry)
    assert port_state.samples_seen == ref_state.samples_seen


def test_scan_matches_jax_300tap(rng):
    h = np.hamming(300) / 40.0
    data = rng.integers(0, 256, size=(3, 2, 512), dtype=np.uint8)
    got, want, port_state, ref_state = _both_scans(h, data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_state.carry, ref_state.carry)


@pytest.mark.parametrize("tap", [1, 5, 300, 4097])
def test_kernel_step_bit_equal(rng, tap):
    """The CUDA scan's unsplit step (the prepared filter of each tap range
    over ``carry ‖ x``, then the slice) equals the plain step, with the
    carry flowing across blocks, one of them shorter than the delay line."""
    qf = QFormat()
    h = np.asarray(FILTER_BANKS[5]["sharpen"])[:tap] if tap <= 5 else \
        rng.uniform(-0.01, 0.01, size=tap)
    fir = prepare_fixed_fir(h, qf, "cpu")
    h_fixed = [int(v) for v in qf.quantize_coeffs(h)]
    carry = torch.from_numpy(
        rng.integers(0, 256, size=(3, tap - 1)).astype(np.int32))
    for width in (64, 7, 300):
        x = torch.from_numpy(rng.integers(0, 256, size=(3, width),
                                          dtype=np.uint8))
        y_ref, carry_ref = _stream_step(x.to(torch.int32), carry, h_fixed,
                                        tap, qf.frac_bits, qf.acc_bits)
        y, new_carry = _stream_step_mxu(x, carry, fir, tap)
        assert torch.equal(y, y_ref) and torch.equal(new_carry, carry_ref)
        assert new_carry.dtype == torch.int32
        carry = carry_ref


@pytest.mark.parametrize("tap", [1, 4, 129])
def test_windowed_step_checksums_equal_plain_step(rng, tap):
    """One windowed step (kernel D's and kernel A's plain versions) against
    the plain step: equal checksums and carry, including L = 1 and the
    full 128-column carry tile of L = 129."""
    qf = QFormat()
    h = rng.uniform(-0.05, 0.05, size=tap)
    channels, width = 2, 4096
    sub, g = pick_window_split(channels, width, tap) or (512, 8)
    carry = torch.from_numpy(
        rng.integers(0, 256, size=(channels, tap - 1)).astype(np.int32))
    x = torch.from_numpy(rng.integers(0, 256, size=(channels, width),
                                      dtype=np.uint8))
    y_ref, carry_ref = _stream_step(x.to(torch.int32), carry,
                                    [int(v) for v in qf.quantize_coeffs(h)],
                                    tap, qf.frac_bits, qf.acc_bits)
    y_win, new_carry = _stream_step_windowed(
        x, carry, prepare_fixed_fir(h, qf, "cpu"), tap, sub, g)
    np.testing.assert_array_equal(
        _emit_windowed_checksums(y_win, channels, sub, tap).numpy(),
        default_emit_checksums(y_ref).numpy())
    assert torch.equal(new_carry, carry_ref)


def test_windowed_scan_checksum_equal(rng):
    """The windowed scan equals the unsplit scan in checksums and state,
    and runs through both kernels' wrappers (plain on the CPU)."""
    h = np.asarray(FILTER_BANKS[5]["sharpen"])
    channels, width, blocks = 4, 16_384, 4
    assert pick_window_split(channels, width, 5) == (512, 16)
    data = torch.from_numpy(rng.integers(0, 256, size=(blocks, channels, width),
                                         dtype=np.uint8))
    ref_stream = Fir1DStream(h, channels, device="cpu")
    ref = stream_scanned(ref_stream, lambda b: data[b], blocks, rows_split=1)
    calls = {"windows": 0, "band": 0}
    plain_windows, plain_band = window_copy.window_rows_plain, fir_band.fir_band_plain

    def windows_spy(*args):
        calls["windows"] += 1
        return plain_windows(*args)

    def band_spy(*args):
        calls["band"] += 1
        return plain_band(*args)

    win_stream = Fir1DStream(h, channels, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(window_copy, "window_rows_plain", windows_spy)
        mp.setattr(fir_band, "fir_band_plain", band_spy)
        got = stream_scanned(win_stream, lambda b: data[b], blocks,
                             rows_split="pallas")
    assert calls == {"windows": blocks, "band": blocks}
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(win_stream.state.carry, ref_stream.state.carry)


def test_windowed_mode_gates():
    assert pick_window_split(4, 1000, 5) is None
    assert pick_window_split(4, 16_384, 131) is None
    h = np.asarray(FILTER_BANKS[5]["sharpen"])
    st = Fir1DStream(h, 4, device="cpu")
    zeros = lambda b: torch.zeros((4, 16_384), dtype=torch.uint8)  # noqa: E731
    with pytest.raises(ValueError, match="default emit"):
        stream_scanned(st, zeros, 1, rows_split="pallas",
                       emit_fn=lambda y: y[:, :1])
    with pytest.raises(ValueError, match="no windowed-scan geometry"):
        stream_scanned(Fir1DStream(np.ones(131) / 131, 4, device="cpu"),
                       zeros, 1,
                       rows_split="pallas")


@pytest.mark.parametrize("rows_split", [2, 8, "auto"])
def test_row_split_is_not_ported(rng, rows_split):
    """The TPU row-split step is not ported: a split is accepted and runs
    the default step, with the unsplit scan's checksums and carry."""
    data = torch.from_numpy(rng.integers(0, 256, size=(2, 2, 64),
                                         dtype=np.uint8))
    ref = Fir1DStream([0.5, 0.5], 2, device="cpu")
    st = Fir1DStream([0.5, 0.5], 2, device="cpu")
    want = stream_scanned(ref, lambda b: data[b], 2)
    got = stream_scanned(st, lambda b: data[b], 2, rows_split=rows_split)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st.state.carry, ref.state.carry)


@pytest.mark.parametrize("rows_split", [0, -2, 1.5, True, "wide"])
def test_scan_rejects_bad_rows_split(rows_split):
    st = Fir1DStream([0.5, 0.5], 2, device="cpu")
    with pytest.raises(ValueError, match="rows_split"):
        stream_scanned(st, lambda b: torch.zeros((2, 64), dtype=torch.uint8),
                       1, rows_split=rows_split)


def test_scan_rejects_bad_blocks():
    st = Fir1DStream([0.5, 0.5], 2, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        stream_scanned(st, lambda b: torch.zeros((2, 64), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="channels"):
        stream_scanned(st, lambda b: torch.zeros((3, 64), dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="shape"):
        stream_scanned(st, lambda b: torch.zeros((2, 64 + b), dtype=torch.uint8),
                       2)


def test_custom_emit(rng):
    """A custom emit sees the (C, S) outputs of the unsplit step."""
    h = np.asarray(FILTER_BANKS[3]["sharpen"])
    data = rng.integers(0, 256, size=(3, 2, 50), dtype=np.uint8)
    st = Fir1DStream(h, 2, device="cpu")
    got = stream_scanned(st, lambda b: torch.from_numpy(data[b]), 3,
                         emit_fn=lambda y: y[:, :4].to(torch.int64))
    manual = Fir1DStream(h, 2, device="cpu")
    want = np.stack([manual.process(data[b])[:, :4] for b in range(3)])
    np.testing.assert_array_equal(got, want)


def test_default_emit_matches_jax(rng):
    y = rng.integers(0, 256, size=(5, 3001), dtype=np.uint8)
    got = default_emit_checksums(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_streaming.default_emit_checksums(jnp.asarray(y))))
    np.testing.assert_array_equal(got.astype(np.uint64), host_emit_checksums(y))


def test_checksums_mask_each_product():
    """16 × 2^21 samples of 255: unmasked products of the third sum would
    total past 2^63; the masked int64 sums equal the JAX uint32 ones."""
    y = np.full((16, 1 << 21), 255, np.uint8)
    w = np.arange(1, y.shape[1] + 1, dtype=np.float64)
    unmasked = (16.0 * 255.0 * np.mod(w * 2654435761.0, 2.0**32)).sum()
    assert unmasked > 2.0**63
    got = default_emit_checksums(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_streaming.default_emit_checksums(jnp.asarray(y))))
    np.testing.assert_array_equal(got.astype(np.uint64), host_emit_checksums(y))


@pytest.mark.parametrize("tap", [1, 4, 5, 129])
def test_windowed_checksums_match_jax(rng, tap):
    """``_emit_windowed_checksums`` on the same window-major rows."""
    channels, sub, windows = 3, 256, 4
    y_win = rng.integers(0, 256, size=(windows * channels, sub + 256),
                         dtype=np.uint8)
    got = _emit_windowed_checksums(torch.from_numpy(y_win), channels, sub, tap)
    want = jax_streaming._emit_windowed_checksums(jnp.asarray(y_win), channels,
                                                  sub, tap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
