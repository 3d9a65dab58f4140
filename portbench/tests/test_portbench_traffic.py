"""The traffic generators repeat for a seed, differ between seeds and take
seeds past 32 bits; the traffic and configuration files are complete."""

import pytest
import torch

from portbench import harness
from portbench.drivers.rows import make_rows
from portbench.drivers.stream import block_tweak, stream_source

BIG = 2**31 + 12345678901


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_rows_repeat_for_a_seed(seed):
    a = make_rows(6, 300, torch.device("cpu"), seed)
    b = make_rows(6, 300, torch.device("cpu"), seed)
    assert a.dtype == torch.uint8 and a.shape == (6, 300)
    assert torch.equal(a, b)
    assert not torch.equal(a, make_rows(6, 300, torch.device("cpu"),
                                        seed + 1))


@pytest.mark.parametrize("seed", [3, BIG])
def test_stream_blocks_repeat_for_a_seed(seed):
    one = stream_source(4, 256, torch.device("cpu"), seed)
    two = stream_source(4, 256, torch.device("cpu"), seed)
    for b in (0, 1, 17, 10**6):
        assert torch.equal(one(b), two(b))
    assert not torch.equal(one(0), stream_source(4, 256, torch.device("cpu"),
                                                 seed + 1)(0))
    # Block b is the noise table XOR block b's byte.
    assert torch.equal(one(5) ^ block_tweak(5), one(0) ^ block_tweak(0))


def test_block_tweak_is_the_benches_hash():
    # bench_streaming.py:80-84's hash in uint32, worked out by hand for b=1:
    # s = 2654435761; s ^= s >> 13; s *= 1274126177 (mod 2^32); s >> 8 & 255.
    s = 2654435761
    s = ((s ^ (s >> 13)) * 1274126177) & 0xFFFFFFFF
    assert block_tweak(1) == (s >> 8) & 255
    assert {block_tweak(b) for b in range(64)} != {block_tweak(0)}


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows",
                                  "sharpen5.stream", "os63.sharded4"])
def test_every_cell_finds_its_files(name):
    cell = harness.load_cell(name, seeds=[1], seconds=1.0, trace=False)
    harness.load_module("drivers", cell.traffic["driver"])
    harness.load_module("checks", cell.traffic["check"])
    for entry in cell.end_to_end:
        harness.load_module("endtoend", entry["name"])
    for entry in cell.per_layer:
        harness.load_module("metrics", entry["name"])
    assert {m["name"] for m in cell.end_to_end} == {"msps", "setup_s"}
    assert {m["moves"] for m in cell.per_layer} == {"msps"}
    assert {"device_idle", "call_ms_p95"} <= {m["name"] for m in cell.per_layer}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell", seeds=[1], seconds=1.0,
                          trace=False)
