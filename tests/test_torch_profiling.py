"""The port's ``trace`` (``torch.profiler``) against the JAX package's
contract: ``enabled=False`` never starts the profiler, and a profiler that
cannot start never raises (the port then prints one ``[WARN]`` line); on
the CPU a trace leaves a TensorBoard ``*.pt.trace.json`` in the directory.
"""

import json

import pytest
import torch
import torch.profiler

from warmup_fir_filter_tpu.utils.profiling import trace as jax_trace
from warmup_fir_filter_tpu_torch.utils.profiling import trace


class _Refused:
    def __init__(self, *args, **kwargs):
        raise RuntimeError("profiler refused")


def test_disabled_never_starts_the_profiler(monkeypatch, tmp_path, capsys):
    with jax_trace(str(tmp_path / "jax"), enabled=False):
        pass
    monkeypatch.setattr(torch.profiler, "profile", _Refused)
    with trace(str(tmp_path / "port"), enabled=False):
        ran = True
    assert ran
    assert not (tmp_path / "port").exists()
    assert "[WARN]" not in capsys.readouterr().out


def test_never_raises_when_the_profiler_cannot_start(monkeypatch, tmp_path,
                                                     capsys):
    with jax_trace(str(tmp_path / "jax")):
        _ = 1 + 1
    monkeypatch.setattr(torch.profiler, "profile", _Refused)
    with trace(str(tmp_path / "port")):
        out = torch.ones(3) * 2
    assert out.sum() == 6
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[WARN]")]
    assert len(lines) == 1 and "profiler refused" in lines[0]


def test_body_exception_propagates_and_stops_the_profiler(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)):
            raise KeyError("boom")
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_cpu_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert "aten::cumsum" in names
