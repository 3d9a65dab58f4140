"""The cells on the card, briefly: marked ``card``, they skip inside the
test where there is no NVIDIA card (run them on one with ``python3 -m
pytest portbench/tests -q -m card``)."""

import json
import subprocess
import sys

import pytest

from portbench.common import ROOT


def need_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} NVIDIA card(s)")


@pytest.mark.card
@pytest.mark.parametrize("name, cards", [("sharpen5.rows", 1),
                                         ("lowpass63.rows", 1),
                                         ("sharpen5.stream", 1),
                                         ("os63.sharded4", 4)])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(name, cards, traced):
    need_cards(cards)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**32 + 11), "--seconds", "2", "--trace",
         str(traced)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("name, cards", [("sharpen5.rows", 1),
                                         ("sharpen5.stream", 1)])
def test_control_is_not_correct_on_the_card(name, cards):
    need_cards(cards)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.readings", "--workload", name,
         "--seconds", "1", "--seeds", "5", "6", "7", "--control"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert all(not x["correct"] for x in lines if "seed" in x)
