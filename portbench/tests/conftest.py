"""The benchmark's CPU tests: ``python3 -m pytest portbench/tests -q`` from
the root of the checkout.  Tests marked ``card`` need an NVIDIA card and
skip inside the test where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips inside the test without one")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny torch runs on one intra-op thread: pools spinning for cores that
    other test workers hold make them far slower."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
