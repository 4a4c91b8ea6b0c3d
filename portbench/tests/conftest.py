"""Tests of the benchmark (python -m pytest portbench/tests).

The CPU tests drive the harness on the tiny fixture cells in `fixture/`
(the port's plain kernel versions on CPU tensors). Tests marked `card` need
an NVIDIA GPU and skip without one; on the card they run with
`python -m pytest portbench/tests -m card`.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FIXTURE = Path(__file__).resolve().parent / "fixture"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The first CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none is visible")
    return torch.device("cuda", 0)


def make_root(tmp: Path) -> Path:
    """A checkout of the benchmark with the fixture's cells added: the
    benchmark's files as they are, the fixture's configurations, mixes,
    limits and metric beside them, and the fixture's BENCHMARK.json. No file
    of the benchmark is edited."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("configs", "traffic", "limits", "metrics"):
        for f in (FIXTURE / sub).iterdir():
            assert not (tmp / "portbench" / sub / f.name).exists(), f
            shutil.copy(f, tmp / "portbench" / sub / f.name)
    shutil.copy(FIXTURE / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


@pytest.fixture
def bench_root(tmp_path):
    return make_root(tmp_path)
