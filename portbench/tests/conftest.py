"""Fixtures of the benchmark's tests: tiny copies of the cells on the CPU,
and the `card` marker for tests that need a CUDA device (they skip
elsewhere, decided inside the fixture)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

# the tiny sizes the CPU runs (the plans then hold dense blocks only)
TINY = {"helm2_bie_k40": {"n": 512, "k": 10.0}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def copy_bench(root: Path) -> None:
    """BENCHMARK.json and the benchmark's files (not its tests) under
    `root`, as a checkout holds them."""
    src = harness.ROOT
    shutil.copy(src / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(src / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))


def write_tiny(root: Path) -> harness.Bench:
    """A copy of the benchmark under `root`, every configuration cut to
    `TINY`'s sizes (limits as committed)."""
    copy_bench(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        cfg.update(TINY[c["name"]])
        (root / c["file"]).write_text(json.dumps(cfg))
    return harness.Bench(root)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> harness.Bench:
    return write_tiny(tmp_path_factory.mktemp("tiny"))


def run_cell(bench, cell, seed=2**31 + 7, seconds=0.3, trace=False):
    import time

    return harness.execute(bench, cell, seed, seconds, trace, "cpu",
                           time.perf_counter())
