"""Tests of the benchmark: CPU tests at small sizes, and tests marked
`card` that need an NVIDIA GPU and skip without one (run them on the
card with `python3 -m pytest benchmark/tests -m card`)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def small_checkout(tmp: Path, fleet: int = 16, samples: int = 4) -> Path:
    """A checkout of the benchmark whose traffic mixes have `fleet`
    vehicles and `samples` sampled a period, the program and the value
    grids linked from the repository."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    for name in ("assets", "pigeon_tpu_torch"):
        (tmp / name).symlink_to(ROOT / name)
    for mix in (tmp / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(mix.read_text())
        d.update(fleet=fleet, samples_per_period=samples)
        mix.write_text(json.dumps(d))
    return tmp


@pytest.fixture
def small_root(tmp_path):
    return small_checkout(tmp_path)
