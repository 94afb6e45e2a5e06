"""One short run of a cell on the card, through the benchmark's own
command in `BENCHMARK.json`; skipped without a CUDA device."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "coupled-sparse.track", "--seed", "2147483700", "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
