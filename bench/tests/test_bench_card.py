"""On the card: one short run of each cell prints a line with its metrics
and `correct` true.  Skips where there is no CUDA device (decided in the
fixture, never at import)."""
import json
import subprocess
import sys

import pytest

from bench.lib import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_card(card, name):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 17), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert {m["name"] for m in spec.load_cell(name).end_to_end} \
        == set(line["metrics"])
