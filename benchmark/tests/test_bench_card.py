"""Every cell of BENCHMARK.json through ``benchmark/run.py`` on the card,
a short window each, untraced and traced: the result line's keys, and
``correct``. Run on the card: ``python -m pytest -m gpu benchmark/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 7),
                          "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    spec = harness.load_spec()
    want = ({m["name"] for m in harness.per_layer_entries(spec, cell)} if trace
            else set(harness.end_to_end_names(spec, cell)))
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
