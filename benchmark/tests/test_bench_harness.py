"""The harness is driven by data: a new per-layer metric and a new
workload are a file each plus an entry in BENCHMARK.json, found by name
with no edit to any file that is there. Also the trace's reduction, an
empty trace, and a run without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

DUMMY_METRIC = '''"""A dummy per-layer metric: the kernels' count."""

UNIT = "launches"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "extract_images_per_s"


def read(rec):
    return float(len(rec.kernels))
'''


@pytest.fixture()
def checkout(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with a dummy metric, a
    dummy traffic mix and a dummy cell added as new files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    (bench / "metrics" / "dummy_launches.extract.py").write_text(DUMMY_METRIC)
    mix = json.loads((bench / "traffic" / "extract-480x640.json").read_text())
    mix.update(height=64, width=96, batch_size=2, pool_images=4, warmup_batches=1, check_images=2)
    mix["detector_config"]["num_pts"] = 64
    (bench / "traffic" / "extract-64x96.json").write_text(json.dumps(mix))
    limits = json.loads((bench / "limits" / "r50-f32.extract-480x640.json").read_text())
    (bench / "limits" / "r50-f32.extract-64x96.json").write_text(json.dumps(limits))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "r50-f32.extract-64x96", "config": "posfeat-r50-f32",
                              "traffic": "extract-64x96", "chips": 1, "why": "a dummy cell"})
    spec["per_layer"].append({"name": "dummy_launches.extract", "unit": "launches", "better": "lower",
                              "source": "device_trace", "layer": "device", "moves": "extract_images_per_s",
                              "workloads": ["r50-f32.extract-64x96"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "r50-f32.extract-480x640" in m["workloads"]:
            m["workloads"].append("r50-f32.extract-64x96")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
    return tmp_path


def _py(root, code):
    # the copy's benchmark first, the program from this checkout
    head = f"import sys; sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
    out = subprocess.run([sys.executable, "-c", head + code],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_new_metric_and_workload_are_found(checkout):
    out = _py(checkout, """
from benchmark import harness
spec = harness.load_spec()
cell = harness.cell_entry(spec, "r50-f32.extract-64x96")
names = [m["name"] for m in harness.per_layer_entries(spec, cell["name"])]
assert "dummy_launches.extract" in names and "moments_roofline.extract" not in names, names
assert harness.metric_module("dummy_launches.extract").UNIT == "launches"
assert harness.traffic_of(cell)["height"] == 64
assert harness.end_to_end_names(spec, cell["name"]) == ["extract_images_per_s", "setup_s"]
print("found")
""")
    assert "found" in out


def test_new_workload_runs_through_the_harness(checkout):
    """The dummy cell's run on the CPU, past the look for a card."""
    out = _py(checkout, """
import json, tempfile, time, torch
from benchmark import harness, run
spec = harness.load_spec()
cell = harness.cell_entry(spec, "r50-f32.extract-64x96")
ctx = harness.Context(cell["name"], 2**31 + 11, torch.device("cpu"), harness.config_of(spec, cell),
                      harness.traffic_of(cell), tempfile.mkdtemp())
result, rows = run.execute(ctx, spec, 5.0, False, time.perf_counter())
print(json.dumps(result))
""")
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"extract_images_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_run_without_a_card_prints_no_result(checkout):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r50-f32.extract-480x640",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("this machine has a CUDA card")
    assert out.stdout.strip() == ""


def _trace_file(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.backbone", "ts": 10, "dur": 100, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 500, "dur": 400, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 5, "tid": 1, "pid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 200, "dur": 5, "tid": 1, "pid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 30, "dur": 100, "tid": 7, "pid": 0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 100, "dur": 100, "tid": 7, "pid": 0,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 950, "dur": 100, "tid": 7, "pid": 0},
    ]
    rec = trace.reduce_trace(_trace_file(tmp_path, ev), 1e-3, {"batch": 1})
    assert rec.busy_s == pytest.approx(220e-6)  # 30..200 and 950..1000 inside the window
    assert rec.kernel_time("k_", layer="backbone") == (pytest.approx(100e-6), 1)
    assert rec.spans == {"backbone": 1}
    gaps = dict(rec.breakdown["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(750e-6)  # 200..950, its middle inside the copy
    assert gaps["bench.backbone"] == pytest.approx(30e-6)
    assert rec.breakdown["device_ops"][0][0] in ("k_a", "k_b")


def test_empty_trace_fails(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000, "tid": 1, "pid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 10, "tid": 1, "pid": 1}]
    with pytest.raises(trace.EmptyTrace):
        trace.reduce_trace(_trace_file(tmp_path, ev), 1e-3, {})


def test_entries_agree_with_their_readers():
    """Each per-layer entry of BENCHMARK.json names the unit, layer,
    source and end-to-end metric its reader declares, and lists cells
    that report that end-to-end metric."""
    from benchmark import harness

    spec = harness.load_spec()
    cells = {w["name"] for w in spec["workloads"]}
    for entry in spec["per_layer"]:
        mod = harness.metric_module(entry["name"])
        assert (entry["unit"], entry["layer"], entry["source"], entry["moves"]) == \
            (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES), entry["name"]
        for cell in entry["workloads"]:
            assert cell in cells and entry["moves"] in harness.end_to_end_names(spec, cell), (entry["name"], cell)
