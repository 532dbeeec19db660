"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (posfeat_tpu_torch passes, posfeat_tpu does not),
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "posfeat_tpu"}


def _imported(path: Path) -> set:
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _loaded(code: str) -> set:
    """Top-level names in sys.modules after running ``code`` in a fresh interpreter."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imported(path) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "posfeat_tpu_torch" not in _imported(path), path


def test_what_run_loads_holds_no_jax():
    """Every module the harness and both jobs load, with the program."""
    loaded = _loaded("import sys; sys.path.insert(0, '.'); import benchmark.run, benchmark.calibrate; "
                     "import benchmark.jobs.extract, benchmark.jobs.train_kp; "
                     "import posfeat_tpu_torch.extract, posfeat_tpu_torch.train; "
                     "from benchmark import harness\n"
                     "for m in harness.load_spec()['per_layer']: harness.metric_module(m['name'])")
    assert "posfeat_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import sys; sys.path.insert(0, '.'); import benchmark.reference.extraction, "
                     "benchmark.reference.stage2, benchmark.reference.quant")
    assert "posfeat_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_whole_names_are_compared():
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    probes = ("posfeat_tpu_torch_probe", "jaxlib_probe", "optax.probe")
    for name in probes:
        sys.modules[name] = type(sys)(name)
    try:
        found = set(harness.forbidden_modules()) & set(probes)
    finally:
        for name in probes:
            del sys.modules[name]
    assert found == {"optax.probe"}
