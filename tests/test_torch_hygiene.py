"""Import hygiene of posfeat_tpu_torch, and of the scripts that drive it
on the card (chip_smoke.py and the port's tools): they import nothing of
JAX (jax, flax, optax) or of the JAX package, and read no environment
variable."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "posfeat_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "posfeat_tpu")
SOURCES = sorted(PKG.rglob("*.py"))
ROOT = PKG.parent
SCRIPTS = [ROOT / "chip_smoke.py"] + [
    ROOT / "tools" / f"{name}.py"
    for name in ("bench_torch_fused_parts", "profile_torch_extract", "profile_torch_train",
                 "profile_torch_conv_stages", "profile_torch_lse_stages", "compare_torch_trees",
                 "selection_stability_torch", "convergence_experiment_torch", "make_megadepth_fixture",
                 "budget_matched_eval_torch", "multihost_torch", "spatial_rounding_torch",
                 "spatial_bands_torch", "profile_torch_moments")
]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _violations(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _forbidden(alias.name):
                    yield node.lineno, f"import {alias.name}"
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                yield node.lineno, f"from {node.module} import"
            if node.module == "os" and any(a.name in ("environ", "getenv", "putenv") for a in node.names):
                yield node.lineno, "from os import environ/getenv"
        elif isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "environb"):
            yield node.lineno, f".{node.attr}"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "__import__":
            yield node.lineno, "__import__()"


def test_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {
        "ops/fused_head.py", "ops/detect.py", "extract/extractor.py",
        "ops/reinforce.py", "losses/disk_loss.py", "train/trainer.py",
    } <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_and_no_environment(path):
    assert list(_violations(path)) == []


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_card_scripts_have_no_jax_and_no_environment(path):
    assert list(_violations(path)) == []


def test_checker_catches_violations(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import jax.numpy as jnp\nfrom posfeat_tpu.ops import nms\nimport os\n"
        "x = os.environ.get('A')\nfrom os import getenv\nfrom posfeat_tpu_torch import ops\n"
    )
    found = [what for _, what in sorted(_violations(bad))]
    assert found == [
        "import jax.numpy", "from posfeat_tpu.ops import", ".environ",
        "from os import environ/getenv",
    ]
