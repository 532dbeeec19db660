"""tools/stage2_sweep_torch.py, the port's stage-2 recipe sweep, against
tools/stage2_sweep.py on the CPU.

- The variant tables are JAX's, and for every name in them the port's
  stage-2 config equals JAX's ``kp_config`` on the same stage-1 path,
  under the JAX tool's defaults and under other nuisances and the
  head192 model. The JAX tool reads those from ``CONV_*`` variables into
  tools/convergence_experiment.py's module constants when it is first
  imported; the test sets the constants to the port's flags explicitly.
- A 1 epoch x 2 step tuple, through the same functions as a real variant,
  on a seeded stage-1 checkpoint: the shared SIFT arm, then one seed of
  training and the arms, printing the per-seed line and the variant's
  record with the JAX tool's keys (tools/stage2_sweep.py:225-284).
"""

import contextlib
import copy
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tools")]

import convergence_experiment as jax_recipe  # noqa: E402
import stage2_sweep as jax_tool  # noqa: E402
import stage2_sweep_torch as tool  # noqa: E402
from convergence_experiment_torch import MODEL_CONFIG  # noqa: E402
from posfeat_tpu_torch.core.config import dump_config  # noqa: E402
from posfeat_tpu_torch.models import PoSFeat  # noqa: E402

RECIPES = {
    "jax_defaults": dict(tool.RECIPE),
    "probe_head192": {"rot": 20.0, "scale": 0.18, "photo": 1.15, "lr1": 3e-4, "pairs": 512, "model": "head192"},
}
PER_SEED_KEYS = {"variant", "seed", "secs", "mma3_n128", "mma3_n256", "mma3_n128_quad", "mma3_n128_quad5",
                 "matched_mma3", "matched_mma5", "matched_mma3_quad5"}
CK1 = "/ckpts/conv_desc/001"


def _set_jax_recipe(monkeypatch, recipe):
    """tools/convergence_experiment.py's CONV_* constants, as the port's flags give them."""
    model = copy.deepcopy(jax_recipe.MODEL_CONFIG)
    model["backbone_config"]["fine_out_ch"] = 128 if recipe["model"] == "head192" else 64
    model["localheader_config"]["in_channels"] = 192 if recipe["model"] == "head192" else 128
    monkeypatch.setattr(jax_recipe, "MODEL_CONFIG", model)
    monkeypatch.setattr(jax_recipe, "LR1", recipe["lr1"])
    monkeypatch.setattr(jax_recipe, "N_PAIRS", recipe["pairs"])
    monkeypatch.setattr(jax_recipe, "ROT_MAX", recipe["rot"])
    monkeypatch.setattr(jax_recipe, "SCALE_RANGE", (1.0 - recipe["scale"], 1.0 + recipe["scale"]))
    monkeypatch.setattr(jax_recipe, "PHOTO_STRENGTH", recipe["photo"])


def test_tables_are_the_jax_tools():
    assert tool.VARIANTS == jax_tool.VARIANTS
    assert tool.EXTRAS == jax_tool.EXTRAS


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("name", sorted(jax_tool.VARIANTS) + sorted(jax_tool.EXTRAS))
def test_kp_config_is_the_jax_tools(monkeypatch, name, recipe):
    _set_jax_recipe(monkeypatch, RECIPES[recipe])
    base, extras, cextras = jax_tool.EXTRAS.get(name, (name, None, None))
    tup = jax_tool.VARIANTS[base]
    ce = {**(cextras or {}), "seed": (cextras or {}).get("seed", 0) + 1}
    want = jax_tool.kp_config("/work", name, CK1, *tup, disk_extras=extras, cfg_extras=ce)
    t_tup, t_extras, t_cextras = tool.variant(name)
    assert (t_tup, t_extras, t_cextras) == (tup, extras, cextras)
    got = tool.kp_config(name, CK1, *t_tup, disk_extras=t_extras, cfg_extras=dict(ce), recipe=RECIPES[recipe])
    assert got == want


def test_a_short_tuple_prints_the_jax_tools_lines(tmp_path):
    run = tmp_path / "stage1"
    PoSFeat(copy.deepcopy(MODEL_CONFIG), device="cpu", seed=2).save_checkpoint(str(run / "001"))
    dump_config({"model": "PoSFeat", "model_config": MODEL_CONFIG}, str(run / "config.yaml"))
    work = str(tmp_path / "work")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sift3 = tool.sift_arm(work, str(run / "001"), device="cpu")
        rec = tool.run_variant(work, "short", (1, 2, 5e-3, 1, 2, -0.001), str(run / "001"), sift3, device="cpu")
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    per_seed = [x for x in lines if "seed" in x and x.get("variant") == "short"]
    assert len(per_seed) == 1 and set(per_seed[0]) == PER_SEED_KEYS
    assert all(0.0 <= per_seed[0][k] <= 1.0 for k in PER_SEED_KEYS - {"variant", "seed", "secs"})
    assert lines[-1] == rec and set(rec) == {"epochs", "steps", "lr", "reward_thr", "kp_penalty", "seeds",
                                             "sift_arm_mma3"} | PER_SEED_KEYS - {"seed", "secs"}
    assert os.path.isdir(os.path.join(work, "ckpts", "kp_short", "001"))
