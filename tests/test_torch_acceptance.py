"""tools/acceptance_torch.py, the port's one-command HPatches acceptance,
on the CPU: a mini HPatches fixture (tests/test_e2e.py) and a seeded port
checkpoint at a small width, saved as a reference run dir (``.pth`` files
in an epoch directory, the run's config.yaml one directory up).

- Without a reference cache the tool reports absolute numbers, exit 0.
- Against a cache made from its own features it PASSes at delta 0, and
  against a better cache it FAILs with exit 2.
- A directory without both ``.pth`` files (a JAX msgpack checkpoint among
  them) exits non-zero before any extraction.
- JAX's tools/acceptance.py on the same ``.pth`` dir and fixture (it
  imports the weights into msgpack first) gives the same MMA@3: the
  fixture's own MMA@3 (1 illumination + 1 viewpoint sequence) from the
  two tools' error caches within 0.005, the limit that
  tests/test_torch_evals.py holds the two packages' HPatches slices to.
"""

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tools")]

import acceptance_torch as tool  # noqa: E402
from posfeat_tpu_torch.core.config import dump_config  # noqa: E402
from posfeat_tpu_torch.evals import hpatches as hp  # noqa: E402
from posfeat_tpu_torch.models import PoSFeat  # noqa: E402
from test_e2e import make_mini_hpatches  # noqa: E402
from torch_port_helpers import SMALL_CONFIG  # noqa: E402

METHOD = "PoSFeat_tpu"  # configs/extract_hpatches.yaml's postfix
MMA3_TOL = 0.005


def _model_config():
    cfg = copy.deepcopy(SMALL_CONFIG)
    del cfg["localheader_config"]["out_channels"]
    return cfg


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(HPatches root, the run's epoch dir, the tool's work dir after a run
    without a reference cache, that run's exit code and JSON line)."""
    root = tmp_path_factory.mktemp("acceptance")
    hp_root = str(root / "hp")
    make_mini_hpatches(hp_root, n_seq=2, n_img=6)
    run = root / "run"
    PoSFeat(_model_config(), device="cpu", seed=3).save_checkpoint(str(run / "001"))
    dump_config({"model": "PoSFeat", "model_config": _model_config()}, str(run / "config.yaml"))
    work = str(root / "work")
    rc, rec = _run_tool(hp_root, str(run / "001"), work)
    return hp_root, str(run / "001"), work, rc, rec


def _run_tool(hp_root, weights, work, ref_cache=None):
    argv = ["--hpatches", hp_root, "--weights", weights, "--work", work, "--batch_size", "2", "--device", "cpu"]
    if ref_cache:
        argv += ["--ref_cache", ref_cache]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    recs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    return rc, recs[-1] if recs else None


def _cache(work):
    return os.path.join(work, "eval_cache", f"{METHOD}.npy")


def _fixture_mma3(cache_file):
    return hp.mma_at(hp.load_reference_cache(cache_file), 3, n_i=1, n_v=1)[0]


def test_reports_absolute_numbers_without_a_cache(assets):
    hp_root, _, work, rc, rec = assets
    assert rc == 0
    assert set(rec) == {"mma3", "mma_score", "bar", "fast", "ref_mma3", "passed"}
    assert 0.0 <= rec["mma3"] <= 1.0 and rec["passed"] is None and rec["ref_mma3"] is None
    assert rec["bar"] == 0.005 and rec["fast"] is False
    n = len([f for s in os.listdir(hp_root) for f in os.listdir(os.path.join(work, "hpatches_acceptance", "desc", s))])
    assert n == 12 and os.path.exists(_cache(work))
    assert 0.0 < _fixture_mma3(_cache(work)) <= 1.0


def test_passes_at_delta_zero_against_its_own_cache(assets, tmp_path):
    hp_root, weights, work, _, _ = assets
    ref = str(tmp_path / "ref_cache.npy")
    shutil.copy(_cache(work), ref)
    rc, rec = _run_tool(hp_root, weights, work, ref)
    assert rc == 0 and rec["passed"] is True and rec["delta_mma3"] == 0.0
    assert rec["ref_mma3"] == rec["mma3"]


def test_fails_against_a_better_cache(assets, tmp_path):
    hp_root, weights, work, _, rec0 = assets
    i_err, v_err, stats = hp.load_reference_cache(_cache(work))
    better_i = dict(i_err)
    better_i[3] = i_err[3] + 0.02 * (hp.N_I + hp.N_V) * 5  # MMA@3 + 0.02
    ref = str(tmp_path / "better.npy")
    np.save(ref, np.array((better_i, v_err, stats), dtype=object))
    rc, rec = _run_tool(hp_root, weights, work, ref)
    assert rc == 2 and rec["passed"] is False
    assert rec["delta_mma3"] == pytest.approx(-0.02, abs=1e-4) and rec["mma3"] == rec0["mma3"]


@pytest.mark.parametrize("files", [(), ("backbone.pth",), ("localheader.pth",),
                                   ("backbone.msgpack", "localheader.msgpack")],
                         ids=["empty", "no_localheader", "no_backbone", "jax_msgpack"])
def test_refuses_a_dir_without_both_pth_files(assets, tmp_path, files):
    hp_root, weights, _, _, _ = assets
    ck = tmp_path / "ckpt"
    ck.mkdir()
    for f in files:
        src = os.path.join(weights, f)
        shutil.copy(src, ck / f) if os.path.exists(src) else (ck / f).write_bytes(b"\x80")
    work = tmp_path / "work"
    with pytest.raises(SystemExit) as e:
        _run_tool(hp_root, str(ck), str(work))
    assert e.value.code not in (0, None)
    assert ("msgpack" in str(e.value.code)) == ("backbone.msgpack" in files)
    assert not (work / "hpatches_acceptance").exists()


def test_the_jax_tool_gives_the_same_mma3(assets, tmp_path):
    hp_root, weights, work, _, rec = assets
    jax_work = tmp_path / "jax_work"
    jax_work.mkdir()
    # the JAX tool imports the .pth files into <work>/ckpt, whose run-level
    # config.yaml it then reads from <work>
    shutil.copy(os.path.join(os.path.dirname(weights), "config.yaml"), jax_work / "config.yaml")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("CONV_", "POSFEAT_"))}
    env["POSFEAT_PLATFORM"] = "cpu"
    r = subprocess.run(
        [sys.executable, "tools/acceptance.py", "--hpatches", hp_root, "--weights", weights, "--work",
         str(jax_work), "--ref_cache", str(tmp_path / "missing.npy"), "--batch_size", "2"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    jax_rec = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")][-1]
    assert set(jax_rec) == set(rec)
    got, want = _fixture_mma3(_cache(work)), _fixture_mma3(_cache(str(jax_work)))
    print(f"fixture MMA@3: port {got:.6f}, JAX {want:.6f}")
    assert abs(got - want) <= MMA3_TOL, (got, want)
    assert abs(rec["mma3"] - jax_rec["mma3"]) <= MMA3_TOL
