"""tools/budget_matched_eval_torch.py against tools/budget_matched_eval.py
on the CPU: the same truncated npz files, and the same JSON lines (the
SIFT arm's MMA bands, the matched-budget arm's, the fixed-budget ladder)
on an HPatches-layout fixture of npz features."""

import glob
import json
import os
import sys

import numpy as np

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "tools")]

import budget_matched_eval as jax_tool  # noqa: E402
import budget_matched_eval_torch as tool  # noqa: E402
from test_torch_evals import _hpatches_features  # noqa: E402


def _files(root):
    return sorted(os.path.relpath(f, root) for f in glob.glob(os.path.join(root, "*", "*")))


def test_truncation_matches_the_jax_tool(tmp_path, rng):
    _, feats = _hpatches_features(tmp_path, rng, n_seq=2)
    counts = lambda rel: 40 + len(rel)  # per-image budgets
    tool.truncate_dir(feats, str(tmp_path / "a"), "m", counts)
    jax_tool.truncate_dir(feats, str(tmp_path / "b"), "m", counts)
    assert _files(tmp_path / "a") == _files(tmp_path / "b") and _files(tmp_path / "a")
    for rel in _files(tmp_path / "a"):
        za, zb = np.load(tmp_path / "a" / rel), np.load(tmp_path / "b" / rel)
        assert za["keypoints"].shape[0] == min(40 + len(rel), 160)
        for k in ("keypoints", "scores", "descriptors"):
            np.testing.assert_array_equal(za[k], zb[k])


def test_main_prints_the_jax_tools_lines(tmp_path, rng, capsys, monkeypatch):
    data, feats = _hpatches_features(tmp_path, rng, n_seq=4)
    # a "SIFT arm": each image's own count of keypoints, fewer than the learned slate's
    sift = tmp_path / "sift"
    tool.truncate_dir(feats, str(sift), "m", lambda rel: 90 + 7 * (sum(map(ord, rel)) % 5))
    args = ["--learned", feats, "--sift", str(sift), "--data", data, "--postfix", "m", "--ladder", "64,128"]
    tool.main(args + ["--device", "cpu"])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    monkeypatch.setattr(sys, "argv", ["budget_matched_eval.py", *args])
    jax_tool.main()
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == want
    assert [g["eval"] for g in got] == ["sift_arm", "learned_matched_budget", "learned_n64", "learned_n128"]
