"""Weights between the packages: from_jax_variables is the exact inverse
of posfeat_tpu.core.torch_import, and the port's per-module .pth
checkpoints round-trip. Also the port's config files and device rule."""

import copy
import json

import numpy as np
import pytest
import torch
import jax

from posfeat_tpu.core.config import load_config as jax_load_config
from posfeat_tpu.core.torch_import import import_keypoint_det, import_resunet
from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.core.config import dump_config, merge_from_checkpoint
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict
from posfeat_tpu_torch.models import PoSFeat
from torch_port_helpers import SMALL_CONFIG, jax_posfeat, port_posfeat, randomize


def _assert_trees_equal(got, ref, path=""):
    assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=f"{path}/{k}")


def test_from_jax_variables_round_trips_exactly():
    _, variables = jax_posfeat(seed=4)
    model = port_posfeat(variables)  # load_state_dict is strict: every name maps
    sd_b = {k: v.numpy() for k, v in model.backbone.state_dict().items()}
    sd_h = {k: v.numpy() for k, v in model.localheader.state_dict().items()}
    _assert_trees_equal(import_resunet(sd_b), variables["backbone"])
    _assert_trees_equal(import_keypoint_det(sd_h), variables["localheader"])


def test_resunet_hr_layout_round_trips(rng):
    from posfeat_tpu.models import ResUNetHR

    m = ResUNetHR(encoder="resnet18", coarse_out_ch=16, fine_out_ch=16)
    v = m.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32), train=False)
    v = randomize(jax.tree.map(np.asarray, v), rng)
    sd = {k: t.numpy() for k, t in backbone_state_dict(v).items()}
    assert "upconv1.conv.conv.weight" in sd
    _assert_trees_equal(import_resunet(sd), v)


def test_pth_checkpoints_round_trip(tmp_path):
    _, variables = jax_posfeat(seed=5)
    src = port_posfeat(variables)
    src.save_checkpoint(str(tmp_path / "ck"))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["backbone.pth", "localheader.pth"]
    dst = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=9)
    dst.load_checkpoint(str(tmp_path / "ck"))
    for a, b in zip(src.state_dict().values(), dst.state_dict().values()):
        assert torch.equal(a, b)
    # a missing module keeps its current parameters
    (tmp_path / "ck" / "localheader.pth").unlink()
    fresh = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=9)
    before = copy.deepcopy(fresh.localheader.state_dict())
    fresh.load_checkpoint(str(tmp_path / "ck"))
    for k, v in fresh.localheader.state_dict().items():
        assert torch.equal(v, before[k])
    for a, b in zip(src.backbone.state_dict().values(), fresh.backbone.state_dict().values()):
        assert torch.equal(a, b)


def test_seeded_init_is_reproducible():
    a = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=1).state_dict()
    b = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=1).state_dict()
    c = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.firstconv.weight"], c["backbone.firstconv.weight"])


def test_config_dump_reads_back_in_both_packages(tmp_path):
    cfg = {"output_root": "x", "model_config": copy.deepcopy(SMALL_CONFIG), "thr": 0.9}
    dump_config(cfg, str(tmp_path / "config.yaml"))
    assert jax_load_config(str(tmp_path / "config.yaml")) == cfg
    assert json.loads((tmp_path / "config.yaml").read_text()) == cfg
    # merge-on-load: the run's saved model section wins
    (tmp_path / "run" / "005").mkdir(parents=True)
    saved = {"model": "PoSFeat", "model_config": {"backbone": "ResUNet"}}
    dump_config(saved, str(tmp_path / "run" / "config.yaml"))
    merged = merge_from_checkpoint(
        {"load_path": str(tmp_path / "run" / "005"), "model_config": {"backbone": "None", "x": 1}}
    )
    assert merged["model_config"] == {"backbone": "ResUNet", "x": 1}


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            PoSFeat(copy.deepcopy(SMALL_CONFIG))
