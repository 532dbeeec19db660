"""posfeat_tpu_torch's Trainer.val_and_vis against posfeat_tpu's on a
MegaDepth-layout fixture (tools/make_megadepth_fixture.py, 96x128), from
the same weights and the same validation samples, for the two shipped
validation configs: stage 1's ``detector: 'sift'`` (configs/train_desc.yaml,
its own ``data_config_val``) and stage 2's ``generate_kpts_single``
(configs/train_kp.yaml, samples from the train set).

JAX's ``tensor2array`` colours through matplotlib, which the card's
machine lacks and a CPU test machine may lack; a stub ``matplotlib``
whose ``colormaps[name]`` is the port's lookup table is put into
``sys.modules`` inside these tests only, so the JAX dumps get written
wherever they run (tests/test_torch_colormaps.py holds the tables
against matplotlib itself where it is installed).
Both packages' detector and matcher calls are recorded.

Measured agreement, both configs: descriptors within 1.9e-6 of JAX's
(held at 2e-5) and the mutual-NN matches equal. With ``'sift'`` the
keypoints are the sample's in both; with ``generate_kpts_single`` the
same valid counts, every keypoint within 1.9e-5 px (held at 1e-3) and
every score within 1.2e-4 (held at rtol 1e-4)."""

import copy
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posfeat_tpu.ops.detect as jdetect
import posfeat_tpu.ops.matchers as jmatchers
import posfeat_tpu_torch.ops.detect as tdetect
import posfeat_tpu_torch.ops.matchers as tmatchers
from posfeat_tpu.train.trainer import Trainer as JaxTrainer
from posfeat_tpu_torch.core.config import load_config
from posfeat_tpu_torch.core.jax_weights import from_jax_variables
from posfeat_tpu_torch.data import utils as tu
from posfeat_tpu_torch.train import Trainer
from torch_port_helpers import SMALL_CONFIG, jax_posfeat

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from make_megadepth_fixture import write_megadepth_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
FOLDERS = ("0_original_images", "1_score_maps", "2_all_keypoints", "3_matched_keypoints",
           "4_matches_less", "5_matches_all")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_megadepth_fixture(str(tmp_path_factory.mktemp("megadepth")), height=H, width=W)


@pytest.fixture
def fake_matplotlib(monkeypatch):
    stub = types.ModuleType("matplotlib")
    stub.colormaps = {k: (lambda x, k=k: tu.apply_colormap(x, k)) for k in tu.COLORMAPS}
    monkeypatch.setitem(sys.modules, "matplotlib", stub)


def _shipped(stage, root):
    """The shipped config of ``stage`` with only the data path, the point
    counts that a 96x128 fixture holds and the small model changed."""
    cfg = load_config(os.path.join(REPO, "configs", f"train_{stage}.yaml"))
    cfg.update(model_config=copy.deepcopy(SMALL_CONFIG), load_path=None, epoch=1, epoch_step=1,
               checkpoint_name=stage)
    cfg["data_config_train"].update(data_path=root, num_pts=32, workers=1)
    vcfg = cfg["val_config"]
    if "data_config_val" in vcfg:
        vcfg["data_config_val"].update(data_path=root, num_pts=32)
    else:
        vcfg["detector_config"]["num_pts"] = 64
    return cfg


def _recorder(monkeypatch, module, name, log, container=None):
    """Wrap ``module.name`` (or ``container[name]``) to append its
    arguments and result to ``log``."""
    target = container if container is not None else module.__dict__
    fn = target[name]

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append((a, out))
        return out

    if container is not None:
        monkeypatch.setitem(container, name, wrapped)
    else:
        monkeypatch.setattr(module, name, wrapped)


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("stage", ["desc", "kp"])
def test_val_and_vis_matches_jax(stage, root, tmp_path, monkeypatch, fake_matplotlib):
    cfg = _shipped(stage, root)
    _, variables = jax_posfeat(seed=5, im_shape=(1, H, W, 3))
    port = Trainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path / "port"), device="cpu")
    sds = from_jax_variables(variables)
    port.model.backbone.load_state_dict(sds["backbone"])
    port.model.localheader.load_state_dict(sds["localheader"])
    ref = JaxTrainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path / "jax"))
    ref.variables = jax.tree.map(jnp.asarray, variables)
    ref.trainable = {m: ref.variables[m]["params"] for m in ref.optimal_modules}

    # the same validation samples: the port's cache, read by JAX
    samples = port._load_val_samples()
    assert len(samples) == 2
    os.makedirs(ref.save_root, exist_ok=True)
    os.link(os.path.join(port.save_root, "val_data.npz"), os.path.join(ref.save_root, "val_data.npz"))

    logs = {k: [] for k in ("jdet", "tdet", "jmatch", "tmatch")}
    _recorder(monkeypatch, jdetect, "generate_kpts_single", logs["jdet"], jdetect.DETECTORS)
    _recorder(monkeypatch, tdetect, "generate_kpts_single", logs["tdet"], tdetect.DETECTORS)
    _recorder(monkeypatch, jmatchers, "mnn_matcher", logs["jmatch"])
    _recorder(monkeypatch, tmatchers, "mnn_matcher", logs["tmatch"])
    warnings = []
    monkeypatch.setattr(port.logger, "warning", lambda msg, **kw: warnings.append(msg))
    monkeypatch.setattr(ref.logger, "warning", lambda msg, **kw: warnings.append(msg))
    for step in (1, 2):
        port.val_and_vis(1, step)
        ref.val_and_vis(1, step)
    assert not warnings, warnings

    for si in range(2):
        for folder in FOLDERS:
            got = sorted(os.listdir(os.path.join(port.save_root, "vis", f"sample{si}", folder)))
            want = sorted(os.listdir(os.path.join(ref.save_root, "vis", f"sample{si}", folder)))
            assert got == want == ["1.jpg", "2.jpg"], (folder, got, want)
        for step in (1, 2):
            a, b = (open(os.path.join(t.save_root, "vis", f"sample{si}", FOLDERS[0], f"{step}.jpg"), "rb").read()
                    for t in (port, ref))
            assert a == b, "the original pair differs"

    # 2 steps x 2 samples: 4 matchings; the detector on both images of each
    assert len(logs["tmatch"]) == len(logs["jmatch"]) == 4
    for (targs, tm), (jargs, jm) in zip(logs["tmatch"], logs["jmatch"]):
        for d_t, d_j in zip(targs[:2], jargs[:2]):
            np.testing.assert_allclose(_np(d_t), _np(d_j), atol=2e-5)
        assert np.array_equal(np.asarray(tm), np.asarray(jm)), (len(tm), len(jm))
    if stage == "desc":
        assert not logs["tdet"] and not logs["jdet"]
        return
    assert len(logs["tdet"]) == len(logs["jdet"]) == 8
    for (_, (tk, ts, tv)), (_, (jk, js, jv)) in zip(logs["tdet"], logs["jdet"]):
        assert int(tv[0]) == int(jv[0])
        n = max(min(int(jv[0]), jk.shape[1]), 8)
        kt, kj = _np(tk)[0, :n], np.asarray(jk, np.float32)[0, :n]
        px = np.abs(kt - kj) * np.array([W - 1, H - 1]) / 2
        assert px.max() < 1e-3, px.max()
        np.testing.assert_allclose(_np(ts)[0, :n], np.asarray(js, np.float32)[0, :n], rtol=1e-4, atol=1e-6)


def test_val_data_npz_loads_in_both_packages(root, tmp_path):
    """JAX's val_data.npz feeds the port's _load_val_samples, and the
    port's feeds JAX's: the same samples, array for array."""
    cfg = _shipped("kp", root)
    ref = JaxTrainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path / "jax"))
    jsamples = ref._load_val_samples()
    port = Trainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path / "port"), device="cpu")
    os.link(os.path.join(ref.save_root, "val_data.npz"), os.path.join(port.save_root, "val_data.npz"))
    tsamples = port._load_val_samples()
    cfg1 = _shipped("desc", root)
    port1 = Trainer(copy.deepcopy(cfg1), ckpt_root=str(tmp_path / "port1"), device="cpu")
    t1 = port1._load_val_samples()
    ref1 = JaxTrainer(copy.deepcopy(cfg1), ckpt_root=str(tmp_path / "jax1"))
    os.link(os.path.join(port1.save_root, "val_data.npz"), os.path.join(ref1.save_root, "val_data.npz"))
    j1 = ref1._load_val_samples()
    for a_list, b_list in ((tsamples, jsamples), (t1, j1)):
        assert len(a_list) == len(b_list) == 2
        for a, b in zip(a_list, b_list):
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k


def test_val_and_vis_failure_warns_and_training_goes_on(root, tmp_path, monkeypatch):
    """Without matplotlib or the stub the port still colours (its own
    tables); a failing dump logs a warning and the run finishes."""
    cfg = _shipped("desc", root)
    cfg["data_config_train"]["batch_size"] = 2
    tr = Trainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path), device="cpu")
    tr.train()
    for folder in FOLDERS:
        assert os.listdir(os.path.join(tr.save_root, "vis", "sample0", folder)) == ["1.jpg"], folder
    warnings = []
    monkeypatch.setattr(tr.logger, "warning", lambda msg, **kw: warnings.append(msg))
    monkeypatch.setattr(tu, "COLORMAPS", {})
    tr.val_and_vis(1, 7)
    assert len(warnings) == 1 and warnings[0].startswith("val_and_vis failed"), warnings


def test_shipped_configs_train_as_shipped_on_the_cpu(root, tmp_path):
    """configs/train_desc.yaml, then configs/train_kp.yaml from its
    checkpoint, with only the data paths, the step counts and stage 2's
    load_path changed: the flagship model at f32 on the 96x128 fixture.
    Stage 1's validation pairs want 1024 SIFT points, which no 96x128
    image holds: it logs that and writes no dump; stage 2 validates on
    train pairs and writes its six folders."""
    import json

    desc = load_config(os.path.join(REPO, "configs", "train_desc.yaml"))
    desc.update(epoch=1, epoch_step=1)
    desc["data_config_train"]["data_path"] = root
    desc["val_config"]["data_config_val"]["data_path"] = root
    tr1 = Trainer(desc, ckpt_root=str(tmp_path), device="cpu")
    warnings = []
    tr1.logger.warning = lambda msg, **kw: warnings.append(msg)
    tr1.train()
    assert len(warnings) == 1 and "validation pairs" in warnings[0], warnings
    kp = load_config(os.path.join(REPO, "configs", "train_kp.yaml"))
    kp.update(epoch=1, epoch_step=1, load_path=os.path.join(tr1.save_root, "001"))
    kp["data_config_train"]["data_path"] = root
    tr2 = Trainer(kp, ckpt_root=str(tmp_path), device="cpu")
    assert tr2.model.config == tr1.model.config and tr2.model.dtype == torch.float32
    for k, v in tr1.model.backbone.state_dict().items():
        assert torch.equal(v, tr2.model.backbone.state_dict()[k]), k
    tr2.train()
    for tr in (tr1, tr2):
        metrics = [json.loads(x) for x in open(os.path.join(tr.save_root, "metrics.jsonl"))]
        assert len(metrics) == 1 and np.isfinite(metrics[0]["total_loss"])
    assert not os.path.exists(os.path.join(tr1.save_root, "vis"))
    for si in range(2):
        for folder in FOLDERS:
            assert os.listdir(os.path.join(tr2.save_root, "vis", f"sample{si}", folder)) == ["1.jpg"]
