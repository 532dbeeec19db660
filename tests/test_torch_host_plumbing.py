"""posfeat_tpu_torch's host plumbing on the CPU: the native preprocessing
binding (against numpy and the JAX package's binding, within
tests/test_native_preproc.py's rtol 1e-5 / atol 1e-6, and its numpy
fallback), ``trace``, the trainer's
``profile_trace_dir`` and TensorBoard events, ``save_npz: False``, and
``spatial_shard`` on one device."""

import glob
import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch

from posfeat_tpu.data import native as jax_native
from posfeat_tpu.data.synthetic import _texture
from posfeat_tpu_torch.core.profiling import trace
from posfeat_tpu_torch.data import native
from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
from posfeat_tpu_torch.extract import Extractor
from posfeat_tpu_torch.train import Trainer
from test_torch_extract import H, W, _config
from test_torch_train import _config as _train_config


def test_native_normalize_matches_numpy_and_jax(rng):
    assert native.native_available()  # g++ is on this machine: the library is live
    assert native.library_path().parent.name == "torch_kernels"
    im = (rng.rand(67, 93, 3) * 255).astype(np.uint8)
    out = native.normalize_crop16(im)
    ref = (im[:64, :80].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    assert out.shape == (64, 80, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, jax_native.normalize_crop16(im), rtol=1e-5, atol=1e-6)


def test_native_first_calls_from_many_threads(rng, tmp_path, monkeypatch):
    """The loaders' threads make the first calls together: one builds the
    library, every call runs it (no half-written file, no fallback)."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    builds = []
    run = native.subprocess.run

    def counted(*args, **kw):
        builds.append(args[0])
        return run(*args, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted)
    native._load_library.cache_clear()
    try:
        ims = [(rng.rand(48 + 16 * i, 64, 3) * 255).astype(np.uint8) for i in range(16)]
        with ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(native.normalize_crop16, ims))
        assert native.native_available() and len(builds) == 1
        assert [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().name]
        for im, out in zip(ims, outs):
            ref = (im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    finally:
        native._load_library.cache_clear()


def test_native_fallback_is_numpy_with_one_warning(rng, monkeypatch, caplog):
    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "build", no_compiler)
    native._load_library.cache_clear()
    try:
        im = (rng.rand(40, 50, 3) * 255).astype(np.uint8)
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert not native.native_available()
            out = [native.normalize_crop16(im) for _ in range(2)]
        assert [r.levelname for r in caplog.records] == ["WARNING"]
        assert "numpy" in caplog.records[0].getMessage()
        ref = (im[:32, :48].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        for o in out:
            np.testing.assert_array_equal(o, ref)
    finally:
        native._load_library.cache_clear()


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "tr"), "cpu"):
        (x @ x).sum()
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    assert any("aten::mm" in e.get("name", "") for e in json.load(open(files[0]))["traceEvents"])


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """Three logged stage-2 steps with profile_trace_dir and tb_component."""
    tmp = tmp_path_factory.mktemp("tb")
    cfg = _train_config(checkpoint_name="tb", epoch_step=3, profile_trace_dir=str(tmp / "trace"),
                        tb_component=["reinforce", "n_pairs"])
    tr = Trainer(cfg, ckpt_root=str(tmp), device="cpu")
    tr.train()
    return tr, tmp


def test_profile_trace_dir_writes_a_trace(traced_run):
    tr, tmp = traced_run
    files = glob.glob(str(tmp / "trace" / "*.pt.trace.json"))
    assert len(files) == 1  # one trace, closed after step 3
    names = {e.get("name", "") for e in json.load(open(files[0]))["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)


def test_tensorboard_events_hold_the_logged_scalars(traced_run):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tr, tmp = traced_run
    ea = EventAccumulator(tr.save_root)
    ea.Reload()
    tags = set(ea.Tags()["scalars"])
    assert {"total_loss", "reinforce", "n_pairs", "grad_norm/localheader", "sec_per_step"} <= tags
    recs = [json.loads(x) for x in open(tr.metrics_path)]
    assert [e.step for e in ea.Scalars("reinforce")] == [r["global_step"] for r in recs] == [1, 2, 3]
    np.testing.assert_allclose([e.value for e in ea.Scalars("reinforce")], [r["reinforce"] for r in recs],
                               rtol=1e-6)


def _one_image(root, rng):
    seq = root / "hp" / "i_x"
    seq.mkdir(parents=True)
    cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(_texture(rng, H, W), cv2.COLOR_RGB2BGR))


def test_save_npz_false_writes_no_npz(tmp_path, rng):
    _one_image(tmp_path, rng)
    cfg = _config(tmp_path, "nonpz", tmp_path / "none")
    cfg["save_npz"] = False
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
    assert ex.extract()[0] == 1
    assert not glob.glob(f"{ex.desc_root}/**/*.pf", recursive=True)
    assert (tmp_path / "out" / "ex_nonpz" / "image" / "name_list.txt").read_text() == "0 i_x/1.ppm\n"
    h5py = pytest.importorskip("h5py")
    cfg.update(save_h5=True, output_root="ex_nonpz_h5")
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
    assert ex.extract()[0] == 1
    assert not glob.glob(f"{ex.desc_root}/**/*.pf", recursive=True)
    h5_root = ex.desc_root + "h5"
    assert sorted(os.listdir(f"{h5_root}/i_x")) == ["descriptors.h5", "keypoints.h5", "scales.h5", "scores.h5"]
    with h5py.File(f"{h5_root}/feat.h5", "r") as f:
        assert f["i_x/1.ppm/keypoints"].shape[0] >= 128


def test_spatial_shard_on_one_device_runs_unsharded(tmp_path, rng):
    """A device count above the CPU's one resolves to one device (JAX's
    min(sp, devices)); the run says so and reads spatial_threshold_px."""
    _one_image(tmp_path, rng)
    out = {}
    for tag, extra in (("plain", {}), ("sp4", {"spatial_shard": 4, "spatial_threshold_px": 1000})):
        cfg = {**_config(tmp_path, tag, tmp_path / "none"), **extra}
        ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
        ex.extract()
        out[tag] = np.load(f"{ex.desc_root}/i_x/1.ppm.pf")
    assert ex.spatial_threshold == 1000
    log = (tmp_path / "out" / "ex_sp4" / "logging_file.txt").read_text()
    assert "spatial_shard: one device, so every image runs unsharded" in log
    for key in ("keypoints", "scores", "descriptors"):
        np.testing.assert_array_equal(out["sp4"][key], out["plain"][key])
