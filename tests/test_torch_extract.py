"""The extraction slice as a whole, f32 on the CPU: the JAX extraction
program (as bench.build_extract composes it) against the port's device
program, then both Extractors end to end on one .ppm.

Tolerances: equal valid_count, coordinates within 1e-3 px, scores
within rtol 1e-3, descriptors within atol 1e-4. Slots are paired by
nearest keypoint, so two near-equal scores that swap places in the
top-k do not fail the test, while a missing or moved keypoint does.
"""

import copy

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from posfeat_tpu.ops.coords import denormalize_coords
from posfeat_tpu.ops.detect import generate_kpts_single
from posfeat_tpu.ops.grid_sample import sample_feat_by_coord
from posfeat_tpu_torch.extract import Extractor
from torch_port_helpers import SMALL_CONFIG, pairs_close as _pairs_close, save_both_checkpoints

H, W, NUM_PTS = 64, 96, 128
DET = {"num_pts": NUM_PTS, "stable": True, "use_nms": True, "nms_radius": 1,
       "thr": 0.9, "thr_mod": "abs"}


def _config(tmp_path, tag, load_path):
    return {
        "output_root": f"ex_{tag}",
        "postfix": "pf",
        "load_path": str(load_path),
        "loss_distance": "cos",
        "output_desc": True,
        "output_img": False,
        "compute_dtype": "float32",
        "model": "PoSFeat",
        "model_config": copy.deepcopy(SMALL_CONFIG),
        "data": "HPatch_SIFT",
        "data_config_extract": {"data_path": str(tmp_path / "hp"), "batch_size": 2, "workers": 2},
        "use_sift": False,
        "detector": "generate_kpts_single",
        "detector_config": dict(DET),
    }


@pytest.fixture
def weights(tmp_path):
    """One set of random weights saved in both checkpoint formats."""
    ck = tmp_path / "ck_in"
    jmodel, variables = save_both_checkpoints(ck, seed=7, im_shape=(1, H, W, 3))
    return jmodel, variables, ck


def test_device_program_matches_jax(tmp_path, rng, weights):
    jmodel, variables, ck = weights
    ims = (rng.rand(2, H, W, 3) * 255).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def jax_program(v, im_u8):
        im = (im_u8.astype(jnp.float32) / 255.0 - mean) / std
        outputs = jmodel.extract(v, im, train=False)
        coord_n, score, valid = generate_kpts_single(outputs["local_point"], **DET)
        feat = sample_feat_by_coord(outputs["local_map"], coord_n, norm=True)
        return denormalize_coords(coord_n, H, W), score, feat, valid

    ref = jax.jit(jax_program)(jax.tree.map(jnp.asarray, variables), jnp.asarray(ims))
    ex = Extractor(_config(tmp_path, "prog", ck), ckpt_root=str(tmp_path / "out"),
                   device="cpu", dataset=[])
    got = ex._learned_fn((H, W), "detector_config")(torch.from_numpy(ims))
    coords, score, feat, valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    for j in range(2):
        _pairs_close(coords[j], score[j], feat[j],
                     np.asarray(ref[0][j]), np.asarray(ref[1][j]), np.asarray(ref[2][j]))


def test_extractors_write_matching_npz(tmp_path, rng, weights, monkeypatch):
    import cv2

    from posfeat_tpu.data.synthetic import _texture
    from posfeat_tpu.extract import Extractor as JaxExtractor
    from posfeat_tpu_torch.extract.__main__ import main

    _, _, ck = weights
    seq = tmp_path / "hp" / "i_x"
    seq.mkdir(parents=True)
    im = _texture(rng, H + 5, W + 7)  # the datasets crop to multiples of 16
    cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))

    JaxExtractor(_config(tmp_path, "jax", ck), ckpt_root=str(tmp_path / "out")).extract()
    # the port through its CLI; ckpt_root defaults to ./ckpts
    cfg_path = tmp_path / "port.yaml"
    cfg_path.write_text(yaml.safe_dump(_config(tmp_path, "port", ck)))
    monkeypatch.chdir(tmp_path)
    main(["--config", str(cfg_path), "--device", "cpu"])

    ref = np.load(tmp_path / "out" / "ex_jax" / "desc" / "i_x" / "1.ppm.pf")
    got = np.load(tmp_path / "ckpts" / "ex_port" / "desc" / "i_x" / "1.ppm.pf")
    for key in ("keypoints", "scores", "descriptors"):
        assert got[key].dtype == np.float32, key
    assert got["keypoints"].shape == ref["keypoints"].shape
    _pairs_close(got["keypoints"], got["scores"][:, 0], got["descriptors"],
                 ref["keypoints"], ref["scores"][:, 0], ref["descriptors"])
    names = (tmp_path / "ckpts" / "ex_port" / "image" / "name_list.txt").read_text()
    assert names == "0 i_x/1.ppm\n"
    # a second run into the same output fails fast unless resume: True
    with pytest.raises(FileExistsError):
        main(["--config", str(cfg_path), "--device", "cpu"])
    cfg = _config(tmp_path, "port", ck)
    cfg["resume"] = True
    Extractor(cfg, device="cpu")


def test_deferred_features_raise(tmp_path, rng, monkeypatch):
    """spatial_shard resolves its device count as JAX does: on one device
    (the CPU) ``True`` and ``auto`` run every image unsharded, equal to the
    plain run; over more devices it is not ported and raises."""
    # use_sift, save_h5 and output_img are ported (tests/test_torch_extract_remainders.py)
    import cv2

    from posfeat_tpu.data.synthetic import _texture
    from posfeat_tpu_torch.extract import extractor as ex_mod

    seq = tmp_path / "hp" / "i_x"
    seq.mkdir(parents=True)
    cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(_texture(rng, H, W), cv2.COLOR_RGB2BGR))
    files = {}
    for sp in (False, True, "auto"):
        cfg = _config(tmp_path, f"sp_{sp}", tmp_path / "none")
        cfg["spatial_shard"] = sp
        ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
        assert ex.extract()[0] == 1
        files[sp] = np.load(f"{ex.desc_root}/i_x/1.ppm.pf")
    for sp in (True, "auto"):
        for key in ("keypoints", "scores", "descriptors"):
            np.testing.assert_array_equal(files[sp][key], files[False][key], err_msg=f"{sp} {key}")
    monkeypatch.setattr(ex_mod, "_visible_devices", lambda device: 2)
    for sp in (True, "auto", 2):
        cfg = _config(tmp_path, f"sp2_{sp}", tmp_path / "none")
        cfg["spatial_shard"] = sp
        with pytest.raises(NotImplementedError, match="ROADMAP.md: spatial_shard over more than one device"):
            Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])


def test_bf16_selects_fused_head_only_on_the_card(tmp_path):
    cfg = _config(tmp_path, "bf16", tmp_path / "none")
    cfg["compute_dtype"] = "bfloat16"
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    assert "fused_upsample" not in ex.config["model_config"]["localheader_config"]
    cfg["head_dataflow"] = "pallas"
    cfg["output_root"] = "ex_bf16_pallas"
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    assert ex.config["model_config"]["localheader_config"]["fused_upsample"] == "pallas"
    assert "fused_upsample" not in cfg["model_config"]["localheader_config"]


def test_extractor_checks_the_head_dataflow_first(tmp_path, monkeypatch):
    """Extractor applies the head's dataflow rule to the resolved
    dataflow, dtype and device before it writes anything."""
    from posfeat_tpu_torch.extract import extractor as ex_mod

    seen = []

    class Refused(Exception):
        pass

    def rule(*args):
        seen.append(args)
        raise Refused

    monkeypatch.setattr(ex_mod, "check_head_dataflow", rule)
    cfg = _config(tmp_path, "refused", tmp_path / "none")
    cfg["head_dataflow"] = "pallas"
    with pytest.raises(Refused):
        Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    assert seen == [("pallas", torch.float32, "cpu")]
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize(
    "dataflow, mode", [("pallas", "v1"), ("phase", None), ("always", None), (False, None)]
)
def test_head_choice_reaches_the_model_and_config_yaml(tmp_path, dataflow, mode):
    """head_dataflow (any KeypointDet dataflow) and head_mode (the fused
    head's v3/v1) land in localheader_config, in the model and in the
    run's config.yaml; the caller's dict is left unchanged."""
    cfg = _config(tmp_path, f"head_{dataflow}", tmp_path / "none")
    cfg["head_dataflow"] = dataflow
    if mode is not None:
        cfg["head_mode"] = mode
    before = copy.deepcopy(cfg)
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    assert cfg == before
    head = ex.model.localheader
    assert head.fused_upsample == dataflow and head.fused_head_mode == (mode or "v3")
    saved = yaml.safe_load((tmp_path / "out" / cfg["output_root"] / "config.yaml").read_text())
    lh = saved["model_config"]["localheader_config"]
    assert lh["fused_upsample"] == dataflow
    assert lh.get("fused_head_mode") == mode
