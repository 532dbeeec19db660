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
import jax
import jax.numpy as jnp

from posfeat_tpu.ops.coords import denormalize_coords
from posfeat_tpu.ops.detect import generate_kpts_single
from posfeat_tpu.ops.grid_sample import sample_feat_by_coord
from posfeat_tpu_torch.extract import Extractor
from torch_port_helpers import SMALL_CONFIG, jax_posfeat

H, W, NUM_PTS = 64, 96, 128
DET = {"num_pts": NUM_PTS, "stable": True, "use_nms": True, "nms_radius": 1,
       "thr": 0.9, "thr_mod": "abs"}


def _pairs_close(kp_a, sc_a, de_a, kp_b, sc_b, de_b):
    assert kp_a.shape == kp_b.shape and de_a.shape == de_b.shape
    d = np.linalg.norm(kp_a[:, None, :] - kp_b[None, :, :], axis=-1)
    j = d.argmin(axis=1)
    assert len(set(j.tolist())) == len(j), "keypoints pair up one to one"
    assert d[np.arange(len(j)), j].max() < 1e-3
    np.testing.assert_allclose(sc_a, sc_b[j], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(de_a, de_b[j], atol=1e-4)


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
    from posfeat_tpu_torch.core.jax_weights import from_jax_variables

    jmodel, variables = jax_posfeat(seed=7, im_shape=(1, H, W, 3))
    ck = tmp_path / "ck_in"
    jmodel.save_checkpoint(jax.tree.map(jnp.asarray, variables), str(ck))
    for name, sd in from_jax_variables(variables).items():
        torch.save(sd, ck / f"{name}.pth")
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
    import yaml

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


def test_deferred_features_raise(tmp_path):
    for key in ("use_sift", "save_h5", "output_img", "spatial_shard"):
        cfg = _config(tmp_path, key, tmp_path / "none")
        cfg[key] = True
        with pytest.raises(NotImplementedError, match="ROADMAP"):
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
