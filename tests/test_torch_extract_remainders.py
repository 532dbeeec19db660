"""Extraction's remainders against the JAX package's Extractor, f32 on the
CPU: the sub-pixel refiners through the device program and through the
whole Extractor (``refine: quad``), the SIFT passthrough (``use_sift``),
the h5 writers (``save_h5``) and the image dumps (``output_img``).

Tolerances: the device programs and the learned npz as the avg3 path's
(tests/test_torch_extract.py: keypoints within 1e-3 px, scores rtol 1e-3,
descriptors atol 1e-4). Rows are paired slot by slot, and a row that
differs is paired with another free row within all three tolerances (two
near-equal scores may swap places in the top-k); nearest-keypoint pairing
does not apply, since 'quad5' may move two NMS winners 2 px apart onto
one peak. The SIFT passthrough
with the same points and descriptors within 1e-5; the h5 files with the
same datasets, shapes and dtypes, the values as their npz's.
"""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.ops.coords import denormalize_coords
from posfeat_tpu.ops.detect import generate_kpts_single
from posfeat_tpu.ops.grid_sample import sample_feat_by_coord
from posfeat_tpu_torch.extract import Extractor
from test_torch_extract import DET, H, W, _config
from torch_port_helpers import save_both_checkpoints


def _slates_close(kp_a, sc_a, de_a, kp_b, sc_b, de_b):
    assert kp_a.shape == kp_b.shape and de_a.shape == de_b.shape
    n = len(kp_a)

    def ok(i, j):
        return (np.abs(kp_a[i] - kp_b[j]).max() < 1e-3
                and np.allclose(sc_a[i], sc_b[j], rtol=1e-3, atol=1e-6)
                and np.abs(de_a[i] - de_b[j]).max() < 1e-4)

    free = set(range(n))
    for i in range(n):
        j = i if i in free and ok(i, i) else next((j for j in sorted(free) if ok(i, j)), None)
        assert j is not None, f"row {i} ({kp_a[i]}, {sc_a[i]}) has no counterpart"
        free.discard(j)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ck")
    jmodel, variables = save_both_checkpoints(ck, seed=7, im_shape=(1, H, W, 3))
    return jmodel, variables, ck


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """Two HPatches-layout sequences of one textured .ppm each."""
    from posfeat_tpu.data.synthetic import _texture

    root = tmp_path_factory.mktemp("hp")
    rng = np.random.RandomState(3)
    for seq in ("i_x", "v_y"):
        (root / seq).mkdir()
        im = _texture(rng, H + 5, W + 7)  # cropped to multiples of 16
        cv2.imwrite(str(root / seq / "1.ppm"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    return root


def _cfg(tmp_path, fixture_dir, tag, ck, **extra):
    cfg = _config(tmp_path, tag, ck)
    cfg["data_config_extract"]["data_path"] = str(fixture_dir)
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("refine", ["quad", "quad5", "soft", "soft5"])
def test_device_program_refiners_match_jax(tmp_path, weights, refine):
    jmodel, variables, ck = weights
    det = dict(DET, refine=refine, refine_temperature=15.0)
    ims = (np.random.RandomState(1).rand(2, H, W, 3) * 255).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def jax_program(v, im_u8):
        im = (im_u8.astype(jnp.float32) / 255.0 - mean) / std
        outputs = jmodel.extract(v, im, train=False)
        coord_n, score, valid = generate_kpts_single(outputs["local_point"], **det)
        feat = sample_feat_by_coord(outputs["local_map"], coord_n, norm=True)
        return denormalize_coords(coord_n, H, W), score, feat, valid

    ref = jax.jit(jax_program)(jax.tree.map(jnp.asarray, variables), jnp.asarray(ims))
    cfg = _config(tmp_path, refine, ck)
    cfg["detector_config"] = dict(det, scale=4)  # scale is the only key the extractor strips
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    got = [t.numpy() for t in ex._learned_fn((H, W), "detector_config")(torch.from_numpy(ims))]
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]))
    for j in range(2):
        _slates_close(got[0][j], got[1][j], got[2][j], *(np.asarray(r[j]) for r in ref[:3]))


def _h5_tree(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, np.array(v)) if isinstance(v, h5py.Dataset) else None)
    return out


def _run_both(tmp_path, fixture_dir, ck, tag, **extra):
    from posfeat_tpu.extract import Extractor as JaxExtractor

    jcfg = _cfg(tmp_path, fixture_dir, f"{tag}_jax", ck, **extra)
    JaxExtractor(jcfg, ckpt_root=str(tmp_path / "out")).extract()
    pex = Extractor(_cfg(tmp_path, fixture_dir, f"{tag}_port", ck, **extra), ckpt_root=str(tmp_path / "out"),
                    device="cpu")
    pex.extract()
    return tmp_path / "out" / f"ex_{tag}_jax", tmp_path / "out" / f"ex_{tag}_port"


def test_refine_quad_with_h5_and_images_matches_jax(tmp_path, weights, fixture_dir):
    """refine: quad through both Extractors, with save_h5 and output_img."""
    _, _, ck = weights
    det = dict(DET, refine="quad")
    jroot, proot = _run_both(tmp_path, fixture_dir, ck, "quad", detector_config=det, save_h5=True,
                             output_img=True)
    for seq in ("i_x", "v_y"):
        ref = np.load(jroot / "desc" / seq / "1.ppm.pf")
        got = np.load(proot / "desc" / seq / "1.ppm.pf")
        assert got["keypoints"].shape == ref["keypoints"].shape
        _slates_close(got["keypoints"], got["scores"][:, 0], got["descriptors"],
                      ref["keypoints"], ref["scores"][:, 0], ref["descriptors"])
        # the four per-sequence h5 files hold the npz's arrays under the image's base name
        for fname, key in (("keypoints", "keypoints"), ("descriptors", "descriptors"), ("scores", "scores")):
            t_got = _h5_tree(proot / "desch5" / seq / f"{fname}.h5")
            t_ref = _h5_tree(jroot / "desch5" / seq / f"{fname}.h5")
            assert set(t_got) == set(t_ref) == {"1"}
            assert t_got["1"].dtype == t_ref["1"].dtype and t_got["1"].shape == t_ref["1"].shape
            np.testing.assert_array_equal(t_got["1"], got[key])
        np.testing.assert_array_equal(_h5_tree(proot / "desch5" / seq / "scales.h5")["1"],
                                      np.ones_like(got["scores"]))
    fg, fr = _h5_tree(proot / "desch5" / "feat.h5"), _h5_tree(jroot / "desch5" / "feat.h5")
    assert set(fg) == set(fr)
    for k in fg:
        assert fg[k].dtype == fr[k].dtype and fg[k].shape == fr[k].shape, k
    np.testing.assert_array_equal(fg["i_x/1.ppm/image_size"], [W, H])
    # the image dumps: the same files in both runs
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root / "image")
                                for d, _, fs in os.walk(root / "image") for f in fs)
    assert files(proot) == files(jroot)
    assert "i_x/1_score_map.jpg" in files(proot) and "v_y/1_image_with_kp.jpg" in files(proot)
    assert cv2.imread(str(proot / "image" / "i_x" / "1_score_map.jpg")).shape == (H, W, 3)


def test_sift_passthrough_matches_jax(tmp_path, weights, fixture_dir):
    """use_sift: the host's SIFT keypoints and descriptors sampled at them,
    unit scores, the same as the JAX Extractor's."""
    _, _, ck = weights
    jroot, proot = _run_both(tmp_path, fixture_dir, ck, "sift", use_sift=True)
    for seq in ("i_x", "v_y"):
        ref = np.load(jroot / "desc" / seq / "1.ppm.pf")
        got = np.load(proot / "desc" / seq / "1.ppm.pf")
        assert got["keypoints"].shape[0] > 10
        for key in ("keypoints", "scores", "descriptors"):
            assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got["keypoints"], ref["keypoints"])
        np.testing.assert_array_equal(got["scores"], np.ones((len(got["keypoints"]), 1), np.float32))
        np.testing.assert_allclose(got["descriptors"], ref["descriptors"], atol=1e-5)


def test_save_h5_without_h5py_names_the_option(tmp_path, weights, monkeypatch):
    _, _, ck = weights
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    with pytest.raises(ImportError, match="save_h5"):
        Extractor(_config(tmp_path, "noh5", ck) | {"save_h5": True}, ckpt_root=str(tmp_path / "out"),
                  device="cpu", dataset=[])
    assert not (tmp_path / "out" / "ex_noh5").exists()
