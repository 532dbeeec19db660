"""posfeat_tpu_torch's MegaDepth_SIFT and the rest of its data utilities
against posfeat_tpu's, on a MegaDepth-layout fixture that the test writes
(tools/make_megadepth_fixture.py: 2 scenes x 4 images at 96x128, each
image a textured plane seen through its camera's plane-induced
homography, so that F agrees with the pixels).

The JAX dataset draws each sample from a fresh ``np.random.RandomState()``;
the port's ``sample(item, rng)`` takes its generator. The tests give both
the same stream by handing the JAX module's argument-less call a copy of
the port's generator."""

import os
import sys

import numpy as np
import pytest

from posfeat_tpu.data import megadepth as jax_md
from posfeat_tpu.data import utils as ju
from posfeat_tpu_torch.data import DATASETS
from posfeat_tpu_torch.data import utils as tu
from posfeat_tpu_torch.data.megadepth import MegaDepth_SIFT

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from make_megadepth_fixture import write_megadepth_fixture  # noqa: E402

H, W = 96, 128
CFG = {"prune_kp": False, "num_pts": 32, "random_percent": 0.5, "rot_thr": 80}
EXACT = ("F1", "F2", "pose1", "pose2", "intrinsic1", "intrinsic2", "coord1", "coord2", "im1_ori", "im2_ori")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_megadepth_fixture(str(tmp_path_factory.mktemp("megadepth")), height=H, width=W)


def _jax_sample(monkeypatch, ds, item, seed):
    """JAX's ds[item] with its argument-less RandomState() seeded."""
    orig = np.random.RandomState

    def seeded(seed_arg=None):
        return orig(seed if seed_arg is None else seed_arg)

    with monkeypatch.context() as m:
        m.setattr(np.random, "RandomState", seeded)
        return ds[item]


def _assert_same_sample(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert set(a) == set(b)
    for k in EXACT:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("im1", "im2"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    assert (a["name1"], a["name2"]) == (b["name1"], b["name2"])


@pytest.mark.parametrize("prune_kp, is_train", [(False, True), (True, True), (False, False)],
                         ids=["train", "prune_kp", "not_train"])
def test_megadepth_matches_jax_sample_by_sample(root, monkeypatch, prune_kp, is_train):
    cfg = {**CFG, "data_path": root, "prune_kp": prune_kp}
    port, ref = DATASETS["MegaDepth_SIFT"](cfg, is_train=is_train), jax_md.MegaDepth_SIFT(cfg, is_train=is_train)
    assert len(port) == len(ref) == 12  # 2 scenes x 6 pairs
    assert port.imf1s == ref.imf1s and port.imf2s == ref.imf2s
    n_samples = 0
    for item in range(len(port)):
        a = port.sample(item, np.random.RandomState(100 + item))
        b = _jax_sample(monkeypatch, ref, item, 100 + item)
        _assert_same_sample(a, b)
        n_samples += a is not None
    assert n_samples == len(port)  # no pair of the fixture is filtered out
    if not is_train:  # no jitter: the normalized images are the originals
        np.testing.assert_allclose(a["im1"], tu.normalize_image(a["im1_ori"]), atol=0)
    assert a["coord1"].shape == (cfg["num_pts"], 3) and a["F1"].dtype == np.float32


def test_rot_thr_filter_returns_none(root, monkeypatch):
    """Every fixture pair is rotated by more than 0.1 degrees: both
    packages reject each at train time and keep each at eval time."""
    cfg = {**CFG, "data_path": root, "rot_thr": 0.1}
    port, ref = MegaDepth_SIFT(cfg, is_train=True), jax_md.MegaDepth_SIFT(cfg, is_train=True)
    for item in range(len(port)):
        assert port[item] is None
        assert _jax_sample(monkeypatch, ref, item, 0) is None
    assert MegaDepth_SIFT(cfg, is_train=False)[0] is not None


def test_scan_caps_pairs_per_scene_as_jax(root, tmp_path):
    """A scene with more than 5000 pairs keeps 5000 drawn with
    RandomState(234), and the list is shuffled with it; a folder without
    ``dense`` in its name and comment lines are skipped."""
    import shutil

    big = tmp_path / "big"
    shutil.copytree(root, big)
    aligned = big / "scene1" / "dense0" / "aligned"
    names = [f"{i}.png" for i in range(4)]
    lines = [f"{names[i % 4]} {names[(i // 4) % 4]}" for i in range(5003)]
    (aligned / "pairs.txt").write_text("\n".join(lines) + "\n")
    (big / "scene1" / "sparse").mkdir()
    cfg = {**CFG, "data_path": str(big)}
    port, ref = MegaDepth_SIFT(cfg), jax_md.MegaDepth_SIFT(cfg)
    assert len(port) == len(ref) == 6 + 5000
    assert port.imf1s == ref.imf1s and port.imf2s == ref.imf2s
    assert port.images.keys() == ref.images.keys()
    for k, v in port.images.items():
        np.testing.assert_array_equal(v.rvec, ref.images[k].rvec)
        assert v[:7] == ref.images[k][:7]


def test_per_sample_draws_follow_seed_item_and_visit(root):
    """``ds[item]`` draws from RandomState([seed, item, visit]): the same
    seed reads the same samples, a second read of an item or another seed
    draws anew."""
    cfg = {**CFG, "data_path": root}
    a, b, c = (MegaDepth_SIFT(cfg, seed=s) for s in (3, 3, 4))
    first, again = a[2], a[2]
    np.testing.assert_array_equal(first["coord1"], b[2]["coord1"])
    np.testing.assert_array_equal(first["im1"], a.sample(2, np.random.RandomState([3, 2, 0]))["im1"])
    assert not np.array_equal(first["coord1"], again["coord1"])
    assert not np.array_equal(first["coord1"], c[2]["coord1"])


def _image(seed=0, h=H, w=W):
    from posfeat_tpu_torch.data.synthetic import _texture

    return _texture(np.random.RandomState(seed), h, w)


def _poses(seed=1):
    rng = np.random.RandomState(seed)
    K1 = np.array([[100.0, 0, 64], [0, 110, 48], [0, 0, 1]])
    K2 = np.array([[90.0, 0, 60], [0, 95, 50], [0, 0, 1]])
    E = []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        e = np.eye(4)
        e[:3, :3] = q * np.sign(np.linalg.det(q))
        e[:3, 3] = rng.randn(3)
        E.append(e)
    return K1, K2, E[0], E[1]


def _utility_cases():
    """(id, fn(module) -> result) for each ported utility."""
    K1, K2, E1, E2 = _poses()
    im = _image()
    coords = np.random.RandomState(2).rand(50, 2) * [W - 1, H - 1]
    F, rel = ju.relative_pose_to_fundamental(K1, K2, E1, E2)
    arr2d = np.random.RandomState(3).randn(7, 9)
    return [
        ("relative_pose_to_fundamental", lambda m: m.relative_pose_to_fundamental(K1, K2, E1, E2)),
        ("rotation_angle_deg", lambda m: m.rotation_angle_deg(rel[:3, :3])),
        ("skew", lambda m: m.skew(np.array([1.0, -2.0, 3.0]))),
        ("prune_kpts", lambda m: m.prune_kpts(coords, F, (H, W), K1, K2, rel, 4, 400)),
        ("random_choice_fewer", lambda m: m.random_choice(np.arange(40), 16)),
        ("random_choice_more", lambda m: m.random_choice(np.arange(10), 16)),
        ("sift_keypoints", lambda m: m.sift_keypoints(im)),
        ("sift_keypoints_capped", lambda m: m.sift_keypoints(im, nfeatures=20)),
        ("color_jitter", lambda m: m.color_jitter(im, np.random.RandomState(5))),
        ("rotate_image_0", lambda m: m.rotate_image(im, 0.0)),
        ("rotate_image_30", lambda m: m.rotate_image(im, 30.0)),
        ("rotate_image_180", lambda m: m.rotate_image(im, 180.0)),
        ("rotate_image_minus_45", lambda m: m.rotate_image(im, -45.0)),
        ("perspective_transform", lambda m: m.perspective_transform(im, 0.001, np.random.RandomState(6))),
        ("query_random", lambda m: m.generate_query_kpts(im, "random", 30, H, W, np.random.RandomState(7))),
        ("query_sift", lambda m: m.generate_query_kpts(im, "sift", 30, H, W, np.random.RandomState(7))),
        ("query_mixed", lambda m: m.generate_query_kpts(im, "mixed", 30, H, W, np.random.RandomState(7))),
        ("tensor2array_chw", lambda m: m.tensor2array(np.random.RandomState(8).randn(3, 5, 6))),
        ("tensor2array_hwc", lambda m: m.tensor2array(np.random.RandomState(8).randn(5, 6, 3))),
        ("tensor2array_coolwarm", lambda m: m.tensor2array(arr2d)),
        ("tensor2array_rdylgn", lambda m: m.tensor2array(arr2d, max_value=1.5, colormap="RdYlGn")),
        ("normalize_image", lambda m: m.normalize_image(im)),
        ("crop_mod16", lambda m: m.crop_mod16(im[:90, :120])),
    ]


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name, fn", _utility_cases(), ids=[c[0] for c in _utility_cases()])
def test_data_utility_matches_jax(name, fn, monkeypatch):
    """Each ported utility returns what its JAX original returns, exactly.
    JAX's ``tensor2array`` colours 2-D arrays through matplotlib, which
    neither the test machines nor the card's have: a stub whose
    ``colormaps[name]`` is the port's lookup table stands in for it, so
    these two cases hold the rest of the function."""
    import types

    stub = types.ModuleType("matplotlib")
    stub.colormaps = {k: (lambda x, k=k: tu.apply_colormap(x, k)) for k in tu.COLORMAPS}
    monkeypatch.setitem(sys.modules, "matplotlib", stub)
    got, want = _flat(fn(tu)), _flat(fn(ju))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_colormap_tables():
    """The lookup tables: 256 RGBA entries from the first control point to
    the last, the RdYlGn midpoint ColorBrewer's (255, 255, 191) and
    coolwarm's Moreland's grey; bins as matplotlib indexes them."""
    for name, first, last in (("RdYlGn", (165, 0, 38), (0, 104, 55)),
                              ("coolwarm", (0.2298057, 0.298717966, 0.753683153),
                               (0.705673158, 0.01555616, 0.150232812))):
        lut = tu.COLORMAPS[name]
        scale = 255.0 if name == "RdYlGn" else 1.0
        assert lut.shape == (256, 4) and np.all(lut[:, 3] == 1)
        np.testing.assert_allclose(lut[0, :3] * scale, first, atol=1e-9)
        np.testing.assert_allclose(lut[-1, :3] * scale, last, atol=1e-9)
    mid = tu.apply_colormap(np.array([0.5]), "RdYlGn")[0, :3] * 255
    np.testing.assert_allclose(mid, (255, 255, 191), atol=1.5)
    x = np.array([-1.0, 0.0, 1 / 256 - 1e-9, 1 / 256, 0.999, 1.0, 2.0])
    idx = [np.flatnonzero((tu.COLORMAPS["coolwarm"] == c).all(1))[0]
           for c in tu.apply_colormap(x, "coolwarm")]
    assert idx == [0, 0, 0, 1, 255, 255, 255]
    with pytest.raises(KeyError):
        tu.apply_colormap(x, "viridis")
