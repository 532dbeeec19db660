"""Slice D, evaluation, on the CPU: the port's matchers, HPatches harness,
COLMAP helpers and Aachen and ETH pipelines, ``detector_config_query``,
the numpy P6 reader and the bf16 ΔMMA probe, each held against the JAX
package (or OpenCV) on the same inputs, made from numpy seeds.

Tolerances:
  * matchers: index arrays equal; ratios within rtol 1e-5 (the same f32
    product, summed in another order);
  * HPatches: counts and match counts equal, error sums and MMA within
    1e-12 (the same numpy arithmetic on equal matches), equal text;
  * COLMAP: both packages' databases equal table by table, and their
    text outputs equal;
  * npz files: tests/test_torch_extract.py's tolerance (torch_port_helpers
    ``pairs_close``);
  * the probe's fixture: H_1_i equal; pixels differ from the JAX fixture's
    (OpenCV's warp) in 2.0e-5 of the values, by at most 2 levels;
  * the slice as a whole: MMA@1..10 within 0.005 (top-k ties may resolve
    otherwise; the gap measured on this fixture is 0).
"""

import os
import shutil
import sqlite3
import stat
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from posfeat_tpu.evals import aachen as jax_aachen
from posfeat_tpu.evals import colmap_db as jax_cdb
from posfeat_tpu.evals import eth as jax_eth
from posfeat_tpu.evals import hpatches as jax_hp
from posfeat_tpu.ops import matchers as jax_matchers
from posfeat_tpu_torch.data.extraction import _imread_rgb, read_ppm_p6
from posfeat_tpu_torch.evals import aachen, eth
from posfeat_tpu_torch.evals import colmap_db as cdb
from posfeat_tpu_torch.evals import hpatches as hp
from posfeat_tpu_torch.extract import Extractor
from posfeat_tpu_torch.ops import matchers
from test_colmap_pipelines_e2e import FAKE_COLMAP, _make_db, _write_feats
from torch_port_helpers import SMALL_CONFIG, pairs_close, save_both_checkpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import selection_stability_torch as probe  # noqa: E402


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)


# ------------------------------------------------------------------ matchers


def _descriptors():
    """~300×128 against ~280×128 unit descriptors with 120 planted
    near-duplicates at noise levels that put their ratios on both sides of
    0.8 and 0.95."""
    rng = np.random.RandomState(3)
    d1, d2 = _unit(rng.randn(300, 128)), _unit(rng.randn(280, 128))
    src, dst = rng.choice(300, 120, replace=False), rng.choice(280, 120, replace=False)
    noise = rng.uniform(0.02, 0.2, (120, 1))
    d2[dst] = _unit(d1[src] + noise * rng.randn(120, 128))
    return d1, d2


@pytest.mark.parametrize("name, kw", [
    ("mutual_nn_matcher", {}), ("ratio_matcher", {}), ("ratio_matcher", {"ratio": 0.8}),
    ("mutual_nn_ratio_matcher", {}), ("mutual_nn_ratio_matcher", {"ratio": 0.8}), ("mnn_matcher", {}),
])
def test_matchers_match_jax(name, kw):
    d1, d2 = _descriptors()
    want = getattr(jax_matchers, name)(d1, d2, **kw)
    got = getattr(matchers, name)(d1, d2, device="cpu", **kw)
    assert got.dtype == np.int64 and got.ndim == 2 and got.shape[1] == 2
    assert 10 < len(got) < 300, len(got)
    np.testing.assert_array_equal(got, want)
    # tensors in, the same numpy out
    np.testing.assert_array_equal(
        getattr(matchers, name)(torch.from_numpy(d1), torch.from_numpy(d2), device="cpu", **kw), want)


def test_matcher_ratios_match_jax():
    import jax.numpy as jnp

    d1, d2 = _descriptors()
    sim_j = jnp.dot(d1, d2.T, precision="highest")
    sim_t = torch.from_numpy(d1) @ torch.from_numpy(d2).T
    for sj, st in ((sim_j, sim_t), (sim_j.T, sim_t.T)):
        r_j, n_j = jax_matchers._top2_ratio(sj)
        r_t, n_t = matchers._top2_ratio(st)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5)
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


# ------------------------------------------------------------------ HPatches


def _hpatches_features(root, rng, n_seq=4, n=160):
    """An HPatches layout of npz feature files (``<seq>/<i>.ppm.m``) and
    ``H_1_i`` files: image i holds the projections of 100 of image 1's
    keypoints, moved by up to a few pixels, with near-duplicate
    descriptors, plus keypoints of its own."""
    data, feats = root / "data", root / "feats"
    for si in range(n_seq):
        seq = f"{'iv'[si % 2]}_s{si}"
        (data / seq).mkdir(parents=True)
        (feats / seq).mkdir(parents=True)
        kp1, d1 = rng.rand(n, 2) * [640, 480], _unit(rng.randn(n, 32))
        kps, descs = {1: kp1}, {1: d1}
        for i in range(2, 7):
            Hm = np.eye(3) + np.diag([1, 1, 0]) * rng.uniform(-0.1, 0.1) + rng.uniform(-2e-5, 2e-5, (3, 3))
            Hm[:2, 2] = rng.uniform(-20, 20, 2)
            np.savetxt(data / seq / f"H_1_{i}", Hm)
            p = np.concatenate([kp1[:100], np.ones((100, 1))], 1) @ Hm.T
            kp = np.concatenate([p[:, :2] / p[:, 2:] + rng.randn(100, 2) * 3, rng.rand(n - 100, 2) * [640, 480]])
            de = np.concatenate([_unit(d1[:100] + 0.3 * rng.randn(100, 32)), _unit(rng.randn(n - 100, 32))])
            perm = rng.permutation(n)
            kps[i], descs[i] = kp[perm], de[perm]
        for i in kps:
            with open(feats / seq / f"{i}.ppm.m", "wb") as f:
                np.savez(f, keypoints=kps[i].astype(np.float32), scores=np.ones((n, 1), np.float32),
                         descriptors=descs[i])
    return str(data), str(feats)


def _assert_errors_equal(a, b):
    for ea, eb in zip(a[:2], b[:2]):
        assert sorted(ea) == sorted(eb)
        for t in ea:
            assert abs(ea[t] - eb[t]) <= 1e-12, (t, ea[t], eb[t])
    for xa, xb in zip(a[2], b[2]):
        np.testing.assert_array_equal(xa, xb)


def test_hpatches_harness_matches_jax(tmp_path, rng):
    data, feats = _hpatches_features(tmp_path, rng)
    want = jax_hp.benchmark_features(jax_hp.generate_read_function(feats, "m"), data)
    got = hp.benchmark_features(hp.generate_read_function(feats, "m"), data, device="cpu")
    _assert_errors_equal(got, want)
    assert got[2][2].sum() > 200, "the fixture has matches"
    for thr in range(1, 16):
        np.testing.assert_allclose(hp.mma_at(got, thr, 2, 2), jax_hp.mma_at(want, thr, 2, 2), rtol=0, atol=1e-12)
    assert 0.1 < hp.mma_at(got, 3, 2, 2)[0] < 0.9
    np.testing.assert_allclose(hp.mma_score(got, 2, 2), jax_hp.mma_score(want, 2, 2), rtol=0, atol=1e-12)
    assert hp.summary_line("m", got) == jax_hp.summary_line("m", want)
    both = {"port": got, "ref": want}
    assert hp.results_table(both) == jax_hp.results_table(both)


def test_hpatches_cache_is_shared_with_jax(tmp_path, rng):
    data, feats = _hpatches_features(tmp_path, rng, n_seq=2)
    jax_cache, port_cache = str(tmp_path / "cj"), str(tmp_path / "cp")
    want = jax_hp.evaluate_method(data, feats, "m", cache_dir=jax_cache)
    got = hp.evaluate_method(data, feats, "m", cache_dir=port_cache, device="cpu")
    # each package reads the other's cache file (no features behind it)
    _assert_errors_equal(hp.evaluate_method(data, "missing", "m", cache_dir=jax_cache, device="cpu"), want)
    _assert_errors_equal(jax_hp.evaluate_method(data, "missing", "m", cache_dir=port_cache), got)
    _assert_errors_equal(hp.load_reference_cache(f"{jax_cache}/m.npy"), got)


def test_hpatches_cli(tmp_path, rng, capsys):
    data, feats = _hpatches_features(tmp_path, rng, n_seq=2)
    ref = tmp_path / "ref.npy"
    np.save(ref, np.array(jax_hp.benchmark_features(jax_hp.generate_read_function(feats, "m"), data),
                          dtype=object))
    table, plot = tmp_path / "table.txt", tmp_path / "mma.png"
    hp.main(["--dataset_path", data, "--features_path", feats, "--method", "m", "--ref_cache", str(ref),
             "--table", str(table), "--plot", str(plot), "--device", "cpu"])
    out = capsys.readouterr().out
    errors = hp.load_reference_cache(str(ref))
    assert table.read_text() == jax_hp.results_table({"m": errors, "ref": errors}) + "\n"
    assert "MMA@3px (overall/illum/view): {:.4f} / {:.4f} / {:.4f}".format(*hp.mma_at(errors, 3)) in out
    assert plot.stat().st_size > 0


# ---------------------------------------------------------- COLMAP pipelines


@pytest.fixture
def fake_colmap(tmp_path):
    p = tmp_path / "colmap"
    p.write_text(FAKE_COLMAP)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


def _tables(db):
    conn = sqlite3.connect(db)
    cur = conn.cursor()
    names = [r[0] for r in cur.execute("SELECT name FROM sqlite_master WHERE type='table' ORDER BY name;")]
    out = {n: sorted(cur.execute(f"SELECT * FROM {n};").fetchall()) for n in names}
    conn.close()
    return out


def test_colmap_db_helpers_match_jax(tmp_path, rng):
    for a, b in ((1, 2), (2, 1), (3, 7), (2147483646, 5)):
        assert cdb.image_ids_to_pair_id(a, b) == jax_cdb.image_ids_to_pair_id(a, b)
    q, c = rng.randn(4), rng.randn(3)
    np.testing.assert_array_equal(cdb.quaternion_to_rotation_matrix(q), jax_cdb.quaternion_to_rotation_matrix(q))
    np.testing.assert_array_equal(cdb.camera_center_to_translation(c, q), jax_cdb.camera_center_to_translation(c, q))
    names = ["a.jpg", "b.jpg", "c.jpg"]
    _write_feats(str(tmp_path / "f"), names, rng)
    dbs = {}
    for tag, mod in (("jax", jax_cdb), ("port", cdb)):
        db = str(tmp_path / f"{tag}.db")
        _make_db(db, names)
        images, cams = mod.recover_database_images_and_ids(db)
        # the Aachen layout (scale 1, orientation 0 appended), then ETH's two columns
        mod.import_keypoints(db, images, lambda n: str(tmp_path / "f" / (n + ".m")), with_scale_ori=True)
        mod.import_keypoints(db, {"b.jpg": 9}, lambda n: str(tmp_path / "f" / (n + ".m")), with_scale_ori=False)
        conn = sqlite3.connect(db)
        mod.insert_matches(conn.cursor(), 3, 1, np.array([[0, 5], [2, 7]]))
        conn.commit()
        conn.close()
        dbs[tag] = (_tables(db), images, cams)
    assert dbs["port"] == dbs["jax"]


def _aachen_dataset(ds, names):
    (ds / "others").mkdir(parents=True)
    _make_db(str(ds / "others/database.db"), names)
    (ds / "others/image_pairs_to_match.txt").write_text(
        "db/a.jpg db/b.jpg\ndb/a.jpg query/night/x/q.jpg\ndb/b.jpg db/a.jpg\n"
    )
    m3d = ds / "3D-models/aachen_v_1"
    m3d.mkdir(parents=True)
    (m3d / "database_intrinsics.txt").write_text(
        "db/a.jpg SIMPLE_RADIAL 64 64 60 32 32 0\ndb/b.jpg SIMPLE_RADIAL 64 64 60 32 32 0\n"
    )
    (m3d / "aachen_cvpr2018_db.nvm").write_text(
        "NVM_V3\n\n2\n"
        "db/a.jpg 60 1 0 0 0 1.0 2.0 3.0 0 0\n"
        "db/b.jpg 60 0.9 0.1 0.2 0.3 2.0 1.0 0.5 0 0\n"
    )
    (ds / "queries").mkdir()
    (ds / "queries/night_time_queries_with_intrinsics.txt").write_text(
        "query/night/x/q.jpg SIMPLE_RADIAL 64 64 60 32 32 0\n"
    )


def test_aachen_pipeline_matches_jax(tmp_path, fake_colmap, rng):
    names = ["db/a.jpg", "db/b.jpg", "query/night/x/q.jpg"]
    feats = tmp_path / "feats"
    _write_feats(str(feats), names, rng)
    for tag, mod in (("jax", jax_aachen), ("port", aachen)):
        _aachen_dataset(tmp_path / tag, names)
        args = ["--dataset_path", str(tmp_path / tag), "--feature_path", str(feats),
                "--colmap_path", fake_colmap, "--method_name", "m"]
        mod.main(args + (["--device", "cpu"] if tag == "port" else []))
    j, p = tmp_path / "jax", tmp_path / "port"
    got, want = _tables(str(p / "intermedia/m/m.db")), _tables(str(j / "intermedia/m/m.db"))
    assert got == want
    assert len(got["keypoints"]) == 3 and len(got["matches"]) == 2
    for rel in ("intermedia/m/sparse-m-empty/images.txt", "intermedia/m/sparse-m-empty/cameras.txt",
                "results/Aachen_eval_[m].txt"):
        assert (p / rel).read_text() == (j / rel).read_text(), rel
    assert "-1.0 -2.0 -3.0" in (p / "intermedia/m/sparse-m-empty/images.txt").read_text()
    with pytest.raises(FileExistsError):
        aachen.main(["--dataset_path", str(p), "--feature_path", str(feats), "--colmap_path", fake_colmap,
                     "--method_name", "m", "--device", "cpu"])


def test_eth_pipeline_matches_jax(tmp_path, fake_colmap, rng):
    scene, names = "TestScene", ["i0.jpg", "i1.jpg", "i2.jpg", "i3.jpg"]
    scene_dir = tmp_path / "eth" / scene
    (scene_dir / "images").mkdir(parents=True)
    _make_db(str(scene_dir / "database.db"), names)
    _write_feats(str(tmp_path / "feats"), names, rng)
    outs = {}
    for tag, mod, mcfg in (("jax", jax_eth, {"ratio": 0.9}), ("port", eth, {"ratio": 0.9})):
        ckpt_root = tmp_path / f"ckpts_{tag}"
        shutil.copytree(tmp_path / "feats", ckpt_root / "out/desc" / scene)
        cfg = {"output_root": "out", "postfix": "m", "colmap_path": fake_colmap,
               "matcher": "mutual_nn_ratio_matcher", "matcher_config": mcfg,
               "data_config_extract": {"data_path": str(tmp_path / "eth"), "subfolder": scene}}
        cfg_path = tmp_path / f"eth_{tag}.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        mod.main(["--config", str(cfg_path), "--ckpt_root", str(ckpt_root)]
                 + (["--device", "cpu"] if tag == "port" else []))
        desc = ckpt_root / "out/desc"
        outs[tag] = (_tables(str(desc / f"{scene}_m.db")), (desc / f"res_{scene}_m.txt").read_text(),
                     (desc / scene / "image_pairs_m.txt").read_text())
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]["matches"]) == 6 and len(outs["port"][0]["keypoints"]) == 4  # C(4, 2)


# ----------------------------------------------- extraction: Aachen, P6 reads


def test_detector_config_query_matches_jax(tmp_path):
    """Aachen Day-Night query images take detector_config_query (here 160
    points), db images detector_config (128), as in the JAX extractor."""
    from posfeat_tpu.extract import Extractor as JaxExtractor
    from posfeat_tpu_torch.data.synthetic import _texture

    ck = tmp_path / "ck"
    save_both_checkpoints(ck, seed=7, im_shape=(1, 64, 96, 3))
    root = tmp_path / "aachen"
    names = ["db/1.jpg", "db/2.jpg", "query/night/nexus5x/3.jpg", "query/day/milestone/4.jpg"]
    rng = np.random.RandomState(5)
    for name in names:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / name), cv2.cvtColor(_texture(rng, 64, 96), cv2.COLOR_RGB2BGR))
    det = {"stable": True, "use_nms": True, "nms_radius": 1, "thr": False}
    cfg = {
        "postfix": "pf", "load_path": str(ck), "loss_distance": "cos", "output_desc": True,
        "output_img": False, "compute_dtype": "float32", "model": "PoSFeat",
        "model_config": SMALL_CONFIG, "data": "Aachen_Day_Night",
        "data_config_extract": {"data_path": str(root), "batch_size": 2, "workers": 2},
        "use_sift": False, "detector": "generate_kpts_single",
        "detector_config": {"num_pts": 128, **det}, "detector_config_query": {"num_pts": 160, **det},
    }
    JaxExtractor({**cfg, "output_root": "jax"}, ckpt_root=str(tmp_path / "out")).extract()
    ex = Extractor({**cfg, "output_root": "port"}, ckpt_root=str(tmp_path / "out"), device="cpu")
    assert ex.extract()[0] == 4
    for name in names:
        want = np.load(tmp_path / "out/jax/desc" / f"{name}.pf")
        got = np.load(tmp_path / "out/port/desc" / f"{name}.pf")
        assert len(got["keypoints"]) == (160 if name.startswith("query") else 128)
        pairs_close(got["keypoints"], got["scores"][:, 0], got["descriptors"],
                    want["keypoints"], want["scores"][:, 0], want["descriptors"])
    assert ex._det_cfg_key({"name1": "query/day/x/5.jpg"}) == "detector_config_query"
    assert ex._det_cfg_key({"name1": "db/5.jpg"}) == "detector_config"
    ex.config["data"] = "HPatch_SIFT"
    assert ex._det_cfg_key({"name1": "query/day/x/5.jpg"}) == "detector_config"


def test_ppm_reader_matches_opencv(tmp_path):
    rng = np.random.RandomState(2)
    im = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "cv.ppm"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    probe.write_ppm(str(tmp_path / "np.ppm"), im)
    (tmp_path / "comments.ppm").write_bytes(b"P6 # by hand\n53\n# height\n 37 255\n" + im.tobytes())
    for name in ("cv.ppm", "np.ppm", "comments.ppm"):
        got = read_ppm_p6(str(tmp_path / name))
        np.testing.assert_array_equal(got, im)
        np.testing.assert_array_equal(_imread_rgb(str(tmp_path / name)), _rgb(tmp_path / name))
    # every other file goes to OpenCV
    cv2.imwrite(str(tmp_path / "a.png"), im)
    cv2.imwrite(str(tmp_path / "g.pgm"), im[..., 0])
    (tmp_path / "deep.ppm").write_bytes(b"P6\n53 37\n65535\n" + im.astype(">u2").tobytes())
    for name in ("a.png", "g.pgm", "deep.ppm"):
        assert read_ppm_p6(str(tmp_path / name)) is None
    np.testing.assert_array_equal(_imread_rgb(str(tmp_path / "a.png")), im[..., ::-1])
    np.testing.assert_array_equal(_imread_rgb(str(tmp_path / "g.pgm")), np.repeat(im[..., :1], 3, -1))
    (tmp_path / "short.ppm").write_bytes(b"P6\n53 37\n255\n" + im.tobytes()[:-1])
    with pytest.raises(ValueError, match="pixel bytes"):
        read_ppm_p6(str(tmp_path / "short.ppm"))


# ------------------------------------------------------------ the ΔMMA probe


def test_eval_fixture_matches_jax(tmp_path):
    from convergence_experiment import make_eval_fixture as jax_fixture

    jax_fixture(str(tmp_path / "jax"), n_seq=4, h=96, w=128)
    probe.make_eval_fixture(str(tmp_path / "port"), n_seq=4, h=96, w=128)
    seqs = sorted(os.listdir(tmp_path / "jax"))
    assert seqs == sorted(os.listdir(tmp_path / "port")) == ["i_syn0", "i_syn2", "v_syn1", "v_syn3"]
    diffs = []
    for seq in seqs:
        for i in range(1, 7):
            got = read_ppm_p6(str(tmp_path / "port" / seq / f"{i}.ppm"))
            np.testing.assert_array_equal(got, _rgb(tmp_path / "port" / seq / f"{i}.ppm"))
            want = read_ppm_p6(str(tmp_path / "jax" / seq / f"{i}.ppm"))
            np.testing.assert_array_equal(want, _rgb(tmp_path / "jax" / seq / f"{i}.ppm"))
            diffs.append(np.abs(got.astype(np.int32) - want.astype(np.int32)).ravel())
            if i > 1:
                np.testing.assert_array_equal(np.loadtxt(tmp_path / "port" / seq / f"H_1_{i}"),
                                              np.loadtxt(tmp_path / "jax" / seq / f"H_1_{i}"))
    d = np.concatenate(diffs)
    # OpenCV's fixed-point bilinear warp against scipy's float one: a value
    # one level apart where rounding differs, two where gain and gamma
    # stretch that level (measured: 18 of 884,736 values differ, 4 by 2)
    assert (d > 0).mean() <= 1e-4 and (d > 1).mean() <= 1e-5 and d.max() <= 2, (
        (d > 0).mean(), (d > 1).sum(), d.max())


def test_slice_matches_jax(tmp_path):
    """A tiny f32 model with carried weights, extracted and scored by each
    package on the probe's fixture: MMA@1..10 within 0.005."""
    from posfeat_tpu.extract import Extractor as JaxExtractor

    ck = tmp_path / "ck"
    save_both_checkpoints(ck, seed=7, im_shape=(1, 64, 96, 3))
    data = str(tmp_path / "hp")
    probe.make_eval_fixture(data, n_seq=2, h=64, w=96)
    cfg = {
        "postfix": "c", "load_path": str(ck), "loss_distance": "cos", "output_desc": True,
        "output_img": False, "compute_dtype": "float32", "model": "PoSFeat", "model_config": SMALL_CONFIG,
        "data": "HPatch_SIFT", "data_config_extract": {"data_path": data, "batch_size": 4, "workers": 2},
        "use_sift": False, "detector": "generate_kpts_single",
        "detector_config": {"num_pts": 256, "stable": True, "use_nms": True, "nms_radius": 1, "thr": False},
    }
    out = str(tmp_path / "out")
    JaxExtractor({**cfg, "output_root": "jax"}, ckpt_root=out).extract()
    Extractor({**cfg, "output_root": "port"}, ckpt_root=out, device="cpu").extract()
    want = jax_hp.benchmark_features(jax_hp.generate_read_function(f"{out}/jax/desc", "c"), data)
    got = hp.benchmark_features(hp.generate_read_function(f"{out}/port/desc", "c"), data, device="cpu")
    np.testing.assert_array_equal(got[2][1], want[2][1])
    gaps = [abs(hp.mma_at(got, t, 1, 1)[0] - jax_hp.mma_at(want, t, 1, 1)[0]) for t in range(1, 11)]
    assert max(gaps) <= 0.005, gaps
    assert 0.05 < hp.mma_at(got, 10, 1, 1)[0]


def test_trained_probe_smoke(tmp_path):
    """Two steps of each stage, then the three arms at 64x96 on the CPU
    (the fused bf16 arm on K1/K2's plain versions): the record has every
    field, and the f32 arm run twice writes identical npz files."""
    work = str(tmp_path)
    ckpt = probe.train_probe_ckpt(work, 2, 2, device="cpu")
    assert sorted(os.listdir(ckpt)) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
    rec = probe.trained_probe(ckpt, work, num_pts=128, n_seq=2, h=64, w=96, device="cpu")
    fields = {"mma3_f32", "mma3_bf16", "mma3_bf16_plain", "delta_mma3", "delta_mma3_kernels",
              "topk_overlap_mean", "topk_overlap_min", "match_agreement_mean", "topk_overlap_mean_kernels",
              "topk_overlap_min_kernels", "match_agreement_mean_kernels", "launches_f32",
              "launches_bf16_plain", "launches_bf16", "n_images", "num_pts", "bf16_head"}
    assert set(rec) == fields
    assert rec["n_images"] == 12 and rec["num_pts"] == 128 and rec["bf16_head"] == "pallas"
    assert rec["delta_mma3"] == rec["mma3_bf16"] - rec["mma3_f32"]
    assert all(0 <= rec[k] <= 1 for k in fields if k.startswith(("mma3", "topk", "match")))
    # on the CPU no kernel launches: the wrappers run the plain versions
    assert all(v == {"K1": 0, "K2": 0} for k, v in rec.items() if k.startswith("launches"))

    d1 = os.path.join(work, "ckpts", "hp", "f32", "desc")
    d2, mma3, _ = probe.run_arm("f32_again", ckpt, work, os.path.join(work, "hpatches"), "float32", False,
                                128, "cpu")
    files = sorted(os.path.relpath(os.path.join(r, f), d1) for r, _, fs in os.walk(d1) for f in fs)
    assert len(files) == 12
    for rel in files:
        a, b = np.load(os.path.join(d1, rel)), np.load(os.path.join(d2, rel))
        for key in ("keypoints", "scores", "descriptors"):
            np.testing.assert_array_equal(a[key], b[key])
    assert mma3 == rec["mma3_f32"]
    overlaps, agreements = probe.compare_arms(d1, d2, device="cpu")
    assert overlaps == [1.0] * 12 and agreements == [1.0] * 10
