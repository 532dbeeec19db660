"""Slice N of posfeat_tpu_torch on the CPU, against the JAX package:

- the banded detector under the packed top-k and the banded "pair"
  sampler on one score map and one local map (no model) against JAX's
  ``generate_kpts_single`` under POSFEAT_TOPK=approx and
  ``sample_feat_by_coord`` under POSFEAT_SAMPLE_IMPL=pair, at
  tests/test_spatial.py:92-106's tolerances (coordinates rtol 1e-4,
  scores 1e-3, descriptors 1e-3 / 1e-4), valid_count equal;
- an Extractor over two bands (two CPU devices) with ``fast_gates:
  {topk: approx, sample_impl: pair}`` against the unsharded one with the
  same gates, and the gates in its config.yaml;
- ``fused_head_tail(img_stats="xla")`` (plain versions) against JAX's
  interpret-mode head with the same kwargs, and the port's default head
  against JAX's ``triple=True`` head, each also against the reference
  tail (rtol 2e-3 / atol 2e-4, tests/test_pallas_fused_head.py:97), gram against xla within
  tests/test_pallas_fused_head.py:211-227's limits, and the refusals;
- ``save_h5`` from two processes appending at once through the locked
  writer, and an Extractor run of two shards, each against one process's
  h5 files key for key.
"""

import json
import multiprocessing
import types

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.extract import Extractor
from posfeat_tpu_torch.extract import extractor as ex_mod
from posfeat_tpu_torch.ops import fused_head as fh
from posfeat_tpu_torch.parallel import banded_detect
from test_torch_extract import DET, H, W, _config
from test_torch_fused_head import ATOL, RTOL, _img_branch_np, _setup
from test_torch_spatial import LAYOUTS, _bands, _ordered

GATES = {"topk": "approx", "sample_impl": "pair"}


def test_banded_lite_gates_match_jax(monkeypatch):
    import jax.numpy as jnp
    from posfeat_tpu.ops.detect import generate_kpts_single as jax_detect
    from posfeat_tpu.ops.grid_sample import sample_feat_by_coord as jax_sample

    rs = np.random.RandomState(5)
    blocks = LAYOUTS["3"]
    Hm = 16 * sum(blocks)
    kp = rs.rand(1, Hm, 96, 1).astype(np.float32)
    fmap = rs.randn(1, Hm // 4, 24, 16).astype(np.float32)
    det = dict(num_pts=512, nms_radius=3, use_nms=True, thr=1.0, thr_mod="mean")
    monkeypatch.setenv("POSFEAT_TOPK", "approx")
    monkeypatch.setenv("POSFEAT_SAMPLE_IMPL", "pair")
    j_coord, j_score, j_valid = jax_detect(jnp.asarray(kp), **det)
    j_feat = jax_sample(jnp.asarray(fmap), j_coord, norm=True)

    coord, score, valid = banded_detect.detect(_bands(torch.from_numpy(kp), blocks), topk="approx", **det)
    feat = banded_detect.sample_feat_by_coord(_bands(torch.from_numpy(fmap), blocks, 4), coord, True, "pair")
    assert int(valid[0]) == int(np.asarray(j_valid)[0])
    n = int(valid[0])  # the slots past valid_count are zero-score pads in either order
    c1, s1, f1 = _ordered(coord[:, :n], score[:, :n], feat[:, :n])
    c2, s2, f2 = _ordered(np.asarray(j_coord)[:, :n], np.asarray(j_score)[:, :n], np.asarray(j_feat)[:, :n])
    np.testing.assert_allclose(c1, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1, s2, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(f1, f2, rtol=1e-3, atol=1e-4)


def _write_image(tmp_path, seed, name="i_x/1.ppm", shape=(H, W)):
    import cv2

    from posfeat_tpu.data.synthetic import _texture

    path = tmp_path / "hp" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(_texture(np.random.RandomState(seed), *shape), cv2.COLOR_RGB2BGR))


def test_banded_extractor_takes_the_fast_gates(tmp_path, monkeypatch):
    """Over two bands the Extractor writes the unsharded npz of the same
    gates (tests/test_spatial.py:92-106's tolerances, after pairing by
    position) and records the gates under fast_gates_banded."""
    _write_image(tmp_path, 0)

    def run(tag, **extra):
        cfg = {**_config(tmp_path, tag, tmp_path / "none"), "fast_gates": dict(GATES), **extra}
        ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
        assert ex.extract()[0] == 1
        return ex, np.load(f"{ex.desc_root}/i_x/1.ppm.pf")

    _, plain = run("plain")
    monkeypatch.setattr(ex_mod, "_visible_devices", lambda device: 2)
    taken = []  # the gates the banded detector and sampler are called with
    detect, sample = banded_detect.detect, banded_detect.sample_feat_by_coord
    monkeypatch.setattr(banded_detect, "detect", lambda *a, **k: taken.append(k["topk"]) or detect(*a, **k))
    monkeypatch.setattr(banded_detect, "sample_feat_by_coord", lambda *a: taken.append(a[3]) or sample(*a))
    ex, got = run("banded", spatial_shard=2, spatial_threshold_px=H * W - 1)
    assert ("spatial", (H, W), "detector_config") in ex._programs and taken == ["approx", "pair"]
    saved = json.load(open(tmp_path / "out" / "ex_banded" / "config.yaml"))
    assert saved["fast_gates_banded"] == {"head_ring": None, "head_im2col": None, **GATES}
    assert saved["fast_gates"]["topk"] == "approx" and saved["fast_gates"]["sample_impl"] == "pair"
    assert "the banded program takes the 'approx' top-k and 'pair' sampling" in (
        tmp_path / "out" / "ex_banded" / "logging_file.txt").read_text()
    assert got["keypoints"].shape == plain["keypoints"].shape
    ia = np.lexsort((got["keypoints"][:, 1], got["keypoints"][:, 0]))
    ib = np.lexsort((plain["keypoints"][:, 1], plain["keypoints"][:, 0]))
    np.testing.assert_allclose(got["keypoints"][ia], plain["keypoints"][ib], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["scores"][ia], plain["scores"][ib], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["descriptors"][ia], plain["descriptors"][ib], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("jax_kw,kw", [({"triple": True}, {}), ({"img_stats": "xla"}, {"img_stats": "xla"})],
                         ids=["triple", "xla"])
def test_head_options_match_pallas_interpret(rng, monkeypatch, jax_kw, kw):
    """JAX's head with ``jax_kw`` against the port's with ``kw``: the port
    has no ``triple`` (K1's one accumulator already sums what the tripled
    layout sums), so JAX's triple=True head is held against its default."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.fused_head import fused_head_tail as jax_fused_head_tail
    from test_pallas_fused_head import reference_tail

    monkeypatch.setenv("POSFEAT_HEAD_MODE", "v3")
    monkeypatch.delenv("POSFEAT_HEAD_IM2COL", raising=False)
    args = _setup(rng)
    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = args
    y, mu, ia = _img_branch_np(s, k1, b1)
    ops = (trunk, s, y, mu, ia, k1, b1, k2t, k2i, b2, w3, b3, a)
    jax_got = np.asarray(jax_fused_head_tail(*map(jnp.asarray, ops), act="Softplus", interpret=True, **jax_kw))
    ref = np.asarray(reference_tail(*map(jnp.asarray, args), act="Softplus"))
    port_ops = (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)
    got = fh.fused_head_tail(*(torch.from_numpy(np.array(o)) for o in port_ops), act="Softplus", **kw).numpy()
    assert got.shape == ref.shape == jax_got.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jax_got, rtol=RTOL, atol=ATOL)


def test_gram_stats_match_xla_stats_and_refusals(rng):
    """The port's two convimg statistics within JAX's limits of each other
    (2e-4 of mean|score| in f32, 2e-2 in bf16); img_stats='xla' without
    img_y and an unknown img_stats raise."""
    for dt, rtol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = (
            torch.from_numpy(np.array(o)) for o in _setup(rng, B=2, h=16, w=24, cin=24, cy=16, cout=32, out=2))
        y = torch.from_numpy(_img_branch_np(s.numpy(), k1.numpy(), b1.numpy())[0])
        low = lambda t: t.to(dt) if t.ndim >= 3 else t  # noqa: E731  (the JAX test's cast)
        ops = [low(t) for t in (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)]
        got_g = fh.fused_head_tail(*ops, act="Softplus", img_stats="gram")
        got_x = fh.fused_head_tail(*ops, act="Softplus", img_stats="xla")
        scale = got_x.abs().mean().item()
        assert (got_g - got_x).abs().max().item() < rtol * scale, dt
    with pytest.raises(ValueError, match="img_stats='xla'"):
        fh.fused_head_tail(*ops[:2], None, *ops[3:], act="Softplus", ring=False, img_stats="xla")
    with pytest.raises(ValueError, match="img_stats must be one of"):
        fh.fused_head_tail(*ops, act="Softplus", img_stats="patch")


def _writer(root):
    """The Extractor's writer on its own: save_desc with h5 on, no model."""
    return types.SimpleNamespace(config={}, desc_root=str(root / "desc"), save_npz=False, save_h5=True)


def _slates(n):
    rs = np.random.RandomState(11)
    names = [f"{('i_a', 'v_b')[j % 2]}/{j}.ppm" for j in range(n)]
    return [({"name1": name, "im1_ori": np.zeros((32 + j, 48, 3), np.uint8)},
             {"kpt": rs.rand(5 + j, 2).astype(np.float32), "desc": rs.rand(5 + j, 8).astype(np.float32),
              "kp_score": rs.rand(5 + j, 1).astype(np.float32)}) for j, name in enumerate(names)]


def _append(root, items):
    w = _writer(root)
    for inputs, processed in items:
        Extractor.save_desc(w, inputs, processed)


def _h5_files(root):
    """{file relative to the h5 root: {dataset path: array}}."""
    import h5py

    out = {}
    for p in sorted((root / "desch5").rglob("*.h5")):
        tree = {}
        with h5py.File(p, "r") as f:
            f.visititems(lambda k, v: tree.__setitem__(k, np.array(v)) if isinstance(v, h5py.Dataset) else None)
        out[str(p.relative_to(root / "desch5"))] = tree
    return out


def _same_h5(a, b):
    assert sorted(a) == sorted(b)
    for fname in a:
        assert sorted(a[fname]) == sorted(b[fname]), fname
        for key in a[fname]:
            np.testing.assert_array_equal(a[fname][key], b[fname][key], err_msg=f"{fname}:{key}")


def test_two_processes_append_to_one_h5_root(tmp_path):
    """Two forked processes append every other image of one list to the
    same files at once; the files hold what one process writes."""
    pytest.importorskip("h5py")
    items = _slates(24)
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=_append, args=(tmp_path / "two", items[i::2])) for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    _append(tmp_path / "one", items)
    _same_h5(_h5_files(tmp_path / "two"), _h5_files(tmp_path / "one"))


def test_sharded_extraction_writes_the_h5_files_of_one_run(tmp_path):
    """num_shards: 2, shard 0 then shard 1 into one output_root, against a
    num_shards: 1 run (batch 1, so that every image runs alone in both)."""
    pytest.importorskip("h5py")
    for j, name in enumerate(("i_x/1.ppm", "i_x/2.ppm", "v_y/1.ppm")):
        _write_image(tmp_path, j, name)

    def cfg(tag, **shards):
        c = {**_config(tmp_path, tag, tmp_path / "none"), "save_h5": True, "save_npz": False,
             "detector_config": {**DET, "num_pts": 128}}
        c["data_config_extract"].update(batch_size=1, workers=1, **shards)
        return c

    for index in range(2):
        Extractor(cfg("shards", num_shards=2, shard_index=index), ckpt_root=str(tmp_path / "out"),
                  device="cpu").extract()
    Extractor(cfg("one"), ckpt_root=str(tmp_path / "out"), device="cpu").extract()
    got, want = _h5_files(tmp_path / "out" / "ex_shards"), _h5_files(tmp_path / "out" / "ex_one")
    assert len(want["feat.h5"]) == 3 * 4  # three images' groups of four datasets
    _same_h5(got, want)
