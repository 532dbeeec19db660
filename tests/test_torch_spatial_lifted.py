"""spatial_shard's lifted configurations on the CPU, bands on one device
listed several times (tests/test_torch_spatial.py holds the rest of the
banded program):

- the detectors that run on the score map gathered on the first device
  (``generate_kpts_single_noavg``, the grid detector, a stride, Gumbel
  and Categorical selection with a generator) against the unsharded
  detector on the same map: the slate bit for bit and in order;
- ResUNetHR on bands (its third decoder level puts the local map at H/2,
  where the head takes the reference dataflow) against the unsharded
  port at the banded forward's tolerance, rtol 1e-4 / atol 1e-5, and
  with ``generate_kpts_single_noavg`` against JAX's ``spatial_extract``
  on its 8-device CPU mesh (tests/test_spatial.py:92-106's tolerances);
- each lifted configuration through the Extractor over two devices
  against the unsharded Extractor, and ``stable: False`` refused there
  before any work;
- D2's 0/0 depth cells: NaN where JAX's prior has them, in the plain
  and the banded prior.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from posfeat_tpu_torch.ops import priors as P
from posfeat_tpu_torch.parallel import banded_detect, spatial_extract, spatial_mesh
from posfeat_tpu_torch.parallel import banded_ops as bo
from test_torch_spatial import LAYOUTS, _bands, _ordered, _port, _variables
from torch_port_helpers import SMALL_CONFIG


# detector configurations of the gathered score map, and Gumbel and
# Categorical selection (which take a generator)
GATHERED = {
    "noavg": ("generate_kpts_single_noavg", dict(num_pts=300, nms_radius=2, thr=1.0, thr_mod="mean")),
    "grid": ("generate_kpts_regular_grid_single", dict(grid_size=8, num_pts=200, nms_radius=1)),
    "stride2": ("generate_kpts_single", dict(num_pts=300, nms_radius=3, thr=0.5, thr_mod="abs", stride=2)),
    "gumbel": ("generate_kpts_single", dict(num_pts=40, nms_radius=1, stable=False, temperature=0.05)),
    "categorical": ("generate_kpts_regular_grid_single", dict(grid_size=8, num_pts=0, stable=False,
                                                              nms_radius=1)),
}


@pytest.mark.parametrize("layout", ["3", "2u"])
@pytest.mark.parametrize("case", sorted(GATHERED))
def test_gathered_detectors_match_unsharded(case, layout):
    """The slate bit for bit and in order (NaN where the unsharded stride-2
    slate pads), valid_count equal, with the exact and the packed
    ("approx") top-k passed through; random selection from generators of
    one seed."""
    from posfeat_tpu_torch.ops.detect import DETECTORS

    name, cfg = GATHERED[case]
    rs = np.random.RandomState(7)
    H = 16 * sum(LAYOUTS[layout])
    kp = torch.from_numpy(rs.rand(2, H, 40, 1).astype(np.float32))
    kp[:, 20:30, 5:9] = 0.5
    draws = lambda: {"generator": torch.Generator().manual_seed(5)} if not cfg.get("stable", True) else {}
    for topk in ("exact", "approx"):
        want = DETECTORS[name](kp, topk=topk, **cfg, **draws())
        got = banded_detect.detect(_bands(kp, LAYOUTS[layout]), name, topk=topk, **cfg, **draws())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        if case == "stride2":
            assert torch.isnan(want[0]).any()  # the strided grids' NaN gather, kept


def test_d2_zero_depth_cells_match_jax():
    """D2's depth ratio is 0/0 where a pixel's relu is zero in every
    channel: JAX's prior gives NaN there (its max propagates NaN), and so
    do the port's plain and banded priors, at exactly those pixels; the
    rest within the priors' tolerance."""
    from posfeat_tpu.ops.priors import d2_prior as jax_d2

    x = np.random.RandomState(3).randn(2, 16, 20, 5).astype(np.float32)
    x[:, 3:5, 6:9] = -np.abs(x[:, 3:5, 6:9])
    dead = (x <= 0).all(axis=-1)
    want = np.asarray(jax_d2(jnp.asarray(x)))[..., 0]
    plain = P.d2_prior(torch.from_numpy(x)).numpy()[..., 0]
    banded = bo.d2_prior(_bands(torch.from_numpy(x), LAYOUTS["3"], 4)).concat().numpy()[..., 0]
    assert dead.sum() >= 6
    for got in (want, plain, banded):
        np.testing.assert_array_equal(np.isnan(got), dead)
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(banded, plain, rtol=1e-5, atol=1e-6)


HR_CONFIG = copy.deepcopy(SMALL_CONFIG)
HR_CONFIG["backbone"] = "ResUNetHR"


@pytest.fixture(scope="module")
def hr_variables():
    return _variables(HR_CONFIG, 12)


@pytest.mark.parametrize("k", [2, 3])
def test_banded_hr_forward_matches_unsharded(hr_variables, k):
    """ResUNetHR on bands: its third decoder level puts local_map and
    local_map_small at H/2, where the banded head takes the reference
    dataflow and warns as the unsharded head does."""
    cfg = copy.deepcopy(HR_CONFIG)
    cfg["localheader_config"]["fused_upsample"] = "phase"
    model = _port(cfg, hr_variables)
    im = torch.from_numpy(np.random.RandomState(k).rand(1, 64, 48, 3).astype(np.float32))
    with pytest.warns(UserWarning, match="reference dataflow"):
        want = model.extract(im)
    model.localheader._warned_ratio = False
    with pytest.warns(UserWarning, match="reference dataflow"):
        got = spatial_extract(model, spatial_mesh(["cpu"] * k))(im)
    assert got["local_map"].total == 32 and got["local_point"].total == 64
    for key in ("local_map", "global_map", "local_point", "local_thr"):
        np.testing.assert_allclose(got[key].concat().numpy(), want[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)


NOAVG = dict(num_pts=200, nms_radius=2, thr=1.0, thr_mod="mean")


def test_hr_noavg_slice_matches_jax_spatial_extract(hr_variables):
    """ResUNetHR with ``generate_kpts_single_noavg`` over 4 bands against
    JAX's ``spatial_extract`` on its 8-device CPU mesh, compared as
    tests/test_spatial.py:92-106 compares."""
    from posfeat_tpu.models import PoSFeat as JaxPoSFeat
    from posfeat_tpu.ops.detect import generate_kpts_single_noavg as jax_detect
    from posfeat_tpu.ops.grid_sample import sample_feat_by_coord as jax_sample
    from posfeat_tpu.parallel import shard_image_spatial
    from posfeat_tpu.parallel import spatial_extract as jax_spatial_extract
    from posfeat_tpu.parallel import spatial_mesh as jax_spatial_mesh

    im = np.random.RandomState(1).rand(1, 128, 64, 3).astype(np.float32)

    def jax_post(outputs):
        coord_n, score, valid = jax_detect(outputs["local_point"], **NOAVG)
        return coord_n, score, jax_sample(outputs["local_map"], coord_n, norm=True), valid

    mesh = jax_spatial_mesh(jax.devices("cpu")[:8])
    fn = jax_spatial_extract(JaxPoSFeat(copy.deepcopy(HR_CONFIG), dtype=jnp.float32), mesh, postprocess=jax_post)
    j_coord, j_score, j_feat, j_valid = (np.asarray(o) for o in fn(jax.tree.map(jnp.asarray, hr_variables),
                                                                      shard_image_spatial(jnp.asarray(im), mesh)))

    def post(outputs):
        coord_n, score, valid = banded_detect.detect(outputs["local_point"], "generate_kpts_single_noavg", **NOAVG)
        return coord_n, score, banded_detect.sample_feat_by_coord(outputs["local_map"], coord_n, True), valid

    model = _port(HR_CONFIG, hr_variables)
    coord, score, feat, valid = spatial_extract(model, spatial_mesh(["cpu"] * 4), post)(torch.from_numpy(im))
    assert int(valid[0]) == int(j_valid[0])
    c1, s1, f1 = _ordered(coord, score, feat)
    c2, s2, f2 = _ordered(j_coord, j_score, j_feat)
    np.testing.assert_allclose(c1, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1, s2, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(f1, f2, rtol=1e-3, atol=1e-4)


EX_H, EX_W = 64, 48
LIFTED = {
    "hr": ("generate_kpts_single", {}, "ResUNetHR"),
    "noavg": ("generate_kpts_single_noavg", {}, "ResUNet"),
    "grid": ("generate_kpts_regular_grid_single", {"grid_size": 8, "num_pts": 0}, "ResUNet"),
    "stride2": ("generate_kpts_single", {"stride": 2}, "ResUNet"),
}


def _extract(tmp_path, tag, detector, det, backbone, **extra):
    from posfeat_tpu_torch.extract import Extractor
    from test_torch_extract import DET, _config

    cfg = {**_config(tmp_path, tag, tmp_path / "none"), "detector": detector, **extra}
    cfg["model_config"]["backbone"] = backbone
    cfg["detector_config"] = {**DET, **det}
    frame = (np.random.RandomState(4).rand(EX_H, EX_W, 3) * 255).astype(np.uint8)
    item = {"im1": None, "im1_ori": frame, "coord1": np.zeros((0, 2), np.float32), "name1": "s/frame.png",
            "pad1": (0, 0, 0, 0)}
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[item], seed=3)
    assert ex.extract()[0] == 1
    return ex, np.load(f"{ex.desc_root}/s/frame.png.pf")


@pytest.mark.parametrize("case", sorted(LIFTED))
def test_extractor_runs_lifted_configs_banded(tmp_path, monkeypatch, case):
    """ResUNetHR, the no-refinement and grid detectors and a stride run
    through the Extractor over two devices (no refusal): the banded npz
    holds the unsharded Extractor's slate (tests/test_spatial.py:92-106's
    tolerances, points paired by position)."""
    from posfeat_tpu_torch.extract import extractor as ex_mod

    detector, det, backbone = LIFTED[case]
    _, plain = _extract(tmp_path, "plain", detector, det, backbone)
    monkeypatch.setattr(ex_mod, "_visible_devices", lambda device: 2)
    ex, got = _extract(tmp_path, "banded", detector, det, backbone, spatial_shard=2,
                       spatial_threshold_px=EX_H * EX_W - 1)
    assert ("spatial", (EX_H, EX_W), "detector_config") in ex._programs
    assert got["keypoints"].shape == plain["keypoints"].shape
    ia = np.lexsort((got["keypoints"][:, 1], got["keypoints"][:, 0]))
    ib = np.lexsort((plain["keypoints"][:, 1], plain["keypoints"][:, 0]))
    np.testing.assert_allclose(got["keypoints"][ia], plain["keypoints"][ib], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["scores"][ia], plain["scores"][ib], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["descriptors"][ia], plain["descriptors"][ib], rtol=1e-3, atol=1e-4)
