"""The spatial (H-banded) extraction program of posfeat_tpu_torch on the
CPU, bands on one device listed several times (``spatial_mesh(["cpu"] *
k)``, the counterpart of JAX's virtual CPU devices):

- each banded primitive against its unsharded port function, on 2, 3
  and 4 bands (uneven ones and a band of one 16-row block among them);
- the banded detector and sampler against the unsharded ones on random
  maps: the slate equal bit for bit, in order;
- the banded forward against the port's unsharded ``model.extract``
  for the three head dataflows at f32 and the SSIM prior, at JAX's
  tolerance (tests/test_spatial.py:50-53); with the SSIM prior the
  banded head is held on the unsharded backbone's maps;
- the slice as a whole against JAX's ``spatial_extract`` on its 8-device
  CPU mesh, with the detector and sampling as ``postprocess``, compared
  as tests/test_spatial.py:92-106 compares, and against the port's
  unsharded slate in order;
- the refusals, raised before any work.

Weights: a port model's random parameters with BatchNorm statistics and
biases redrawn, carried to a JAX variable tree by the JAX package's
importer and back through ``from_jax_variables``, so both packages
compute the same function (and no JAX init is traced).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from posfeat_tpu.core.torch_import import import_keypoint_det, import_resunet
from posfeat_tpu_torch.core.jax_weights import from_jax_variables
from posfeat_tpu_torch.models import PoSFeat
from posfeat_tpu_torch.models.keypoint_det import instance_norm
from posfeat_tpu_torch.ops import priors as P
from posfeat_tpu_torch.ops.detect import generate_kpts_single
from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord
from posfeat_tpu_torch.ops.resize import interpolate_bilinear
from posfeat_tpu_torch.parallel import banded_ops as bo
from posfeat_tpu_torch.parallel import banded_detect, spatial_extract, spatial_mesh
from posfeat_tpu_torch.parallel import spatial as spatial_mod
from posfeat_tpu_torch.parallel.banded_models import keypoint_det
from torch_port_helpers import SMALL_CONFIG, randomize

# 16-row blocks per band: two even, three uneven with a one-block band, four of one block
LAYOUTS = {"2": (2, 2), "3": (1, 2, 1), "4": (1, 1, 1, 1), "2u": (3, 1)}


def _bands(x, blocks, scale=1):
    """x [B, H, ...] as bands of ``blocks`` 16-row blocks at 1/scale resolution."""
    starts = list(np.cumsum((0,) + blocks[:-1]) * 16 // scale)
    return bo.split_rows(x, ["cpu"] * len(blocks), starts)


def _conv(x, w, b, s, p, d):
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, s, p, d).permute(0, 2, 3, 1)


def _prim_cases():
    rs = np.random.RandomState(0)
    w3 = torch.from_numpy(rs.randn(6, 5, 3, 3).astype(np.float32))
    w7 = torch.from_numpy(rs.randn(6, 5, 7, 7).astype(np.float32))
    w1 = torch.from_numpy(rs.randn(6, 5, 1, 1).astype(np.float32))
    bias = torch.from_numpy(rs.randn(6).astype(np.float32))
    cases = {}
    for name, w, s, p, d in (("conv3x3", w3, 1, 1, 1), ("conv7x7_s2", w7, 2, 3, 1), ("conv3x3_s2", w3, 2, 1, 1),
                             ("conv1x1_s2", w1, 2, 0, 1), ("conv3x3_d2", w3, 1, 2, 2)):
        cases[name] = (1, lambda x, w=w, s=s, p=p, d=d: _conv(x, w, bias, s, p, d),
                       lambda b, w=w, s=s, p=p, d=d: bo.conv2d(b, [w] * len(b), [bias] * len(b), s, p, d))
    cases["max_pool_3_2_1"] = (1, lambda x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1),
                               lambda b: bo.max_pool2d(b, 3, 2, 1))
    # UpConv's x2 at H/8 and the head's x4 at H/4, in global coordinates
    cases["resize_x2_align"] = (8, lambda x: interpolate_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]), True),
                                lambda b: bo.resize(b, (2 * b.total, 2 * b.parts[0].shape[2]), True))
    cases["resize_x4"] = (4, lambda x: interpolate_bilinear(x, (4 * x.shape[1], 4 * x.shape[2]), False),
                          lambda b: bo.resize(b, (4 * b.total, 4 * b.parts[0].shape[2]), False))
    cases["instance_norm"] = (1, instance_norm, bo.instance_norm)
    cases["ssim"] = (4, P.ssim_prior, bo.ssim_prior)
    cases["d2"] = (4, P.d2_prior, bo.d2_prior)
    cases["asl_peak"] = (4, P.asl_peak_prior, bo.asl_peak_prior)
    return cases


PRIMS = _prim_cases()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("prim", sorted(PRIMS))
def test_banded_primitive_matches_unsharded(prim, layout):
    scale, plain, banded = PRIMS[prim]
    H = 16 * sum(LAYOUTS[layout])
    x = torch.from_numpy(np.random.RandomState(1).randn(2, H // scale, 20, 5).astype(np.float32))
    want = plain(x)
    got = banded(_bands(x, LAYOUTS[layout], scale)).concat()
    assert got.shape == want.shape
    # D2's depth ratio is 0/0 where a pixel's relu is zero in every channel, as in the plain prior
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6, equal_nan=True)


DET_CASES = [
    dict(refine="avg3", nms_radius=1, use_nms=True, thr=False),
    dict(refine="avg3", nms_radius=3, use_nms=True, thr=0.5, thr_mod="abs"),
    dict(refine="quad", nms_radius=2, use_nms=True, thr=1.0, thr_mod="mean"),
    dict(refine="quad5", nms_radius=4, use_nms=True, thr=0.2, thr_mod="max"),
    dict(refine="soft", nms_radius=3, use_nms=False, thr=0.5, thr_mod="abs"),
    dict(refine="soft5", nms_radius=2, use_nms="softnms", thr=0.3, thr_mod="mean"),
]


def _tied_map(rs, H, dtype=torch.float32):
    """A random score map with plateaus (ties) inside a band and across a
    band edge."""
    kp = torch.from_numpy(rs.rand(2, H, 40, 1).astype(np.float32))
    kp[:, 20:30, 5:9] = 0.5
    kp[:, 14:19] = 0.25
    return kp.to(dtype)


def _slates_equal(kp, layout, cfg):
    """The banded slate against the unsharded one under both top-k modes,
    bit for bit and in order, valid_count equal; returns the unsharded
    slates by mode."""
    want = {}
    for topk in ("exact", "approx"):
        want[topk] = generate_kpts_single(kp, topk=topk, **cfg)
        got = banded_detect.detect(_bands(kp, LAYOUTS[layout]), topk=topk, **cfg)
        for g, w in zip(got, want[topk]):
            assert g.dtype == w.dtype and torch.equal(g, w), topk
    return want


@pytest.mark.parametrize("layout", ["3", "4", "2u"])
@pytest.mark.parametrize("case", range(len(DET_CASES)))
def test_banded_detector_and_sampling_match_unsharded(case, layout):
    """The slate bit for bit and in order, valid_count equal, with the
    exact and the packed ("approx") top-k; the descriptors of the
    "corner" and "quad" samplers at rtol 1e-5 and the "pair" sampler's
    bit for bit. The map has plateaus (ties) inside a band and across a
    band edge."""
    rs = np.random.RandomState(case)
    H = 16 * sum(LAYOUTS[layout])
    want = _slates_equal(_tied_map(rs, H), layout, dict(num_pts=300, **DET_CASES[case]))
    fmap = torch.from_numpy(rs.randn(2, H // 4, 10, 8).astype(np.float32))
    coords = torch.cat([want["approx"][0], want["exact"][0],
                        torch.from_numpy(rs.uniform(-1.1, 1.1, (2, 50, 2)).astype(np.float32))], 1)
    bands = _bands(fmap, LAYOUTS[layout], 4)
    for impl in ("corner", "quad", "pair"):
        got = banded_detect.sample_feat_by_coord(bands, coords, True, impl)
        ref = sample_feat_by_coord(fmap, coords, True, impl)
        if impl == "pair":
            assert torch.equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=impl)


@pytest.mark.parametrize("layout", ["3", "4", "2u"])
def test_banded_packed_topk_on_a_bf16_map(layout):
    """A bf16 score map (the packing starts from its f32 value): the
    banded slate under both top-k modes bit for bit, bf16 scores, at a
    radius whose blocks straddle the band edges (fold 3 on 16-row
    bands) and with the last band's zero pad blocks."""
    rs = np.random.RandomState(7)
    H = 16 * sum(LAYOUTS[layout])
    kp = _tied_map(rs, H, torch.bfloat16)
    want = _slates_equal(kp, layout, dict(num_pts=400, nms_radius=2, use_nms=True, thr=0.3, thr_mod="abs"))
    assert want["approx"][1].dtype == torch.bfloat16


def _variables(config, seed):
    """A JAX variable tree (numpy) of random port weights, BatchNorm
    statistics and biases redrawn."""
    m = PoSFeat(copy.deepcopy(config), device="cpu", seed=seed)
    np_sd = lambda mod: {k: v.numpy() for k, v in mod.state_dict().items()}
    v = {"backbone": import_resunet(np_sd(m.backbone)), "localheader": import_keypoint_det(np_sd(m.localheader))}
    return randomize(v, np.random.RandomState(seed))


def _port(config, variables):
    m = PoSFeat(copy.deepcopy(config), device="cpu")
    sds = from_jax_variables(variables)
    m.backbone.load_state_dict(sds["backbone"])
    m.localheader.load_state_dict(sds["localheader"])
    return m


@pytest.fixture(scope="module")
def small_variables():
    return _variables(SMALL_CONFIG, 11)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("dataflow, prior", [(False, "identity"), ("phase", "identity"), ("always", "identity"),
                                             ("phase", "SSIM")])
def test_banded_forward_matches_unsharded(small_variables, dataflow, prior, k):
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["localheader_config"].update(fused_upsample=dataflow, prior=prior)
    model = _port(cfg, small_variables)
    im = torch.from_numpy(np.random.RandomState(k).rand(1, 128, 64, 3).astype(np.float32))
    want = model.extract(im)
    mesh = spatial_mesh(["cpu"] * k)
    got = spatial_extract(model, mesh)(im)
    assert len(got["local_point"]) == k
    for key in ("local_map", "global_map") + (("local_point",) if prior != "SSIM" else ()):
        np.testing.assert_allclose(got[key].concat().numpy(), want[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)
    if prior == "SSIM":
        # the SSIM prior's 3x3 variances cancel, so the rounding of the
        # backbone's convs on bands (oneDNN picks algorithms by shape) grows
        # past 1e-4 in its score; the banded head is held on the unsharded
        # backbone's maps
        starts = mesh.plan(128)
        with torch.no_grad():
            fm = model.backbone(im)
            local_input = torch.cat([fm["local_map"], fm["local_map_small"]], dim=-1)
            want_head = model.localheader(local_input, im)
            head = keypoint_det(bo.split_rows(local_input, ["cpu"] * k, [a // 4 for a in starts]),
                                bo.split_rows(im, ["cpu"] * k, starts), [model.localheader] * k).concat()
        np.testing.assert_allclose(head.numpy(), want_head.numpy(), rtol=1e-4, atol=1e-5)


DET = dict(num_pts=512, nms_radius=3, use_nms=True, thr=1.0, thr_mod="mean")


def _ordered(c, s, f):
    c, s, f = np.asarray(c)[0], np.asarray(s)[0], np.asarray(f)[0]
    idx = np.lexsort((c[:, 1], c[:, 0]))
    return c[idx], s[idx], f[idx]


@pytest.fixture(scope="module")
def jax_slate(small_variables):
    """JAX's spatial_extract on its 8-device CPU mesh at 256x128 with the
    detector and sampling as postprocess."""
    from posfeat_tpu.models import PoSFeat as JaxPoSFeat
    from posfeat_tpu.ops.detect import generate_kpts_single as jax_detect
    from posfeat_tpu.ops.grid_sample import sample_feat_by_coord as jax_sample
    from posfeat_tpu.parallel import shard_image_spatial
    from posfeat_tpu.parallel import spatial_extract as jax_spatial_extract
    from posfeat_tpu.parallel import spatial_mesh as jax_spatial_mesh

    im = np.random.RandomState(0).rand(1, 256, 128, 3).astype(np.float32)
    model = JaxPoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=jnp.float32)

    def post(outputs):
        coord_n, score, valid = jax_detect(outputs["local_point"], **DET)
        return coord_n, score, jax_sample(outputs["local_map"], coord_n, norm=True), valid

    mesh = jax_spatial_mesh(jax.devices("cpu")[:8])
    fn = jax_spatial_extract(model, mesh, postprocess=post)
    out = fn(jax.tree.map(jnp.asarray, small_variables), shard_image_spatial(jnp.asarray(im), mesh))
    return im, [np.asarray(o) for o in out]


@pytest.mark.parametrize("k", [3, 8])
def test_slice_matches_jax_spatial_extract(small_variables, jax_slate, k):
    im, (j_coord, j_score, j_feat, j_valid) = jax_slate
    model = _port(SMALL_CONFIG, small_variables)

    def post(outputs):
        coord_n, score, valid = banded_detect.detect(outputs["local_point"], **DET)
        return coord_n, score, banded_detect.sample_feat_by_coord(outputs["local_map"], coord_n, True), valid

    coord, score, feat, valid = spatial_extract(model, spatial_mesh(["cpu"] * k), post)(torch.from_numpy(im))
    # JAX's comparison (tests/test_spatial.py:92-106)
    assert int(valid[0]) == int(j_valid[0])
    c1, s1, f1 = _ordered(coord, score, feat)
    c2, s2, f2 = _ordered(j_coord, j_score, j_feat)
    np.testing.assert_allclose(c1, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1, s2, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(f1, f2, rtol=1e-3, atol=1e-4)
    # the port's unsharded slate, in order
    ref = model.extract(torch.from_numpy(im))
    r_coord, r_score, r_valid = generate_kpts_single(ref["local_point"], **DET)
    r_feat = sample_feat_by_coord(ref["local_map"], r_coord, True)
    assert torch.equal(valid, r_valid)
    np.testing.assert_allclose(coord, r_coord, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(score, r_score, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat, r_feat, rtol=1e-3, atol=1e-4)


def test_refusals_come_before_any_work(small_variables, monkeypatch, tmp_path):
    """What stays refused: an Extractor over two devices refuses random
    selection (``stable: False``, no generator: Gumbel and the grid
    detector's Categorical draw) before it writes anything, where the
    detectors, strides and ResUNetHR that the banded program runs are
    taken; the fused head; an image that is not a multiple of 16 (where
    _skipconnect would pad) raises before the forward runs."""
    from posfeat_tpu_torch.extract import Extractor
    from posfeat_tpu_torch.extract import extractor as ex_mod
    from test_torch_extract import _config

    monkeypatch.setattr(ex_mod, "_visible_devices", lambda device: 2)
    for detector in ("generate_kpts_single", "generate_kpts_regular_grid_single"):
        cfg = {**_config(tmp_path, "refused", tmp_path / "none"), "spatial_shard": 2, "detector": detector}
        cfg["detector_config"] = {**cfg["detector_config"], "stable": False, "grid_size": 8}
        with pytest.raises(ValueError, match="stable: False selects at random and needs a generator"):
            Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
        assert not (tmp_path / "out").exists()
    for key, value in (("detector", "generate_kpts_regular_grid_single"), ("detector", "generate_kpts_single_noavg"),
                       ("detector_config", {"stride": 2}), ("model_config", {"backbone": "ResUNetHR"})):
        cfg = {**_config(tmp_path, "taken", tmp_path / "none"), "spatial_shard": 2}
        cfg[key] = {**cfg[key], **value} if isinstance(value, dict) else value
        Extractor(cfg, ckpt_root=str(tmp_path / "taken"), device="cpu", dataset=[])
    for name, cfg in (("generate_kpts_single", {"stable": False}),
                      ("generate_kpts_regular_grid_single", {"grid_size": 8, "stable": False})):
        with pytest.raises(ValueError, match="needs a generator"):
            banded_detect.check_detector(name, cfg)
        banded_detect.check_detector(name, cfg, draws=True)
    hr = copy.deepcopy(SMALL_CONFIG)
    hr["backbone"] = "ResUNetHR"
    spatial_extract(PoSFeat(hr, device="cpu"), spatial_mesh(["cpu"] * 2))
    fused = copy.deepcopy(SMALL_CONFIG)
    fused["localheader_config"]["fused_upsample"] = "pallas"
    with pytest.raises(ValueError, match="'phase'"):
        spatial_extract(PoSFeat(fused, device="cpu"), spatial_mesh(["cpu"] * 2))
    ran = []
    monkeypatch.setattr(spatial_mod, "posfeat_extract", lambda *a: ran.append(a))
    fn = spatial_extract(_port(SMALL_CONFIG, small_variables), spatial_mesh(["cpu"] * 2))
    for shape in ((1, 72, 64, 3), (1, 64, 72, 3)):
        with pytest.raises(ValueError, match="_skipconnect would pad"):
            fn(torch.zeros(shape))
    assert ran == []


def test_band_plan():
    """Whole 16-row blocks, at most one block apart, no more bands than blocks;
    above one decoder row tile (512 rows), whole tiles."""
    mesh = spatial_mesh(["cpu"] * 4)
    assert mesh.plan(160) == [0, 48, 96, 128]
    assert mesh.plan(32) == [0, 16]
    assert spatial_mesh(["cpu"] * 3).plan(2048) == [0, 512, 1024]
