"""posfeat_tpu_torch.ops against posfeat_tpu.ops on the same seeded
inputs (f32 on the CPU unless stated)."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from posfeat_tpu.ops import coords as jc
from posfeat_tpu.ops import detect as jd
from posfeat_tpu.ops import pooling as jp
from posfeat_tpu.ops import priors as jpr
from posfeat_tpu.ops import resize as jr
from posfeat_tpu_torch.ops import coords as tc
from posfeat_tpu_torch.ops import detect as td
from posfeat_tpu_torch.ops import grid_sample as tg
from posfeat_tpu_torch.ops import nms as tn
from posfeat_tpu_torch.ops import pooling as tp
from posfeat_tpu_torch.ops import priors as tpr
from posfeat_tpu_torch.ops import resize as tr

# posfeat_tpu.ops re-exports functions under these module names
jg = importlib.import_module("posfeat_tpu.ops.grid_sample")
jn = importlib.import_module("posfeat_tpu.ops.nms")

# f32 elementwise/pooling ops: summation order only
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def test_coords(rng):
    c = rng.rand(2, 7, 2).astype(np.float32) * 50
    _close(tc.normalize_coords(_t(c), 48, 64), jc.normalize_coords(jnp.asarray(c), 48, 64))
    n = rng.rand(2, 7, 2).astype(np.float32) * 2 - 1
    _close(tc.denormalize_coords(_t(n), 48, 64), jc.denormalize_coords(jnp.asarray(n), 48, 64))
    _close(tc.homogenize(_t(c)), jc.homogenize(jnp.asarray(c)))
    _close(tc.gen_grid(-1, 1, -1, 1, 5, 7), jc.gen_grid(-1, 1, -1, 1, 5, 7))


def test_pooling(rng):
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    for window, stride in ((3, 1), (3, 2), (2, 2)):
        _close(tp.avg_pool2d(_t(x), window, stride), jp.avg_pool2d(jnp.asarray(x), window, stride))
        _close(tp.max_pool2d(_t(x), window, stride), jp.max_pool2d(jnp.asarray(x), window, stride))
    for mode in ("constant", "reflect"):
        _close(tp.pad2d(_t(x), (1, 2, 2, 1), mode), jp.pad2d(jnp.asarray(x), (1, 2, 2, 1), mode))


@pytest.mark.parametrize("radius", [1, 2])
def test_nms_tie_break(rng, radius):
    # a coarsely quantized map is full of ties: the index tie-break must
    # pick the same single winner per window
    x = (rng.randint(0, 4, size=(2, 13, 17, 1)) / 4.0).astype(np.float32)
    got = tn.nms(_t(x), radius).numpy()
    ref = np.asarray(jn.nms(jnp.asarray(x), radius))
    assert got.dtype == np.bool_ and (got == ref).all()
    y = rng.rand(2, 13, 17, 1).astype(np.float32)
    _close(tn.soft_nms(_t(y), radius), jn.soft_nms(jnp.asarray(y), radius))


def test_resize_both_modes(rng):
    x = rng.rand(2, 5, 12, 3).astype(np.float32)
    for ac, size in ((True, (10, 24)), (False, (20, 48)), (False, (7, 9)), (True, (7, 9))):
        _close(
            tr.interpolate_bilinear(_t(x), size, align_corners=ac),
            jr.interpolate_bilinear(jnp.asarray(x), size, align_corners=ac),
            rtol=1e-4, atol=1e-5,  # the JAX resize's own tolerance vs torch
        )
    for axis in (1, 2):
        _close(tr._upsample_axis_int(_t(x), 4, axis), jr._upsample_axis_int(jnp.asarray(x), 4, axis))


@pytest.mark.parametrize("shape, f, block", [((2, 7, 5, 3), 4, 1), ((1, 9, 6, 4), 2, 200), ((1, 5, 3, 2), 8, 700),
                                            ((2, 1, 4, 3), 4, 10)])
def test_resize_row_blocks_match_one_call(rng, monkeypatch, shape, f, block):
    """Above ``BLOCK_ELEMENTS`` output elements a power-of-two row factor
    with align_corners=False resizes in row blocks (the card's
    channels-last bilinear refuses 2^31): bit for bit F.interpolate's one
    call, in f32 and bf16 (the limit lowered to force the blocks; blocks of
    one source row at the smallest); align_corners=True is one call."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    size = (f * shape[1], f * shape[2] + 3)
    calls = []
    interpolate = tr.F.interpolate
    monkeypatch.setattr(tr.F, "interpolate", lambda *a, **k: calls.append(a[0].shape[2]) or interpolate(*a, **k))
    monkeypatch.setattr(tr, "BLOCK_ELEMENTS", block)
    for t in (x, x.to(torch.bfloat16)):
        want = interpolate(t.permute(0, 3, 1, 2), size=size, mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        calls.clear()
        got = tr.interpolate_bilinear(t, size)
        assert torch.equal(got, want)
        assert len(calls) > 1 or shape[1] == 1, calls
    calls.clear()
    tr.interpolate_bilinear(x, size, align_corners=True)
    assert len(calls) == 1


def test_reference_head_in_row_blocks(rng, monkeypatch):
    """The reference head's x4 resize and conv2 past their limits (one
    resize above ``BLOCK_ELEMENTS`` output elements, one conv past
    ``CONV_MAX_ELEMENTS`` input elements: a 12 Mpx frame's, lowered here)
    run in row blocks: the score map within f32 rounding (rtol 1e-5 /
    atol 1e-6) of the one-call head's."""
    from posfeat_tpu_torch.models import keypoint_det as kd

    torch.manual_seed(1)
    head = kd.KeypointDet(in_channels=8, prior="identity", act="Softplus", fused_upsample=False).eval()
    fine = torch.from_numpy(rng.randn(1, 9, 6, 8).astype(np.float32))
    img = torch.from_numpy(rng.randn(1, 36, 24, 3).astype(np.float32))
    with torch.no_grad():
        want = head(fine, img)
        monkeypatch.setattr(tr, "BLOCK_ELEMENTS", 900)
        monkeypatch.setattr(kd, "CONV_MAX_ELEMENTS", 2000)
        convs = []
        conv2d = kd.F.conv2d
        monkeypatch.setattr(kd.F, "conv2d", lambda x, w, *a, **k: convs.append(tuple(x.shape)) or conv2d(x, w, *a, **k))
        got = head(fine, img)
    assert sum(shape[1] == 8 + 64 for shape in convs) > 1, convs  # conv2 on the concat, in blocks
    # the blocks' convs round as the library's conv of their shape does
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["SSIM", "D2", "ASL_Peak", "identity"])
def test_priors(rng, name):
    x = rng.randn(2, 10, 12, 4).astype(np.float32)
    _close(tpr.PRIORS[name](_t(x)), jpr.PRIORS[name](jnp.asarray(x)), rtol=1e-4, atol=1e-5)


def test_sample_feat_by_coord(rng):
    fmap = rng.randn(2, 12, 16, 8).astype(np.float32)
    pts = (rng.rand(2, 50, 2).astype(np.float32) * 2.2 - 1.1)  # some out of bounds
    for norm in (False, True):
        _close(
            tg.sample_feat_by_coord(_t(fmap), _t(pts), norm),
            jg.sample_feat_by_coord(jnp.asarray(fmap), jnp.asarray(pts), norm),
            rtol=1e-5, atol=1e-5,
        )
    # bf16 map: corners widened to f32, lerp and normalization in f32
    got = tg.sample_feat_by_coord(_t(fmap).to(torch.bfloat16), _t(pts), True)
    ref = jg.sample_feat_by_coord(jnp.asarray(fmap).astype(jnp.bfloat16), jnp.asarray(pts), True)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(num_pts=64, nms_radius=1, thr=0.9, thr_mod="abs"),
        dict(num_pts=300, nms_radius=2, thr=1.0, thr_mod="mean"),
        dict(num_pts=40, nms_radius=3, thr=False),
        dict(num_pts=5000, nms_radius=1, use_nms=False, thr=0.5, thr_mod="max"),
        dict(num_pts=64, nms_radius=1, use_nms="softnms", thr=0.7, thr_mod="abs"),
    ],
    ids=["r1_abs", "r2_mean", "r3_nothr", "nonms_pad", "softnms"],
)
def test_generate_kpts_single(rng, cfg):
    for kp in (
        rng.rand(2, 30, 41, 1).astype(np.float32) + 0.5,
        # ties everywhere: exact top-k order and block argmax decide
        (rng.randint(1, 5, size=(2, 30, 41, 1)) / 2.0).astype(np.float32),
    ):
        got = td.generate_kpts_single(_t(kp), **cfg)
        ref = jd.generate_kpts_single(jnp.asarray(kp), **cfg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-7)
        assert got[2].dtype == torch.int32
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
