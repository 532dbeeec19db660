"""Slice O of posfeat_tpu_torch on the CPU: the H-banded extraction
program bit for bit the unsharded one, by construction.

- the head's instance norm with its moments from per-row partial sums
  (``ops/moments.py``, whose plain version the CPU runs) against JAX's
  head instance norm for both dims forms, and its gradient against
  autograd through the former one-sum formula;
- the banded head on shared maps over 2, 3 and 4 bands ``torch.equal``
  to the unsharded head, in f32 and bf16, in the "phase" and the
  reference dataflow;
- the banded decoder, its convs in ``row_tiled_conv``'s row tiles,
  ``torch.equal`` to the unsharded decoder on a map of three tiles, where
  oneDNN's convs otherwise round by the map's height;
- the banded samplers (corner, quad, pair) ``torch.equal`` to the
  unsharded ones;
- ``row_tiled_conv`` against one ``F.conv2d`` call, and a window of its
  rows against the same rows of the whole map;
- the band plan: starts on tile boundaries, every row covered, bands
  within one tile of each other; the kernel's launch shapes.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from posfeat_tpu.models.keypoint_det import instance_norm as jax_instance_norm
from posfeat_tpu_torch.models import PoSFeat
from posfeat_tpu_torch.models import resunet as R
from posfeat_tpu_torch.models.keypoint_det import KeypointDet, instance_norm
from posfeat_tpu_torch.ops import conv_tiles
from posfeat_tpu_torch.ops import moments as mo
from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord
from posfeat_tpu_torch.parallel import banded_detect
from posfeat_tpu_torch.parallel import banded_ops as bo
from posfeat_tpu_torch.parallel import spatial_mesh
from posfeat_tpu_torch.parallel.banded_models import BandOps, keypoint_det
from torch_port_helpers import SMALL_CONFIG

SHAPES = {"nhwc": ((2, 24, 20, 7), (1, 2)), "phase": ((2, 6, 5, 4, 4, 7), (1, 2, 3, 4))}


def _old_instance_norm(x, eps=1e-5, dims=(1, 2)):
    """The head's instance norm before this slice: one f32 sum a moment."""
    xf = x.float()
    n = int(np.prod([x.shape[d] for d in dims]))
    s1 = xf.sum(dim=dims, keepdim=True)
    s2 = (xf * xf).sum(dim=dims, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _map(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 3 + 1).astype(np.float32)


@pytest.mark.parametrize("form", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(form, dtype):
    """f32 at rtol 1e-6 / atol 1e-6; bf16 within the head's bf16 limits
    (mean |d| 2e-2, max |d| 1e-1 x mean |ref|, tests/test_torch_models.py)."""
    shape, dims = SHAPES[form]
    x = _map(shape, 0)
    got = instance_norm(torch.from_numpy(x).to(getattr(torch, dtype)), dims=dims).float().numpy()
    ref = np.asarray(jax_instance_norm(jnp.asarray(x, getattr(jnp, dtype)), axes=dims).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        d, scale = np.abs(got - ref), np.abs(ref).mean()
        assert d.mean() <= 2e-2 * scale and d.max() <= 1e-1 * scale, (d.mean(), d.max(), scale)


@pytest.mark.parametrize("form", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_gradient_matches_one_sum_formula(form, dtype):
    """The row moments' backward (1 and 2x, broadcast) against autograd
    through the former formula: f32 at rtol 1e-5, bf16 gradients equal
    up to one bf16 rounding."""
    shape, dims = SHAPES[form]
    x = torch.from_numpy(_map(shape, 1)).to(getattr(torch, dtype))
    w = torch.from_numpy(_map(shape, 2))
    grads = []
    for fn in (instance_norm, _old_instance_norm):
        xi = x.clone().requires_grad_(True)
        (fn(xi, dims=dims).float() * w).sum().backward()
        grads.append(xi.grad.float())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=1e-2)
    torch.testing.assert_close(grads[0], grads[1], **tol)


@pytest.mark.parametrize("form", sorted(SHAPES))
def test_row_moments_depend_on_their_row_alone(form):
    """Each row's partials from a band of rows equal the whole map's."""
    shape, _ = SHAPES[form]
    x = torch.from_numpy(_map(shape, 3))
    s1, s2 = mo.row_moments(x)
    for a, b in ((0, 1), (3, 5), (1, shape[1])):
        b1, b2 = mo.row_moments(x[:, a:b])
        assert torch.equal(b1, s1[:, a:b]) and torch.equal(b2, s2[:, a:b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", [1, 2, 7, 64, 128, 192, 256, 520])
def test_moments_launch_shape(dtype, C):
    """Each plan within what csrc/moments.cu takes, a row a whole number of
    vectors: the lane plan's 16-byte vectors and C a power of two up to
    32 x vec, threads from LANES and never fewer for a longer row; the slot
    plan's threads x vec a multiple of C and within its slots, a power of
    two of slots a channel where its vectors allow. The lane plan takes
    every row that it can (the head's 1-, 64- and 128-channel norms), and a
    plan is the same at any number of rows."""
    lanes = []
    for row_elems in (C * 3, C * 640, C * 12288):
        vec, lane, n = mo.launch_shape(dtype, row_elems, C)
        assert row_elems % vec == 0
        whole = 16 // dtype.itemsize
        assert lane == (row_elems % whole == 0 and C & (C - 1) == 0 and C <= 32 * whole)
        if lane:
            assert vec * dtype.itemsize == 16 and n in mo.LANES
            assert C & (C - 1) == 0 and C <= 32 * vec
            lanes.append(n)
        else:
            assert (n * vec) % C == 0 and n * vec <= mo.MAX_SLOTS and 0 < n <= 1024
            if vec > 1:
                assert (n * vec // C) & (n * vec // C - 1) == 0
    assert lanes == sorted(lanes)
    if C in (1, 64, 128):
        assert mo.launch_shape(dtype, C * 12288, C).lane
    assert mo.plan_of(torch.empty((1, 1, 3, C), dtype=dtype)) == mo.plan_of(torch.empty((4, 9, 3, C), dtype=dtype))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dataflow", ["phase", False])
def test_banded_head_on_shared_maps_is_bit_for_bit(k, dtype, dataflow):
    """The banded head on the same trunk input and image, split by the
    band plan, torch.equal to the unsharded head's score map."""
    torch.manual_seed(0)
    head = KeypointDet(24, 2, "SSIM", "Softplus", fused_upsample=dataflow, dtype=dtype).eval()
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    rs = np.random.RandomState(k)
    fm = torch.from_numpy(rs.rand(1, 32, 16, 24).astype(np.float32))
    im = torch.from_numpy(rs.rand(1, 128, 64, 3).astype(np.float32))
    starts = spatial_mesh(["cpu"] * k).plan(128)
    assert len(starts) == k
    with torch.no_grad():
        want = head(fm, im)
        got = keypoint_det(bo.split_rows(fm, ["cpu"] * k, [a // 4 for a in starts]),
                           bo.split_rows(im, ["cpu"] * k, starts), [head] * k).concat()
    assert torch.equal(got, want)


@pytest.mark.parametrize("starts", [(0, 16), (0, 4, 20, 28)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_samplers_are_bit_for_bit(dtype, starts):
    """Every sampler on bands, points inside, on and beyond the map's
    edges, torch.equal to the unsharded sampler."""
    rs = np.random.RandomState(5)
    fmap = torch.from_numpy(rs.randn(1, 40, 12, 8).astype(np.float32)).to(dtype)
    coords = torch.from_numpy(rs.uniform(-1.1, 1.1, (1, 300, 2)).astype(np.float32))
    bands = bo.split_rows(fmap, ["cpu"] * len(starts), list(starts))
    for impl in ("corner", "quad", "pair"):
        got = banded_detect.sample_feat_by_coord(bands, coords, True, impl)
        assert torch.equal(got, sample_feat_by_coord(fmap, coords, True, impl)), impl


@pytest.fixture(scope="module")
def encoder_maps():
    """A small ResUNet in f32 and bf16 and its encoder's maps of an image
    of three row tiles (32 columns), by tile and dtype."""
    cache = {}

    def get(tile, dt):
        if (tile, dt) not in cache:
            net = PoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=dt, device="cpu", seed=3).backbone.eval()
            im = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 3 * tile, 32).astype(np.float32))
            x = im.to(dt).contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                x_first1 = F.relu(net.firstbn(net.firstconv(x)))
                x1 = net.layer1(F.max_pool2d(x_first1, 3, 2, 1))
                x2 = net.layer2(x1)
                x3 = net.layer3(x2)
            cache[tile, dt] = net, {"x1": x1, "x2": x2, "x3": x3, "x_first1": x_first1}
        return cache[tile, dt]

    return get


@pytest.mark.parametrize("tile", [conv_tiles.ROW_TILE, 64])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_decoder_in_row_tiles_is_bit_for_bit(encoder_maps, monkeypatch, dtype, k, tile):
    """The decoder (bf16: the concat-free iconvs' f32 convs of bf16 values)
    on bands laid on tile boundaries, torch.equal to the unsharded one, at
    the port's tile and at 64 image rows a tile (8 rows at H/8), where
    oneDNN's bf16 iconv3 without the tiles rounds by the map's height."""
    monkeypatch.setattr(conv_tiles, "ROW_TILE", tile)
    net, maps = encoder_maps(tile, dtype)
    starts = spatial_mesh(["cpu"] * k).plan(3 * tile)
    assert len(starts) == k and all(a % tile == 0 for a in starts)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    stride = {"x1": 4, "x2": 8, "x3": 16, "x_first1": 2}
    bands = {key: bo.split_rows(nhwc(t), ["cpu"] * k, [a // stride[key] for a in starts]) for key, t in maps.items()}
    plan = net.plan(False)
    with torch.no_grad():
        want = R.run_decoder(R.DenseOps, [net], maps, plan)
        got = R.run_decoder(BandOps, [net] * k, bands, plan).concat()
    assert got.dtype == dtype and torch.equal(got, nhwc(want))


@pytest.mark.parametrize("k, s, p, d", [(3, 1, 1, 1), (1, 1, 0, 1), (3, 2, 1, 1), (7, 2, 3, 1), (3, 1, 2, 2)])
def test_row_tiled_conv_matches_one_call(k, s, p, d):
    """Tiles of 1, 3, 8 and 100 rows against one F.conv2d call (f64), and
    a window of the input holding some output rows."""
    rs = np.random.RandomState(k + s + p + d)
    x = torch.from_numpy(rs.randn(2, 5, 37, 9))
    w, b = torch.from_numpy(rs.randn(4, 5, k, k)), torch.from_numpy(rs.randn(4))
    ref = F.conv2d(x, w, b, s, p, d)
    for tile in (None, 1, 3, 8, 100):
        torch.testing.assert_close(conv_tiles.row_tiled_conv(x, w, b, s, p, d, tile), ref, rtol=1e-12, atol=1e-12)
        o0, o1 = 4, min(11, ref.shape[2])
        lo, hi = max(o0 * s - p, 0), min((o1 - 1) * s - p + (k - 1) * d + 1, 37)
        got = conv_tiles.row_tiled_conv(x[:, :, lo:hi], w, b, s, p, d, tile, lo, 37, (o0, o1))
        torch.testing.assert_close(got, ref[:, :, o0:o1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("height", [1024, 2048, 2064, 3024, 4096 + 16])
def test_band_plan_on_tile_boundaries(n, height):
    starts = spatial_mesh(["cpu"] * n).plan(height)
    tiles = -(-height // conv_tiles.ROW_TILE)
    assert starts[0] == 0 and starts == sorted(set(starts)) and starts[-1] < height
    assert len(starts) == min(n, tiles) and all(a % conv_tiles.ROW_TILE == 0 for a in starts)
    sizes = np.diff(starts + [height])
    assert sizes.max() - sizes.min() <= conv_tiles.ROW_TILE


def test_main_path_maps_are_one_tile():
    """480x640 (the batched extraction and training size) is one tile at
    every tiled level, H/2 to H/16, so those convs stay one call."""
    assert all(480 // s <= conv_tiles.ROW_TILE // s for s in (2, 4, 8, 16))
