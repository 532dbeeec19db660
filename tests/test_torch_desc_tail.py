"""The bf16 decoder of posfeat_tpu_torch's backbones against the JAX
package's (posfeat_tpu/models/resunet.py): the concat-free skip iconv
(``ConvBNEluSplitCat``), the ``desc_tail`` ladder (``TAIL_VARIANTS``)
and the ``decoder_accum`` / ``desc_f32`` knobs (JAX's
POSFEAT_DECODER_ACCUM=f32 and POSFEAT_DESC_F32=1, set here with
monkeypatch).

Per block, both packages take the same inputs (bf16 values) and the same
weights: f32 outputs within rtol 1e-5 / atol 1e-5 (both accumulate exact
bf16 products in f32, in another order), bf16 outputs within one bf16
rounding, rtol 8e-3 / atol 1e-2. The whole backbone is held to the JAX
suite's own bound for its bf16 tails, max |Δ local_map| ≤ 0.12 × mean
|local_map| (tests/test_models_parity.py:365-426), since its bf16
encoder rounds differently on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from posfeat_tpu import models as jm
from posfeat_tpu.models import resunet as jr
from posfeat_tpu_torch import models as tm
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict
from posfeat_tpu_torch.models import resunet as R
from posfeat_tpu_torch.parallel import banded_ops as bo
from posfeat_tpu_torch.parallel.banded_models import resunet as banded_resunet
from torch_port_helpers import randomize

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=8e-3, atol=1e-2)
BACKBONE_BOUND = 0.12
KW = dict(encoder="resnet18", coarse_out_ch=32, fine_out_ch=48)
BF16 = torch.bfloat16


def _nchw(x):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def _block(cin, cout, k, params, stats):
    """A port ConvBNElu carrying a flax ConvBNElu's parameters."""
    blk = R.ConvBNElu(cin, cout, k).eval()
    sd = {
        "conv.weight": np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1),
        "conv.bias": np.asarray(params["conv"]["bias"]),
        "bn.weight": np.asarray(params["bn"]["scale"]),
        "bn.bias": np.asarray(params["bn"]["bias"]),
        "bn.running_mean": np.asarray(stats["bn"]["mean"]),
        "bn.running_var": np.asarray(stats["bn"]["var"]),
    }
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=False)
    return blk


def _flax(module, rng, *xs):
    v = module.init(jax.random.PRNGKey(0), *xs)
    return randomize(jax.tree.map(np.asarray, v), rng)


def _bf16_input(rng, *shape):
    return np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16), np.float32)


# block: (JAX module and its inputs' dtype, the port's step)
BLOCKS = {
    "splitcat": "skip",
    "accum": R.Conv("accum", torch.float32),
    "split2": R.Conv("split", torch.float32, 2),
    "split3": R.Conv("split", torch.float32, 3),
    "up_split3": R.Up("upconv", R.Conv("split", torch.float32, 3), None, True, True),
    "up_accum": R.Up("upconv", R.Conv("accum", torch.float32)),
    "up_f32": R.Up("upconv", R.Conv("plain", torch.float32), torch.float32),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(rng, name):
    """Each block of the ladder on the same bf16 inputs and weights."""
    cin, cout = 24, 16
    x = _bf16_input(rng, 2, 10, 12, cin)
    step = BLOCKS[name]
    if name == "splitcat":
        b = _bf16_input(rng, 2, 10, 12, 40)
        mod = jr.ConvBNEluSplitCat(cout, 3, jnp.bfloat16)
        v = _flax(mod, rng, jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
        ref = mod.apply(v, jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
        blk = _block(cin + 40, cout, 3, v["params"], v["batch_stats"])
        skip = R.Skip("iconv", "x2", R.Conv("plain", BF16), splitcat=True)
        got = R.skip_conv(R.DenseOps, _nchw(b).to(BF16), _nchw(x).to(BF16), [blk], skip)
    elif isinstance(step, R.Up):
        interp = step.interp_f32
        mod = jr.UpConv(cout, 3, 2, jnp.float32 if step.cast_in else jnp.bfloat16,
                        accum_f32=step.conv.kind == "accum", interp_f32=interp, split2=step.conv.kind == "split",
                        split_passes=step.conv.passes)
        xin = jnp.asarray(x, jnp.float32 if step.cast_in else jnp.bfloat16)
        v = _flax(mod, rng, xin)
        ref = mod.apply(v, xin)
        up = R.UpConv(cin, cout, 3, 2)
        up.conv = _block(cin, cout, 3, v["params"]["conv"], v["batch_stats"]["conv"])
        xt = _nchw(x).to(torch.float32 if step.cast_in else BF16)
        got = R.up_conv(R.DenseOps, xt, [up], step)
    else:
        split = step.kind == "split"
        mod = jr.ConvBNElu(cout, 3, 1, jnp.bfloat16, accum_f32=not split, split2=split, split_passes=step.passes)
        xin = jnp.asarray(x, jnp.float32 if split else jnp.bfloat16)
        v = _flax(mod, rng, xin)
        ref = mod.apply(v, xin)
        blk = _block(cin, cout, 3, v["params"], v["batch_stats"])
        got = R.conv_bn_elu(R.DenseOps, _nchw(x).to(torch.float32 if split else BF16), [blk], step)
    got = got.permute(0, 2, 3, 1)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype), (got.dtype, ref.dtype)
    tol = BF16_TOL if got.dtype == BF16 else F32_TOL
    if name == "up_accum":
        # the bf16 lerp: torch's rounds once, JAX's each partial
        tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32), **tol)


def test_splitcat_matches_concat_dataflow(rng):
    """The concat-free iconv equals the conv on the concat at f32, same
    parameters (tests/test_models_parity.py:490-518, rtol 2e-5 / atol
    2e-6); at bf16 it is the f32 conv of the same bf16 operands rounded
    once, and within one bf16 rounding of the port's concat dataflow."""
    a = torch.from_numpy(rng.randn(2, 24, 12, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 40, 12, 16).astype(np.float32))
    blk = R.ConvBNElu(64, 32, 3).eval()
    with torch.no_grad():
        blk.conv.weight.copy_(torch.from_numpy(rng.randn(32, 64, 3, 3).astype(np.float32) * 0.05))
        blk.conv.bias.copy_(torch.from_numpy(rng.randn(32).astype(np.float32) * 0.1))
        blk.bn.running_mean.copy_(torch.from_numpy(rng.randn(32).astype(np.float32) * 0.3))
        blk.bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(np.float32)))
        ref = blk(torch.cat([a, b], dim=1))
        step = R.Skip("iconv", "x2", R.Conv("plain", torch.float32), splitcat=True)
        got = R.skip_conv(R.DenseOps, b, a, [blk], step)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)
        a16, b16 = a.to(BF16), b.to(BF16)
        split = R.skip_conv(R.DenseOps, b16, a16, [blk], R.Skip("iconv", "x2", R.Conv("plain", BF16), True))
        concat = R.skip_conv(R.DenseOps, b16, a16, [blk], R.Skip("iconv", "x2", R.Conv("plain", BF16), False))
        conv = F.conv2d(torch.cat([a16, b16], dim=1).float(), blk.conv.weight.to(BF16).float(), blk.conv.bias, padding=1)
        exact = F.elu(blk.bn(conv.to(BF16)))
    assert split.dtype == concat.dtype == BF16
    np.testing.assert_allclose(split.float().numpy(), exact.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(split.float().numpy(), concat.float().numpy(), **BF16_TOL)


# (backbone, desc_tail, JAX environment): every variant, the two knobs, and one of each with the other
VARIANTS = [
    ("ResUNet", "", {}),
    *(("ResUNet", t, {}) for t in jr.TAIL_VARIANTS),
    ("ResUNet", "", {"POSFEAT_DECODER_ACCUM": "f32"}),
    ("ResUNet", "", {"POSFEAT_DESC_F32": "1"}),
    ("ResUNet", "split3", {"POSFEAT_DECODER_ACCUM": "f32"}),
    ("ResUNetHR", "", {}),
    *(("ResUNetHR", t, {}) for t in ("iconv2", "up2", "split2", "split3", "split3w")),
    ("ResUNetHR", "", {"POSFEAT_DECODER_ACCUM": "f32"}),
]


@pytest.fixture(scope="module")
def backbone_weights():
    """Per backbone: (JAX variables, the same as a port state dict)."""
    out = {}
    x = jnp.zeros((1, 64, 80, 3), jnp.float32)
    for name in ("ResUNet", "ResUNetHR"):
        v = getattr(jm, name)(**KW).init(jax.random.PRNGKey(1), x, train=False)
        v = randomize(jax.tree.map(np.asarray, v), np.random.RandomState(3))
        out[name] = (v, backbone_state_dict(v))
    return out


@pytest.mark.parametrize("backbone, tail, env", VARIANTS,
                         ids=[f"{b}-{t or 'default'}-{'-'.join(e) or 'noenv'}" for b, t, e in VARIANTS])
def test_backbone_variant_matches_jax(rng, monkeypatch, backbone_weights, backbone, tail, env):
    """The whole bf16 backbone under each variant against JAX's, same
    weights and image: the same maps, dtypes and shapes, local_map within
    JAX's own bound; global_map and local_map_small, which no knob
    touches, as the default path computes them."""
    variables, sd = backbone_weights[backbone]
    x = rng.rand(1, 64, 80, 3).astype(np.float32)
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    ref = getattr(jm, backbone)(**KW, dtype=jnp.bfloat16, desc_tail=tail).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False)
    for k in env:
        monkeypatch.delenv(k)
    model = getattr(tm, backbone)(**KW, desc_tail=tail, decoder_accum=env.get("POSFEAT_DECODER_ACCUM", ""),
                                  desc_f32=env.get("POSFEAT_DESC_F32") == "1", dtype=BF16).eval()
    model.load_state_dict(sd)
    default = getattr(tm, backbone)(**KW, dtype=BF16).eval()
    default.load_state_dict(sd)
    # the same parameter names and shapes as the default path
    assert {k: v.shape for k, v in model.state_dict().items()} == {k: v.shape for k, v in sd.items()}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        base = default(torch.from_numpy(x))
    for key in ("global_map", "local_map", "local_map_small"):
        assert tuple(got[key].shape) == ref[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(ref[key].dtype), (key, got[key].dtype, ref[key].dtype)
    for key in ("global_map", "local_map_small"):
        assert torch.equal(got[key], base[key]), key
    r = np.asarray(ref["local_map"], np.float32)
    d = np.abs(got["local_map"].float().numpy() - r)
    assert np.isfinite(d).all()
    assert d.max() <= BACKBONE_BOUND * np.abs(r).mean(), (d.max(), np.abs(r).mean())


def test_unknown_variants_raise():
    for kw in (dict(desc_tail="split4"), dict(decoder_accum="bf16")):
        for cls in (tm.ResUNet, tm.ResUNetHR):
            with pytest.raises(ValueError, match="desc_tail|decoder_accum"):
                cls(**KW, dtype=BF16, **kw)
    with pytest.raises(ValueError, match="unknown desc_tail variant 'up3'"):
        R.decoder_plan(BF16, False, "up3")


def test_plan_follows_jax():
    """bf16 extraction takes the concat-free iconvs, training and f32 the
    concat; ResUNetHR has none; a tail makes conv_fine f32."""
    skips = lambda plan: [s.splitcat for s in plan if isinstance(s, R.Skip)]
    assert skips(R.decoder_plan(BF16, False)) == [True, True]
    assert skips(R.decoder_plan(BF16, True)) == [False, False]
    assert skips(R.decoder_plan(torch.float32, False)) == [False, False]
    assert skips(R.decoder_plan(BF16, False, hr=True)) == [False] * 3
    assert skips(R.decoder_plan(BF16, False, "split3")) == [True, False]
    assert skips(R.decoder_plan(BF16, False, "split3w")) == [False, False]
    assert skips(R.decoder_plan(BF16, False, decoder_accum="f32")) == [False, False]
    assert R.decoder_plan(BF16, False, "split3")[-1].conv == R.Conv("plain", torch.float32)
    assert all(s.conv.kind == "plain" and s.conv.dtype == torch.float32
               for s in R.decoder_plan(torch.float32, False, "split3", "f32", True))


@pytest.mark.parametrize("tail", ["", "split3"])
def test_banded_backbone_takes_the_plan(backbone_weights, tail):
    """The banded ResUNet at bf16 (concat-free iconvs, and split3) against
    the unsharded one on the CPU, over 2 and 3 bands: the same dtypes,
    and maps within one bf16 rounding (oneDNN picks algorithms by the
    band's shape)."""
    _, sd = backbone_weights["ResUNet"]
    model = tm.ResUNet(**KW, desc_tail=tail, dtype=BF16).eval()
    model.load_state_dict(sd)
    im = torch.from_numpy(np.random.RandomState(5).rand(1, 128, 64, 3).astype(np.float32))
    with torch.no_grad():
        want = model(im)
        for blocks in ((4, 4), (2, 4, 2)):
            starts = list(np.cumsum((0,) + blocks[:-1]) * 16)
            got = banded_resunet(bo.split_rows(im, ["cpu"] * len(blocks), starts), [model] * len(blocks))
            for key in ("local_map", "global_map", "local_map_small"):
                g = got[key].concat()
                assert g.dtype == want[key].dtype, key
                np.testing.assert_allclose(g.float().numpy(), want[key].float().numpy(), err_msg=key, **BF16_TOL)
