"""posfeat_tpu_torch.models against posfeat_tpu.models, f32, with the
weights carried across by from_jax_variables. Tolerance: the JAX
suite's model parity against torch goldens (test_models_parity.py:178,201)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from posfeat_tpu import models as jm
from posfeat_tpu_torch import models as tm
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict, head_state_dict
from torch_port_helpers import SMALL_CONFIG, jax_posfeat, port_posfeat, randomize

RTOL, ATOL = 1e-3, 2e-4


def _close(got, ref, key=""):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=key
    )


def test_resunet_matches_jax(rng):
    kw = dict(encoder="resnet18", coarse_out_ch=32, fine_out_ch=48)
    x = rng.rand(1, 64, 80, 3).astype(np.float32)
    jmodel = jm.ResUNet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = randomize(jax.tree.map(np.asarray, variables), rng)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    tmodel = tm.ResUNet(**kw).eval()
    tmodel.load_state_dict(backbone_state_dict(variables))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for key in ("global_map", "local_map", "local_map_small"):
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)


@pytest.mark.parametrize(
    "dataflow, prior, head_mode, dtype",
    [
        (False, "SSIM", "v3", "float32"),
        ("pallas", "identity", "v3", "float32"),
        ("pallas", "SSIM", "v3", "float32"),
        ("pallas", "SSIM", "v1", "float32"),
        ("phase", "SSIM", "v3", "float32"),
        ("always", "SSIM", "v3", "float32"),
        (True, "identity", "v3", "bfloat16"),
    ],
    ids=["reference_ssim", "pallas_identity", "pallas_ssim", "pallas_v1_ssim", "phase_ssim",
         "always_ssim", "auto_bf16_identity"],
)
def test_keypoint_det_matches_jax(rng, monkeypatch, dataflow, prior, head_mode, dtype):
    """Every dataflow of the head: the reference (upsample + concat +
    conv2), the fused head in modes v3 and v1 (the JAX package's
    POSFEAT_HEAD_MODE), whose Pallas kernels JAX runs interpreted on the
    CPU and the port runs as plain versions, the phase-layout tail, and
    the input-dilated composite ("always", and "auto" at bf16). At bf16
    (the flagship's identity prior: the SSIM prior's bf16 rounding alone
    moves JAX's own scores by 0.4 of their mean) the mean |difference| is
    held within 2e-2 of the mean |score|, the fused head's bf16 bound
    (test_pallas_fused_head.py:217-227), and the largest within 1e-1, as
    chip_smoke.py holds the bf16 head against the f32 reference."""
    monkeypatch.setenv("POSFEAT_HEAD_MODE", head_mode)
    kw = dict(in_channels=24, out_channels=2, prior=prior, act="Softplus",
              fused_upsample=dataflow)
    fm = rng.rand(1, 16, 20, 24).astype(np.float32)
    img = rng.rand(1, 64, 80, 3).astype(np.float32)
    jmodel = jm.KeypointDet(**kw, dtype=getattr(jnp, dtype))
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(fm), jnp.asarray(img))
    variables = randomize(jax.tree.map(np.asarray, variables), rng)
    ref = jmodel.apply(variables, jnp.asarray(fm), jnp.asarray(img))
    tmodel = tm.KeypointDet(**kw, fused_head_mode=head_mode, dtype=getattr(torch, dtype))
    tmodel.load_state_dict(head_state_dict(variables))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(fm), torch.from_numpy(img))
    assert got.shape == ref.shape and got.dtype == torch.float32
    if dtype == "float32":
        _close(got, ref)
    else:
        ref = np.asarray(ref, np.float32)
        d, scale = np.abs(got.numpy() - ref), np.abs(ref).mean()
        assert d.mean() < 2e-2 * scale and d.max() < 1e-1 * scale, (d.mean(), d.max(), scale)


def test_keypoint_det_rejects_unknown_dataflows():
    with pytest.raises(ValueError, match="fused_upsample"):
        tm.KeypointDet(in_channels=8, fused_upsample="fast")
    with pytest.raises(ValueError, match="fused_head_mode"):
        tm.KeypointDet(in_channels=8, fused_upsample="pallas", fused_head_mode="v2")


@pytest.mark.parametrize("dataflow, dtype, device, refused", [
    ("pallas", torch.float32, "cuda", False),
    ("pallas", torch.float16, "cuda", True),
    ("pallas", torch.float64, "cuda", True),
    ("pallas", torch.bfloat16, "cuda", False),
    ("pallas", torch.float32, "cpu", False),
    (False, torch.float32, "cuda", False),
    (True, torch.float32, "cuda", False),
    ("phase", torch.float32, "cuda", False),
    ("always", torch.float32, "cuda", False),
])
def test_fused_head_refused_on_the_card_below_bf16(dataflow, dtype, device, refused):
    """The fused head's kernels take bf16 and f32: (pallas, any other
    dtype, cuda) raises ValueError naming K1/K2, the dtypes they take and
    the dataflows that run at any dtype; every other dataflow, bf16 and
    f32 on the card, and every dtype on the CPU (the plain versions) pass."""
    from posfeat_tpu_torch.models.keypoint_det import check_head_dataflow

    if refused:
        with pytest.raises(ValueError, match=r"K1/K2.*bfloat16 and float32 only.*False, True, 'phase' or 'always'"):
            check_head_dataflow(dataflow, dtype, device)
    else:
        check_head_dataflow(dataflow, dtype, device)


def test_keypoint_det_checks_its_dataflow_before_any_work(rng, monkeypatch):
    """KeypointDet.forward applies the dataflow rule to its dtype and its
    input's device before its first conv."""
    from posfeat_tpu_torch.models import keypoint_det as kd

    seen = []

    class Refused(Exception):
        pass

    def rule(*args):
        seen.append(args)
        raise Refused

    def no_work(*a, **k):
        raise AssertionError("the head ran before its dataflow was checked")

    monkeypatch.setattr(kd, "check_head_dataflow", rule)
    monkeypatch.setattr(kd, "_conv", no_work)
    monkeypatch.setattr(kd, "fused_head_tail", no_work)
    head = tm.KeypointDet(in_channels=8, fused_upsample="pallas", dtype=torch.float32)
    with pytest.raises(Refused):
        head(torch.from_numpy(rng.rand(1, 4, 5, 8).astype(np.float32)), torch.zeros(1, 16, 20, 3))
    assert seen == [("pallas", torch.float32, "cpu")]


def test_posfeat_extract_output_dict(rng):
    jmodel, variables = jax_posfeat(seed=3)
    im = rng.rand(1, 64, 96, 3).astype(np.float32)
    ref = jmodel.extract(jax.tree.map(jnp.asarray, variables), jnp.asarray(im))
    tmodel = port_posfeat(variables)
    got = tmodel.extract(torch.from_numpy(im))
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)


def test_keypoint_det_gradient_matches_jax(rng):
    """The f32 reference dataflow differentiates to JAX's gradient: d of a
    weighted sum of the score map w.r.t. every head parameter."""
    kw = dict(in_channels=24, out_channels=1, prior="identity", act="Softplus")
    fm = rng.rand(1, 16, 20, 24).astype(np.float32)
    img = rng.rand(1, 64, 80, 3).astype(np.float32)
    wts = rng.randn(1, 64, 80, 1).astype(np.float32)
    jmodel = jm.KeypointDet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(fm), jnp.asarray(img))
    variables = randomize(jax.tree.map(np.asarray, variables), rng)

    def f(params):
        return jnp.sum(jmodel.apply({"params": params}, jnp.asarray(fm), jnp.asarray(img)) * wts)

    g_ref = jax.grad(f)(jax.tree.map(jnp.asarray, variables["params"]))
    tmodel = tm.KeypointDet(**kw, fused_upsample=False)
    tmodel.load_state_dict(head_state_dict(variables))
    (tmodel(torch.from_numpy(fm), torch.from_numpy(img)) * torch.from_numpy(wts)).sum().backward()
    want = head_state_dict({"params": jax.tree.map(np.asarray, g_ref)})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def test_posfeat_training_forward_keeps_the_head_graph(rng):
    _, variables = jax_posfeat(seed=3)
    tmodel = port_posfeat(variables)
    tmodel.backbone.requires_grad_(False)
    im = torch.from_numpy(rng.rand(1, 64, 96, 3).astype(np.float32))
    out = tmodel({"im1": im, "im2": im})
    assert out["preds1"]["local_point"].requires_grad
    assert not out["preds1"]["local_map"].requires_grad  # frozen backbone: no graph
    torch.testing.assert_close(out["preds2"]["local_point"], tmodel.extract(im)["local_point"])
    # stage 1: BatchNorm trains, each view updating the running statistics,
    # with a graph through the backbone once its parameters require one
    tmodel.backbone.requires_grad_(True)
    mean0 = tmodel.backbone.firstbn.running_mean.clone()
    out = tmodel({"im1": im, "im2": im}, train=True)
    assert out["preds1"]["local_map"].requires_grad and tmodel.backbone.training
    out["preds1"]["local_point"].sum().backward()  # the head's input is detached
    assert all(p.grad is None for p in tmodel.backbone.parameters())
    assert int(tmodel.backbone.firstbn.num_batches_tracked) == 2
    assert not torch.equal(tmodel.backbone.firstbn.running_mean, mean0)
    tmodel.extract(im)
    assert not tmodel.backbone.training  # extraction runs in eval mode again
    # bf16 trains with f32 parameters through the head's dilated composite;
    # the fused kernels K1/K2 have no backward and are refused under autograd
    bf = tm.PoSFeat(SMALL_CONFIG, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    out = bf({"im1": im, "im2": im})
    assert out["preds1"]["local_map"].dtype == torch.bfloat16 and out["preds1"]["local_point"].requires_grad
    out["preds1"]["local_point"].sum().backward()
    assert bf.localheader.conv2.weight.grad.dtype == torch.float32
    bf.localheader.fused_upsample = "pallas"
    with pytest.raises(NotImplementedError, match="pallas"):
        bf({"im1": im, "im2": im})
    with torch.no_grad():
        assert bf({"im1": im, "im2": im})["preds1"]["local_point"].shape == (1, 64, 96, 1)
