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
    "dataflow, prior",
    [(False, "SSIM"), ("pallas", "identity"), ("pallas", "SSIM")],
    ids=["reference_ssim", "pallas_identity", "pallas_ssim"],
)
def test_keypoint_det_matches_jax(rng, dataflow, prior):
    """Both dataflows of the head: the reference (upsample + concat +
    conv2) and the fused head, whose Pallas kernels JAX runs
    interpreted on the CPU and the port runs as plain versions."""
    kw = dict(in_channels=24, out_channels=2, prior=prior, act="Softplus",
              fused_upsample=dataflow)
    fm = rng.rand(1, 16, 20, 24).astype(np.float32)
    img = rng.rand(1, 64, 80, 3).astype(np.float32)
    jmodel = jm.KeypointDet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(fm), jnp.asarray(img))
    variables = randomize(jax.tree.map(np.asarray, variables), rng)
    ref = jmodel.apply(variables, jnp.asarray(fm), jnp.asarray(img))
    tmodel = tm.KeypointDet(**kw)
    tmodel.load_state_dict(head_state_dict(variables))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(fm), torch.from_numpy(img))
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got, ref)


def test_keypoint_det_unported_dataflows_raise():
    for mode in ("always", "phase"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.KeypointDet(in_channels=8, fused_upsample=mode)


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
    with pytest.raises(NotImplementedError, match="stage 1"):
        tmodel({"im1": im, "im2": im}, train=True)
    # the bf16 head has no backward in the port; extraction still runs
    bf = tm.PoSFeat(SMALL_CONFIG, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(NotImplementedError, match="bf16"):
        bf({"im1": im, "im2": im})
    with torch.no_grad():
        assert bf({"im1": im, "im2": im})["preds1"]["local_point"].shape == (1, 64, 96, 1)
