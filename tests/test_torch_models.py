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
from torch_port_helpers import jax_posfeat, port_posfeat, randomize

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
