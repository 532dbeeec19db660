"""posfeat_tpu_torch's ResUNetHR against posfeat_tpu's, f32, with the
weights carried across by from_jax_variables (the JAX layout keeps the
HR stem and layers at its top level). Tolerance: the JAX suite's model
parity, rtol 1e-3 / atol 2e-4 (tests/test_models_parity.py:178,201).

Its local map is at H/2, where the fused head's dataflows (derived for a
×4 trunk) do not apply: the JAX head takes the reference dataflow there
under "pallas" (keypoint_det.py:537-539), and so does the port's, with a
warning.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu import models as jm
from posfeat_tpu_torch import models as tm
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict
from test_torch_extract import DET, _config
from test_torch_extract_remainders import _slates_close
from torch_port_helpers import SMALL_CONFIG, jax_posfeat, port_posfeat, randomize

RTOL, ATOL = 1e-3, 2e-4
HR_CONFIG = copy.deepcopy(SMALL_CONFIG)
HR_CONFIG["backbone"] = "ResUNetHR"
H, W = 64, 96


def test_resunet_hr_matches_jax(rng):
    kw = dict(encoder="resnet18", coarse_out_ch=32, fine_out_ch=48)
    x = rng.rand(2, 64, 80, 3).astype(np.float32)
    jmodel = jm.ResUNetHR(**kw)
    variables = randomize(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))), rng)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    tmodel = tm.ResUNetHR(**kw).eval()
    tmodel.load_state_dict(backbone_state_dict(variables))  # strict: every name maps
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got["local_map"].shape == (2, 32, 40, 48) and got["local_map_small"].shape == (2, 32, 40, 64)
    for key in ("global_map", "local_map", "local_map_small"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert tm.BACKBONES["ResUNetHR"] is tm.ResUNetHR


def test_posfeat_hr_extract_matches_jax(rng):
    jmodel, variables = jax_posfeat(HR_CONFIG, seed=2, im_shape=(1, H, W, 3))
    model = port_posfeat(variables, HR_CONFIG)
    x = rng.rand(2, H, W, 3).astype(np.float32)
    ref = jmodel.extract(jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False)
    got = model.extract(torch.from_numpy(x))
    assert got["local_point"].shape == (2, H, W, 1) and got["local_map"].shape == (2, H // 2, W // 2, 32)
    for key in ("local_map", "local_point", "local_thr", "global_feat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hr_head_takes_the_reference_dataflow_with_a_word(rng, dtype):
    """At an H/2 trunk, "pallas" computes what False computes, in both
    packages; the port says so once."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    kw = dict(in_channels=16, out_channels=1, prior="identity", act="Softplus")
    fm = rng.randn(2, H // 2, W // 2, 16).astype(np.float32)
    im = rng.randn(2, H, W, 3).astype(np.float32)
    jref = jm.KeypointDet(**kw, fused_upsample=False, dtype=jdt)
    v = randomize(jax.tree.map(np.asarray, jref.init(jax.random.PRNGKey(0), jnp.asarray(fm), jnp.asarray(im))),
                  rng)
    out_j = {fu: np.asarray(jm.KeypointDet(**kw, fused_upsample=fu, dtype=jdt).apply(
        v, jnp.asarray(fm), jnp.asarray(im)), np.float32) for fu in (False, "pallas")}
    np.testing.assert_array_equal(out_j["pallas"], out_j[False])

    from posfeat_tpu_torch.core.jax_weights import head_state_dict

    out_t = {}
    for fu in (False, "pallas"):
        head = tm.KeypointDet(**kw, fused_upsample=fu, dtype=tdt).eval()
        head.load_state_dict(head_state_dict(v))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.no_grad():
                out_t[fu] = head(torch.from_numpy(fm), torch.from_numpy(im)).float().numpy()
                head(torch.from_numpy(fm), torch.from_numpy(im))  # warned once per head
        said = [w for w in caught if "reference dataflow" in str(w.message)]
        assert len(said) == (1 if fu == "pallas" else 0), [str(w.message) for w in caught]
    np.testing.assert_array_equal(out_t["pallas"], out_t[False])
    if dtype == "float32":
        np.testing.assert_allclose(out_t[False], out_j[False], rtol=RTOL, atol=ATOL)


def test_hr_extraction_program_matches_jax(tmp_path, rng):
    """An f32 Extractor on a ResUNetHR model against the JAX extraction
    program on the same weights."""
    from posfeat_tpu.ops.coords import denormalize_coords
    from posfeat_tpu.ops.detect import generate_kpts_single
    from posfeat_tpu.ops.grid_sample import sample_feat_by_coord
    from posfeat_tpu_torch.extract import Extractor
    from torch_port_helpers import save_both_checkpoints

    ck = tmp_path / "ck"
    jmodel, variables = save_both_checkpoints(ck, HR_CONFIG, seed=3, im_shape=(1, H, W, 3))
    ims = (rng.rand(2, H, W, 3) * 255).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    det = dict(DET, refine="quad")

    def jax_program(v, im_u8):
        out = jmodel.extract(v, (im_u8.astype(jnp.float32) / 255.0 - mean) / std, train=False)
        coord_n, score, valid = generate_kpts_single(out["local_point"], **det)
        feat = sample_feat_by_coord(out["local_map"], coord_n, norm=True)
        return denormalize_coords(coord_n, H, W), score, feat, valid

    ref = jax.jit(jax_program)(jax.tree.map(jnp.asarray, variables), jnp.asarray(ims))
    cfg = _config(tmp_path, "hr", ck)
    cfg["model_config"] = copy.deepcopy(HR_CONFIG)
    cfg["detector_config"] = det
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    got = [t.numpy() for t in ex._learned_fn((H, W), "detector_config")(torch.from_numpy(ims))]
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]))
    for j in range(2):
        _slates_close(got[0][j], got[1][j], got[2][j], *(np.asarray(r[j]) for r in ref[:3]))
