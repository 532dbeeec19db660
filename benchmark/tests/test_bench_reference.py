"""The plain references (benchmark/reference/) against the port on the
CPU at a tiny size, on the benchmark's own seeded weights and inputs."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import traffic, weights  # noqa: E402
from benchmark.reference import extraction as ref  # noqa: E402
from benchmark.reference import quant  # noqa: E402

FLAGSHIP = {
    "backbone": "ResUNet",
    "backbone_config": {"encoder": "resnet50", "pretrained": False, "coarse_out_ch": 128, "fine_out_ch": 128},
    "localheader": "KeypointDet",
    "localheader_config": {"in_channels": 192, "prior": "identity", "act": "Softplus"},
    "align_local_grad": False,
    "local_input_elements": ["local_map", "local_map_small"],
    "local_with_img": True,
}
H, W = 64, 96
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    from posfeat_tpu_torch.models import MODELS

    torch.manual_seed(0)
    params = weights.make(FLAGSHIP, 1234567890123, CPU)
    model = MODELS["PoSFeat"](FLAGSHIP, dtype=torch.float32, device="cpu", seed=0)
    model.backbone.load_state_dict(weights.module_state(params, "backbone"))
    model.localheader.load_state_dict(weights.module_state(params, "localheader"))
    gen = torch.Generator().manual_seed(7)
    ims = traffic.textures(gen, 2, H, W, CPU)
    return params, model, ims


def test_weights_are_the_ports_leaves(setup):
    params, model, _ims = setup
    for prefix in ("backbone", "localheader"):
        ours = weights.module_state(params, prefix)
        theirs = getattr(model, prefix).state_dict()
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            assert ours[k].shape == v.shape, k


@torch.no_grad()
def test_forward_matches_the_port(setup):
    params, model, ims = setup
    im = ref.normalize_image(ims)
    out = model.extract(im)
    score, local = ref.forward(params, ims)
    torch.testing.assert_close(local.permute(0, 2, 3, 1), out["local_map"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(score, out["local_point"][..., 0], rtol=1e-4, atol=1e-5)


@torch.no_grad()
def test_detector_and_sampler_match_the_port(setup):
    from posfeat_tpu_torch.ops.coords import denormalize_coords
    from posfeat_tpu_torch.ops.detect import generate_kpts_single
    from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord

    params, _model, ims = setup
    score, local = ref.forward(params, ims)
    kn, ks, valid = generate_kpts_single(score[..., None], num_pts=128, nms_radius=1, use_nms=True, thr=0.9,
                                         thr_mod="abs", stable=True)
    for b in range(2):
        kpt, sc, desc = ref.slate(score[b], local[b: b + 1], 128, 1, 0.9)
        n = kpt.shape[0]
        assert n == ref.emitted(int(valid[b]), 128)
        torch.testing.assert_close(kpt, denormalize_coords(kn[b], H, W)[:n], rtol=0, atol=1e-4)
        torch.testing.assert_close(sc, ks[b, :n], rtol=0, atol=0)
        port = sample_feat_by_coord(local[b: b + 1].permute(0, 2, 3, 1), kn[b: b + 1, :n], True)[0]
        torch.testing.assert_close(desc, port, rtol=0, atol=1e-5)


def test_nms_breaks_ties_to_the_lower_index():
    s = torch.zeros(1, 4, 5)
    s[0, 1, 1] = s[0, 1, 2] = 1.0  # equal neighbours: the first in row-major order wins
    keep = ref.nms_mask(s, 1)
    assert keep[0, 1, 1] and not keep[0, 1, 2]


def test_stage2_matches_the_ports_trainer():
    """Three SGD steps of the stage-2 head: the reference against the
    port's Trainer on the same weights, pairs and draws."""
    from benchmark import harness
    from benchmark.jobs import train_kp

    spec = harness.load_spec()
    cell = harness.cell_entry(spec, "r50-f32.train-kp-480x640")
    tr = harness.traffic_of(cell)
    tr.update(height=H, width=W, batch_size=2, pool_batches=3)
    import tempfile

    ctx = harness.Context(cell["name"], 99, CPU, harness.config_of(spec, cell), tr, tempfile.mkdtemp())
    job = train_kp.Job(ctx)
    job.setup()
    r = job.readings()
    assert r["loss_gap"] < 1e-4 and r["grad_gap"] < 1e-4 and r["change_gap"] < 1e-4, r


@pytest.mark.parametrize("precision", quant.PRECISIONS)
def test_rounding_moves_values_by_its_precision(precision):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    rel = ((quant.rounder(precision)(x) - x).abs() / x.abs().clamp_min(1e-3)).max().item()
    bits = {"tf32": 10}[precision]
    assert 2.0 ** -(bits + 3) < rel <= 2.0 ** -bits * 1.01
