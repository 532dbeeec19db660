"""posfeat_tpu_torch's stage 1 on the CPU against posfeat_tpu: BatchNorm's
training step against flax's, Preprocess_Line2Window (both engines, the
matchers, the priors) on JAX's draws, EpipolarLoss_full, one Trainer step
against JaxTrainer._build_step, and a stage-1 run whose backbone.pth
feeds a stage-2 Trainer and the JAX package.

Tolerances: rtol 1e-3 / atol 2e-4 (the models' parity tolerance,
tests/test_models_parity.py:178,201), rtol 1e-3 / atol 1e-4 for the window
stage (tests/test_line_window.py:30). Queries whose line-stage argmax is
a near-tie (top-2 gap below MARGIN) may take another pixel in either
package: they are counted and left out of the comparison."""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from posfeat_tpu.core.torch_import import import_resunet
from posfeat_tpu.losses.epipolar_loss import EpipolarLoss_full as JaxEpipolarLoss
from posfeat_tpu.losses.preprocess import Preprocess_Line2Window as JaxLine2Window
from posfeat_tpu.models import ResUNet as JaxResUNet
from posfeat_tpu.ops.coords import normalize_coords
from posfeat_tpu.ops.epipolar import get_endpoints
from posfeat_tpu.ops.grid_sample import grid_sample as jgrid_sample
from posfeat_tpu.ops.grid_sample import l2_normalize, sample_feat_by_coord
from posfeat_tpu.train.trainer import Trainer as JaxTrainer
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict, from_jax_variables
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.losses import EpipolarLoss_full, Preprocess_Line2Window
from posfeat_tpu_torch.models.resunet import BatchNorm2d
from posfeat_tpu_torch.train import Trainer
from tests.test_ops_parity import rand_fundamental
from torch_port_helpers import SMALL_CONFIG, jax_line2window_draws, jax_posfeat, torch_line2window_draws

RTOL, ATOL = 1e-3, 2e-4
WIN_RTOL, WIN_ATOL = 1e-3, 1e-4
# a window std is Σ sqrt(E[x²] − E[x]²) over x and y in f32: in a peaked
# window the difference cancels to a few roundings of E[x²] (≤ 2), ~1e-6,
# whose square root is up to ~1e-3 per axis
STD_ATOL = 2e-3
MARGIN = 1e-3  # T-scaled cosines
# the reference engine's probes clamp at the border (grid_sample 'border'),
# where several sample one pixel and tie exactly: a tenth of the queries
KEEP = 0.85
H, W = 64, 96
# configs/train_desc.yaml's preprocess at these small maps: grid 8 gives
# 96 queries per image (two JAX chunks of 64), window 0.25 a 4×6 window
# on the 16×24 descriptor map (0.1 would leave 1×2)
PREPROCESS = {
    "kps_generator": "generate_kpts_regular_grid_random",
    "kps_generator_config": {"grid_size": 8, "map_init": "identity", "keep_spatial": True,
                             "random_select": "random"},
    "window_size": 0.25, "loss_distance": "cos", "use_nn_grid": False, "use_line_search": True,
    "line_search_config": {"line_step": 100, "use_nn": True, "loc_rand": True},
    "temperature_base": 60, "temperature_max": 60,
}
EPIPOLAR = {"grid_cost_thr": 0.5, "win_cost_thr": 0.1, "use_std_as_weight": True,
            "weight_grid": 0, "weight_window": 1}


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float32), _np(ref).astype(np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def test_batchnorm_training_step_matches_flax(rng):
    """Two training steps of the port's BatchNorm2d against flax's
    nn.BatchNorm(momentum=0.9, epsilon=1e-5): outputs and running
    statistics. With 24 values per channel, torch's unbiased running
    variance would be 24/23 of flax's, 4% off."""
    x1, x2 = (rng.randn(2, 2, 3, 4, 5) * [1.0, 2.0, 0.5, 3.0, 1.5] + 0.3).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x1))
    scale, bias = rng.uniform(0.5, 1.5, 5).astype(np.float32), rng.randn(5).astype(np.float32)
    mean0, var0 = rng.randn(5).astype(np.float32), rng.uniform(0.5, 1.5, 5).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    tbn = BatchNorm2d(5).train()
    tbn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                         "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0),
                         "num_batches_tracked": torch.tensor(0)})
    for x in (x1, x2):
        y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **upd}
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _close(got, y, 1e-5, 1e-5)
        _close(tbn.running_mean, upd["batch_stats"]["mean"], 1e-5, 1e-6, "mean")
        _close(tbn.running_var, upd["batch_stats"]["var"], 1e-5, 1e-6, "var")
    assert int(tbn.num_batches_tracked) == 2
    tbn.eval()  # eval mode is torch's, on the running statistics
    bn_eval = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    _close(tbn(torch.from_numpy(x1).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           bn_eval.apply(variables, jnp.asarray(x1)), 1e-5, 1e-5)


def _pp_inputs(rng, B=2, D=32):
    lm1, lm2 = rng.randn(2, B, H // 4, W // 4, D).astype(np.float32)
    lp1, lp2 = rng.rand(2, B, H, W, 1).astype(np.float32)
    im1, im2 = rng.rand(2, B, H, W, 3).astype(np.float32)
    F1 = rand_fundamental(rng, B).astype(np.float32)
    F2 = np.ascontiguousarray(F1.transpose(0, 2, 1))
    inputs = {"im1": im1, "im2": im2, "F1": F1, "F2": F2}
    outputs = {"preds1": {"local_map": lm1, "local_point": lp1},
               "preds2": {"local_map": lm2, "local_point": lp2}}
    return inputs, outputs


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _argmax_gaps(cfg, jin, jout, ref):
    """Per direction, the top-2 gap of the line stage's argmax on JAX's own
    values ([B, N]; inf where nothing ties): the band-masked correlation map
    (fused engine) or the line probes' similarity (reference engine)."""
    T = float(ref["temperature"])
    ws_cos = cfg["loss_distance"] == "cos"
    gaps = []
    for i, j in ((1, 2), (2, 1)):
        xf_q, xf_r = jout[f"preds{i}"]["local_map"], jout[f"preds{j}"]["local_map"]
        h, w = jin[f"im{j}"].shape[1:3]
        hq, wq = jin[f"im{i}"].shape[1:3]
        coord = ref[f"coord{i}"]
        f_q = sample_feat_by_coord(xf_q, normalize_coords(coord, hq, wq), ws_cos)
        fm = T * l2_normalize(xf_r, axis=-1)
        Fm = jin[f"F{i}"]
        if cfg.get("engine", "fused") == "fused":
            B, Hf, Wf, _ = fm.shape
            pf = jnp.einsum("bpd,byxd->bpyx", f_q, fm)
            cW, cH = (w - 1) / 2.0, (h - 1) / 2.0
            line = jnp.einsum("bij,bnj->bin", Fm, jnp.concatenate([coord, jnp.ones_like(coord[..., :1])], -1))
            a = line[:, 0] * (2 * cW / Wf)
            b = line[:, 1] * (2 * cH / Hf)
            c = line[:, 2] + line[:, 0] * (cW / Wf) + line[:, 1] * (cH / Hf)
            nrm = jnp.sqrt(a * a + b * b)
            ys, xs = np.mgrid[0:Hf, 0:Wf]
            dist = jnp.abs((a / nrm)[..., None, None] * xs + (b / nrm)[..., None, None] * ys
                           + (c / nrm)[..., None, None])
            vals = jnp.where(dist <= 0.71, pf, -jnp.inf).reshape(B, -1, Hf * Wf)
        else:
            steps = cfg["line_search_config"]["line_step"]
            e1, e2, _ = get_endpoints(coord, Fm, h, w)
            ts = jnp.linspace(0.0, 1.0, steps)[:, None]
            s = jgrid_sample(fm, (e2 - e1)[:, :, None] * ts + e1[:, :, None], "border")
            vals = jnp.einsum("bnsd,bnd->bns", s, f_q)
        top = np.sort(np.asarray(vals), -1)
        with np.errstate(invalid="ignore"):
            gaps.append(np.nan_to_num(top[..., -1] - top[..., -2], nan=np.inf))
    return gaps


CASES = {
    "fused": {},
    "reference": {"engine": "reference"},
    "fused_sinkhorn_ssim_regular": {"match_prob": "ot_sinkhorn", "sinkhorn_iters": 5,
                                    "kps_generator_config": {"grid_size": 8, "map_init": "SSIM",
                                                             "random_select": "regular_random"}},
    "reference_unmatch_d2_mean": {"engine": "reference", "match_prob": "ot_sinkhorn_unmatch",
                                  "sinkhorn_iters": 5,
                                  "kps_generator_config": {"grid_size": 8, "map_init": "D2"},
                                  "line_search_config": {"line_step": 60, "use_nn": False,
                                                         "loc_rand": False}},
    "no_line_search_dual_asl": {"use_line_search": False, "match_prob": "dual_softmax",
                                "kps_generator_config": {"grid_size": 8, "map_init": "ASL_Peak"}},
}
# outputs the line stage's argmax decides
_LINE_KEYS = {"feat1w_corloc": 1, "feat1c_corloc_org": 1, "feat1w_std": 1, "valid_epi1": 1,
              "feat2w_corloc": 2, "feat2c_corloc_org": 2, "feat2w_std": 2, "valid_epi2": 2}


@pytest.mark.parametrize("case", list(CASES))
def test_line2window_matches_jax(rng, case):
    """Every output key of Preprocess_Line2Window on JAX's draws, in the
    JAX trainer's key order (torch_port_helpers.jax_line2window_draws)."""
    cfg = {**copy.deepcopy(PREPROCESS), **copy.deepcopy(CASES[case])}
    inputs, outputs = _pp_inputs(rng)
    jin, jout = _jax_tree(inputs), _jax_tree(outputs)
    jout["epoch"] = 1
    jpp = JaxLine2Window(copy.deepcopy(cfg))
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda i, o, k: jpp(i, {**o, "epoch": 1}, k))(
        jin, {k: v for k, v in jout.items() if k != "epoch"}, key)
    draws = torch_line2window_draws(jax_line2window_draws(jpp, jin, jout, key))
    tin, tout = _torch_tree(inputs), _torch_tree(outputs)
    tout["epoch"] = 1
    pp = Preprocess_Line2Window(copy.deepcopy(cfg))
    got = pp(tin, tout, draws=draws)
    assert set(got) == set(ref)
    keep = {1: np.ones((2, 96), bool), 2: np.ones((2, 96), bool)}
    if cfg["use_line_search"] and cfg["line_search_config"]["use_nn"]:
        gaps = _argmax_gaps(cfg, jin, jout, ref)
        keep = {1: gaps[0] > MARGIN, 2: gaps[1] > MARGIN}
        assert min(k.mean() for k in keep.values()) >= KEEP, [k.mean() for k in keep.values()]
    for k, r in ref.items():
        g = got[k]
        if k == "temperature":
            assert g == r
            continue
        assert tuple(g.shape) == r.shape, k
        sel = keep[_LINE_KEYS[k]] if k in _LINE_KEYS else slice(None)
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(_np(g)[sel], np.asarray(r)[sel], err_msg=k)
        elif k in ("feat1w_std", "feat2w_std"):
            _close(_np(g)[sel], np.asarray(r)[sel], WIN_RTOL, STD_ATOL, k)
        elif k in ("feat1w_corloc", "feat2w_corloc"):
            _close(_np(g)[sel], np.asarray(r)[sel], WIN_RTOL, WIN_ATOL, k)
        else:
            _close(_np(g)[sel], np.asarray(r)[sel], msg=k)
    # the port draws for itself as JAX does: the same shapes and kinds
    mine = pp.draw(tin, tout, torch.Generator().manual_seed(0))
    for a, b in zip(mine["kps"], draws["kps"]):
        assert a.shape == b.shape and a.dtype == b.dtype
    for name in ("jitter1", "jitter2"):
        assert (mine[name] is None) == (draws[name] is None)
        if mine[name] is not None:
            assert mine[name].shape == draws[name].shape
    assert set(pp(tin, tout, torch.Generator().manual_seed(0))) == set(ref)


@pytest.mark.parametrize("use_std_as_weight", [True, False])
def test_epipolar_loss_matches_jax(rng, use_std_as_weight):
    """EpipolarLoss_full on one preprocess result handed to both: the
    loss and every component."""
    inputs, outputs = _pp_inputs(rng)
    jin, jout = _jax_tree(inputs), _jax_tree(outputs)
    jout["epoch"] = 1
    processed = JaxLine2Window(copy.deepcopy(PREPROCESS))(jin, jout, jax.random.PRNGKey(1))
    cfg = {**EPIPOLAR, "weight_grid": 0.5, "use_std_as_weight": use_std_as_weight}
    loss_ref, comps_ref = JaxEpipolarLoss(cfg)(jin, jout, processed)
    tproc = {k: v if k == "temperature" else torch.from_numpy(np.array(v)) for k, v in processed.items()}
    loss, comps = EpipolarLoss_full(cfg)(_torch_tree(inputs), None, tproc)
    _close(loss, loss_ref, msg="loss")
    assert set(comps) == set(comps_ref)
    for k in comps_ref:
        _close(comps[k], comps_ref[k], msg=k)
    assert 0 < float(comps["percent_w"]) < 1


def _stage1_config(**over):
    cfg = {
        "checkpoint_name": "desc", "epoch": 1, "epoch_step": 2, "lr_decay_step": 9,
        "lr_decay_factor": 0.1, "log_freq": 1, "grad_clip": False, "clip_norm": 10.0,
        "optimal_modules": ["backbone"], "optimal_lrs": [1e-3], "optimizer": "Adam",
        "compute_dtype": "float32", "seed": 0, "load_path": None, "model": "PoSFeat",
        "model_config": copy.deepcopy(SMALL_CONFIG), "data": "SyntheticPairs",
        "data_config_train": {"num_pairs": 6, "height": H, "width": W, "num_pts": 16,
                              "batch_size": 2, "workers": 2},
        "preprocess_train": "Preprocess_Line2Window",
        "preprocess_train_config": copy.deepcopy(PREPROCESS),
        "losses": ["EpipolarLoss_full"], "losses_weight": [1.0],
        "tb_component": ["loss_w1", "loss_w2", "percent_w"],
        "EpipolarLoss_full_config": copy.deepcopy(EPIPOLAR),
    }
    cfg.update(over)
    return cfg


def test_one_step_matches_jax_trainer(tmp_path):
    """One Trainer.train_step against JaxTrainer._build_step's jitted step
    (Adam 1e-3 on the backbone, BatchNorm in training mode, trainer.py:265-335)
    from the same weights, batch and draws: the loss and its components,
    the gradient norm, each backbone gradient (against jax.grad of the same
    loss), Adam's update and BatchNorm's running mean and variance.

    The loss is configs/train_desc.yaml's without ``use_std_as_weight``:
    at T = 60 on these random maps a few window variances fall to the
    1e-10 clamp (std 2e-5), where E[x²] − E[x]² is decided by rounding and
    the query's inverse-std weight is 25-50× the others', in JAX as here;
    the std-weighted loss is held on identical inputs in
    test_epipolar_loss_matches_jax."""
    el_cfg = {**EPIPOLAR, "use_std_as_weight": False}
    cfg = _stage1_config(EpipolarLoss_full_config=el_cfg)
    jmodel, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    tr = Trainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path), device="cpu")
    assert tr.train_backbone
    sds = from_jax_variables(variables)
    tr.model.backbone.load_state_dict(sds["backbone"])
    tr.model.localheader.load_state_dict(sds["localheader"])
    batch_np = collate([tr.train_dataset[i] for i in range(2)])
    jbatch = {k: jnp.asarray(batch_np[k]) for k in ("im1", "im2", "F1", "F2")}
    jvars = jax.tree.map(jnp.asarray, variables)

    # the JAX trainer's step, built on the pieces Trainer.__init__ would make
    ns = types.SimpleNamespace(config=cfg, steps_per_epoch=cfg["epoch_step"],
                               optimal_modules=["backbone"], optimal_lrs=[1e-3])
    ns._lr_schedule = lambda lr: JaxTrainer._lr_schedule(ns, lr)
    optimizer = JaxTrainer._build_optimizer(ns)
    jpp = JaxLine2Window(copy.deepcopy(PREPROCESS))
    jloss = JaxEpipolarLoss(el_cfg)
    ns.model, ns.preprocess, ns.optimizer = jmodel, jpp, optimizer
    ns.loss_fns, ns.train_backbone, ns._step_cache = [("EpipolarLoss_full", 1.0, jloss)], True, {}
    step = JaxTrainer._build_step(ns, 1)
    key = jax.random.PRNGKey(11)
    k_pp, _ = jax.random.split(key)

    def loss_fn(params):  # the step's loss (trainer.py:276-305), for its gradient
        v = {**jvars, "backbone": {**jvars["backbone"], "params": params}}
        out, _ = jmodel.forward(v, jbatch, train=True, mutable_bn=True)
        out["epoch"] = 1
        return jloss(jbatch, out, jpp(jbatch, out, k_pp))[0]

    g_ref = jax.jit(jax.grad(loss_fn))(jvars["backbone"]["params"])
    # map_init identity: the draws read only the score maps' shapes
    ones = {"local_point": jnp.ones((2, H, W, 1))}
    draws = jax_line2window_draws(jpp, jbatch, {"preds1": ones, "preds2": ones}, k_pp)
    trainable = {"backbone": jax.tree.map(jnp.array, jvars["backbone"]["params"])}  # donated
    new_tr, _, total_ref, comps_ref, gnorm_ref, finite_ref, bn_ref = step(
        trainable, optimizer.init(trainable), jvars, jbatch, key)
    assert bool(finite_ref)

    total, comps, grad_norms, finite = tr.train_step(
        tr.to_device(batch_np), 1, preprocess_draws=torch_line2window_draws(draws))
    assert finite
    _close(total, total_ref, msg="loss")
    for k in ("loss_g1", "loss_w1", "loss_g2", "loss_w2", "percent_g", "percent_w"):
        _close(comps[k], comps_ref[k], msg=k)
    _close(grad_norms["backbone"], gnorm_ref["backbone"], msg="grad norm")

    stats = jax.tree.map(np.asarray, variables["backbone"]["batch_stats"])
    g_want = backbone_state_dict({"params": jax.tree.map(np.asarray, g_ref), "batch_stats": stats})
    after = backbone_state_dict({"params": jax.tree.map(np.asarray, new_tr["backbone"]),
                                 "batch_stats": jax.tree.map(np.asarray, bn_ref["batch_stats"])})
    norm = float(gnorm_ref["backbone"])
    before = sds["backbone"]
    for name, p in tr.model.backbone.named_parameters():
        g, want = p.grad.numpy(), g_want[name].numpy()
        if name.startswith("conv_coarse."):
            # the global branch: stage 1's loss reads only local_map
            assert not np.abs(g).any() and not np.abs(want).any(), name
            assert torch.equal(p.detach(), before[name]), name
            continue
        if name.endswith("conv.bias"):
            # a conv bias before BatchNorm has a gradient of exactly 0 (the
            # channel mean is subtracted): rounding in both packages
            assert np.abs(g).max() <= 1e-6 * norm and np.abs(want).max() <= 1e-6 * norm, name
            continue
        _close(g, want, RTOL, ATOL * np.abs(want).max(), name)
        # Adam's first update is lr · sign(g) wherever |g| >> 1e-8: held to
        # JAX's where the sign is clear of rounding
        clear = np.abs(want) > 1e-3 * np.abs(want).max()
        assert clear.mean() > 0.5, name
        _close(p.detach().numpy()[clear], after[name].numpy()[clear], 1e-6, 1e-7, name)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - before[name].numpy()), 1e-3 * 1.001)
    for name, v in tr.model.backbone.state_dict().items():
        if "running" in name:  # two updates, image 1's batch then image 2's
            _close(v, after[name], msg=name)
            assert not torch.equal(v, before[name]), name
    assert int(tr.model.backbone.firstbn.num_batches_tracked) == 2
    # the head is frozen and untouched
    for k, v in tr.model.localheader.state_dict().items():
        assert torch.equal(v, sds["localheader"][k]), k


def test_stage1_checkpoint_feeds_stage2_and_jax(tmp_path):
    """A two-step stage-1 run through the CLI on the CPU: its backbone.pth
    (running statistics included) loads as load_path into a stage-2
    Trainer, and into the JAX package through import_resunet, whose
    forward matches the port's."""
    import yaml

    from posfeat_tpu_torch.train.__main__ import main

    path = tmp_path / "desc.yaml"
    path.write_text(yaml.safe_dump(_stage1_config(val_config={"vis_topk": 5})))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        main(["--config", str(path), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    run = tmp_path / "ckpts" / "desc"
    assert sorted(os.listdir(run / "001")) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
    sd0 = torch.load(run / "000" / "backbone.pth", weights_only=True)
    sd = torch.load(run / "001" / "backbone.pth", weights_only=True)
    assert int(sd["firstbn.num_batches_tracked"]) == 4  # two steps, two views each
    for k in sd:
        if "running" in k:
            assert not torch.equal(sd[k], sd0[k]), k
    for k in ("firstconv.weight", "layer3.1.conv2.weight", "conv_fine.conv.weight"):
        assert not torch.equal(sd[k], sd0[k]), k
    # the global branch gets no gradient: stage 1's loss reads only local_map
    assert torch.equal(sd["conv_coarse.conv.weight"], sd0["conv_coarse.conv.weight"])
    head0 = torch.load(run / "000" / "localheader.pth", weights_only=True)
    head1 = torch.load(run / "001" / "localheader.pth", weights_only=True)
    assert all(torch.equal(head0[k], head1[k]) for k in head0)

    stage2 = {
        "checkpoint_name": "kp", "epoch": 1, "epoch_step": 1, "lr_decay_step": 1,
        "lr_decay_factor": 0.1, "optimal_modules": ["localheader"], "optimal_lrs": [1e-3],
        "optimizer": "SGD", "seed": 1, "load_path": str(run / "001"), "model": "PoSFeat",
        "model_config": copy.deepcopy(SMALL_CONFIG), "data": "SyntheticPairs",
        "data_config_train": _stage1_config()["data_config_train"], "losses": [],
        "losses_weight": [],
    }
    tr = Trainer(stage2, ckpt_root=str(tmp_path / "s2"), device="cpu")
    for k, v in tr.model.backbone.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert not tr.train_backbone

    jvars = import_resunet({k: v.numpy() for k, v in sd.items()})
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(jvars["batch_stats"]["encoder"]["firstbn"][k]),
                                      sd[f"firstbn.running_{k}"].numpy())
    x = np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32)
    ref = JaxResUNet(**SMALL_CONFIG["backbone_config"]).apply(jax.tree.map(jnp.asarray, jvars),
                                                             jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tr.model.extract(torch.from_numpy(x))
    for k in ("local_map", "global_map"):
        _close(got[k], ref[k], msg=k)


def test_grid_and_std_weighted_loss_gradient_matches_jax(rng):
    """The convergence recipe's stage-1 loss (tools/convergence_experiment.py:
    grid and window terms, std weights) on the same f32 descriptor maps
    and draws in both packages: its gradient with respect to the maps at
    cosine >= 0.99 to JAX's (measured 0.998). The loss itself is decided
    by rounding where a window's variance cancels (the std weights,
    PERF.md §6): it is printed, not held (measured 0.33% apart)."""
    from posfeat_tpu_torch.data.synthetic import SyntheticPairs

    el_cfg = {**EPIPOLAR, "use_std_as_weight": True, "weight_grid": 1.0}
    b = collate([SyntheticPairs(_stage1_config()["data_config_train"])[i] for i in range(2)])
    jb = {k: jnp.asarray(b[k]) for k in ("im1", "im2", "F1", "F2")}
    tb = {k: torch.from_numpy(np.asarray(b[k], np.float32)) for k in ("im1", "im2", "F1", "F2")}
    maps = [rng.randn(2, H // 4, W // 4, 32).astype(np.float32) for _ in range(2)]
    jpp, jl = JaxLine2Window(copy.deepcopy(PREPROCESS)), JaxEpipolarLoss(el_cfg)
    k_pp = jax.random.PRNGKey(3)
    ones = jnp.ones((2, H, W, 1))
    draws = jax_line2window_draws(jpp, jb, {"preds1": {"local_point": ones}, "preds2": {"local_point": ones}}, k_pp)

    def jax_loss(m1, m2):
        out = {"preds1": {"local_map": m1, "local_point": ones},
               "preds2": {"local_map": m2, "local_point": ones}, "epoch": 1}
        return jl(jb, out, jpp(jb, out, k_pp))[0]

    l_ref, g_ref = jax.value_and_grad(jax_loss, argnums=(0, 1))(*(jnp.asarray(m) for m in maps))
    ts = [torch.from_numpy(m).requires_grad_() for m in maps]
    out = {"preds1": {"local_map": ts[0], "local_point": torch.ones(2, H, W, 1)},
           "preds2": {"local_map": ts[1], "local_point": torch.ones(2, H, W, 1)}, "epoch": 1}
    loss = EpipolarLoss_full(el_cfg)(tb, out, Preprocess_Line2Window(copy.deepcopy(PREPROCESS))(
        tb, out, None, draws=torch_line2window_draws(draws)))[0]
    loss.backward()
    got = np.concatenate([t.grad.numpy().ravel() for t in ts]).astype(np.float64)
    want = np.concatenate([np.asarray(g).ravel() for g in g_ref]).astype(np.float64)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    print(f"grid + std-weighted loss on the same maps: {float(loss.detach()):.6g} vs {float(l_ref):.6g}, "
          f"gradient cosine {cos:.5f}")
    assert cos >= 0.99, cos
