"""bf16 training of posfeat_tpu_torch against posfeat_tpu's bf16 training on
the CPU: one stage-1 step (Line2Window + EpipolarLoss_full, Adam 1e-4 on
the backbone, BatchNorm in training mode) and one stage-2 step (DiskLoss,
the head) from the same f32 weights, batch and draws, with
``compute_dtype: bfloat16``.

Both packages compute in bf16 and keep f32 parameters (JAX:
``param_dtype=float32``); their bf16 roundings differ where the ops
differ (XLA's and oneDNN's bf16 convs, the order of sums), so the
tolerances are those of a bf16 step, not of the f32 parity tests.

Stage 2 (measured: loss within 1.1e-3, the head's gradient at cosine
0.995 to JAX's, each tensor above 0.997) is held to the loss within rtol
2e-2 and the gradient at cosine >= 0.99. Stage 1's loss is held to rtol
2e-2 (measured 9.0e-3) and its four terms to 6e-2 (measured up to
4.2e-2). Its backbone gradient does not reach cosine 0.99 to JAX's: T =
60 turns the maps' bf16 rounding (3% in training mode) into a quarter of
a logit and flips the line search's argmax for many queries. Measured
at the weights held here: the port's bf16 gradient at cosine 0.678 to
JAX's bf16 one; to JAX's f32 gradient the port's at 0.728 and JAX's own
bf16 at 0.910. The full step is held at cosine >= 0.5; its two halves
are held apart, where
no argmax decides: the loss's gradient on the same bf16 maps (the port's
at cosine 0.9995 to JAX's f32 gradient on the same values and 0.9984 to
JAX's bf16 one, held at 0.99) and the backbone's backward under one
cotangent (cosine 0.9855 between the packages, each 0.9745 to f32; held
at 0.98)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.losses.disk_loss import DiskLoss as JaxDiskLoss
from posfeat_tpu.losses.epipolar_loss import EpipolarLoss_full as JaxEpipolarLoss
from posfeat_tpu.losses.preprocess import Preprocess_Line2Window as JaxLine2Window
from posfeat_tpu.models import PoSFeat as JaxPoSFeat
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict, from_jax_variables, head_state_dict
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.train import Trainer
from test_torch_stage1_train import EPIPOLAR, PREPROCESS, _stage1_config
from test_torch_train import DISK, G, _config
from torch_port_helpers import (SMALL_CONFIG, jax_disk_draws, jax_line2window_draws, jax_posfeat,
                                torch_draws, torch_line2window_draws)

H, W = 64, 96
LOSS_RTOL = 2e-2
MIN_STAGE1_COSINE = 0.5
# stage 1's four terms each: T = 60 scales a cosine's bf16 rounding (~4e-3)
# to a quarter of a logit, and the halves of the loss average their errors
COMPONENT_RTOL, PERCENT_ATOL = 6e-2, 2e-2
MIN_COSINE, MIN_TENSOR_COSINE = 0.99, 0.95


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _hold_gradients(module, want, min_cosine=MIN_COSINE, min_tensor_cosine=MIN_TENSOR_COSINE):
    """The module's gradients against JAX's (torch-named numpy arrays):
    (cosine of the whole, the worst tensor and its cosine). A conv bias
    before a BatchNorm or InstanceNorm has a gradient of exactly 0 (the
    norm subtracts the channel mean), rounding in both packages: left out,
    as the f32 tests leave it out."""
    names = [n for n, _ in module.named_parameters() if not n.endswith("bias") or "bn" in n]
    got = {n: p.grad.float().numpy() for n, p in module.named_parameters()}
    whole = _cos(np.concatenate([got[n].ravel() for n in names]),
                 np.concatenate([want[n].ravel() for n in names]))
    norms = {n: np.linalg.norm(want[n]) for n in names}
    big = max(norms.values())
    per = {n: _cos(got[n], want[n]) for n in names if norms[n] > 1e-2 * big}
    worst = min(per, key=per.get)
    assert whole >= min_cosine and per[worst] >= min_tensor_cosine, (whole, worst, per[worst])
    return whole, worst, per[worst]


def _port_trainer(cfg, tmp_path, variables):
    tr = Trainer(copy.deepcopy(cfg), ckpt_root=str(tmp_path), device="cpu")
    sds = from_jax_variables(variables)
    tr.model.backbone.load_state_dict(sds["backbone"])
    tr.model.localheader.load_state_dict(sds["localheader"])
    assert tr.model.dtype == torch.bfloat16 and tr.model.backbone.dtype == torch.bfloat16
    return tr, sds


def test_stage1_bf16_step_matches_jax(tmp_path):
    """configs/train_desc.yaml's step at bf16 (Adam 1e-4): loss, components
    and the backbone's gradient against JAX's bf16 loss and jax.grad; after
    the step every parameter and statistic is f32 and the backbone moved.
    Unit weights, as in test_one_step_matches_jax_trainer (the std weights
    are decided by rounding)."""
    el_cfg = {**EPIPOLAR, "use_std_as_weight": False}
    cfg = _stage1_config(EpipolarLoss_full_config=el_cfg, compute_dtype="bfloat16", optimal_lrs=[1e-4])
    _, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    jmodel = JaxPoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=jnp.bfloat16)
    tr, sds = _port_trainer(cfg, tmp_path, variables)
    batch_np = collate([tr.train_dataset[i] for i in range(2)])
    jbatch = {k: jnp.asarray(batch_np[k]) for k in ("im1", "im2", "F1", "F2")}
    jvars = jax.tree.map(jnp.asarray, variables)
    jpp, jloss = JaxLine2Window(copy.deepcopy(PREPROCESS)), JaxEpipolarLoss(el_cfg)
    k_pp = jax.random.split(jax.random.PRNGKey(11))[0]

    def loss_fn(params):  # JaxTrainer._build_step's loss (trainer.py:276-305)
        v = {**jvars, "backbone": {**jvars["backbone"], "params": params}}
        out, _ = jmodel.forward(v, jbatch, train=True, mutable_bn=True)
        out["epoch"] = 1
        assert out["preds1"]["local_map"].dtype == jnp.bfloat16
        return jloss(jbatch, out, jpp(jbatch, out, k_pp))

    (l_ref, comps_ref), g_ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jvars["backbone"]["params"])
    # the same loss at f32, the yardstick of both bf16 gradients
    jmodel_f32 = JaxPoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=jnp.float32)

    def loss_f32(params):
        v = {**jvars, "backbone": {**jvars["backbone"], "params": params}}
        out, _ = jmodel_f32.forward(v, jbatch, train=True, mutable_bn=True)
        out["epoch"] = 1
        return jloss(jbatch, out, jpp(jbatch, out, k_pp))[0]

    g_f32 = jax.jit(jax.grad(loss_f32))(jvars["backbone"]["params"])
    ones = {"local_point": jnp.ones((2, H, W, 1))}
    draws = jax_line2window_draws(jpp, jbatch, {"preds1": ones, "preds2": ones}, k_pp)

    total, comps, grad_norms, finite = tr.train_step(
        tr.to_device(batch_np), 1, preprocess_draws=torch_line2window_draws(draws))
    assert finite and total.dtype == torch.float32
    np.testing.assert_allclose(float(total), float(l_ref), rtol=LOSS_RTOL)
    for k in ("loss_g1", "loss_w1", "loss_g2", "loss_w2"):
        np.testing.assert_allclose(float(comps[k]), float(comps_ref[k]), rtol=COMPONENT_RTOL, err_msg=k)
    for k in ("percent_g", "percent_w"):
        np.testing.assert_allclose(float(comps[k]), float(comps_ref[k]), atol=PERCENT_ATOL, err_msg=k)
    stats = jax.tree.map(np.asarray, variables["backbone"]["batch_stats"])
    g_want = backbone_state_dict({"params": jax.tree.map(np.asarray, g_ref), "batch_stats": stats})
    whole, _, _ = _hold_gradients(tr.model.backbone, {k: v.numpy() for k, v in g_want.items()},
                                  MIN_STAGE1_COSINE, MIN_STAGE1_COSINE - 0.2)
    w32 = backbone_state_dict({"params": jax.tree.map(np.asarray, g_f32), "batch_stats": stats})
    names = [n for n, _ in tr.model.backbone.named_parameters() if not n.endswith("conv.bias")]
    flat = lambda sd: np.concatenate([np.asarray(sd[n], np.float32).ravel() for n in names])  # noqa: E731
    port = np.concatenate([tr.model.backbone.get_parameter(n).grad.float().numpy().ravel() for n in names])
    print(f"stage 1 bf16: loss {float(total):.6g} vs {float(l_ref):.6g}, backbone gradient cosine {whole:.4f} "
          f"to JAX's bf16; to JAX's f32: the port's {_cos(port, flat(w32)):.4f}, JAX's bf16 "
          f"{_cos(flat(g_want), flat(w32)):.4f}")

    for name, v in tr.model.state_dict().items():
        assert v.dtype in (torch.float32, torch.int64), (name, v.dtype)
    for group in tr.optimizers["backbone"].state.values():
        assert all(t.dtype == torch.float32 for t in group.values()), group.keys()
    moved = [n for n, p in tr.model.backbone.named_parameters() if not torch.equal(p.detach(), sds["backbone"][n])]
    assert len(moved) > len(list(tr.model.backbone.parameters())) // 2, len(moved)
    # Adam's first update is lr · sign(g): 1e-4, kept by f32 parameters
    # (bf16 ones would round it away: their spacing at 0.1 is 5e-4)
    step = (tr.model.backbone.firstconv.weight.detach() - sds["backbone"]["firstconv.weight"]).abs()
    assert 0.9e-4 < float(step.max()) < 1.1e-4
    assert all(torch.equal(v, sds["localheader"][k]) for k, v in tr.model.localheader.state_dict().items())


def test_stage2_bf16_step_matches_jax(tmp_path):
    """configs/train_kp.yaml's step at bf16 (SGD on the head): loss,
    reinforce and the head's gradient against JAX's bf16 DiskLoss on the
    same draws; the head stays f32 and moves, the backbone does not."""
    _, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    jmodel = JaxPoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=jnp.bfloat16)
    tr, sds = _port_trainer(_config(compute_dtype="bfloat16"), tmp_path, variables)
    assert tr.model.localheader.fused_upsample is True  # the dilated composite at bf16
    batch_np = collate([tr.train_dataset[i] for i in range(2)])
    jbatch = {k: jnp.asarray(batch_np[k]) for k in ("im1", "im2", "F1", "F2")}
    jvars = jax.tree.map(jnp.asarray, variables)
    key = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(9))[1], 0)
    jloss = JaxDiskLoss(copy.deepcopy(DISK))

    def loss_fn(head_params):
        v = dict(jvars)
        v["localheader"] = {"params": head_params}
        outputs = jmodel.forward(v, jbatch, train=False)
        outputs["epoch"] = 1
        loss, comps = jloss(jbatch, outputs, None, key=key)
        return loss, (comps, outputs["preds1"]["local_point"], outputs["preds2"]["local_point"])

    (l_ref, (comps_ref, kp1, kp2)), g_ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jvars["localheader"]["params"])
    draws = jax_disk_draws(np.asarray(kp1, np.float32), np.asarray(kp2, np.float32), key, G)
    total, comps, grad_norms, finite = tr.train_step(tr.to_device(batch_np), 1, draws=torch_draws(draws))
    assert finite
    np.testing.assert_allclose(float(total), float(l_ref), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(comps["reinforce"]), float(comps_ref["reinforce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(comps["n_pairs"]), float(comps_ref["n_pairs"]), rtol=LOSS_RTOL)
    g_want = head_state_dict({"params": jax.tree.map(np.asarray, g_ref)})
    whole, worst, worst_cos = _hold_gradients(tr.model.localheader, {k: v.numpy() for k, v in g_want.items()})
    print(f"stage 2 bf16: loss {float(total):.6g} vs {float(l_ref):.6g}, head gradient cosine {whole:.4f} "
          f"(worst tensor {worst} {worst_cos:.4f})")
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert any(not torch.equal(v, sds["localheader"][k]) for k, v in tr.model.localheader.state_dict().items())
    assert all(torch.equal(v, sds["backbone"][k]) for k, v in tr.model.backbone.state_dict().items())


@pytest.mark.parametrize("stage", ["desc", "kp"])
def test_bf16_run_writes_f32_checkpoints(tmp_path, stage):
    """A two-step bf16 run of each stage: finite losses, and checkpoints
    whose every tensor is f32 (or an integer count), which load into an
    f32 model and into the JAX package's ``torch_import``."""
    import json

    from posfeat_tpu.core.torch_import import import_resunet
    from posfeat_tpu_torch.models import PoSFeat

    cfg = (_stage1_config if stage == "desc" else _config)(compute_dtype="bfloat16", checkpoint_name=stage)
    Trainer(cfg, ckpt_root=str(tmp_path), device="cpu").train()
    run = tmp_path / stage
    assert all(np.isfinite(json.loads(x)["total_loss"]) for x in open(run / "metrics.jsonl"))
    sds = {m: torch.load(run / "001" / f"{m}.pth", weights_only=True) for m in ("backbone", "localheader")}
    for sd in sds.values():
        assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    f32 = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu")
    f32.backbone.load_state_dict(sds["backbone"])
    f32.localheader.load_state_dict(sds["localheader"])
    jvars = import_resunet({k: v.numpy() for k, v in sds["backbone"].items()})
    np.testing.assert_array_equal(np.asarray(jvars["params"]["encoder"]["firstconv"]["kernel"]),
                                  sds["backbone"]["firstconv.weight"].numpy().transpose(2, 3, 1, 0))


def test_stage1_bf16_loss_gradient_on_the_same_maps(rng):
    """Line2Window + EpipolarLoss_full on the same bf16 descriptor maps in
    both packages, same draws: the loss, and its gradient with respect to
    the maps against JAX's f32 gradient on the same values (cosine >=
    0.99) and JAX's bf16 one (>= 0.99)."""
    from posfeat_tpu_torch.data.synthetic import SyntheticPairs
    from posfeat_tpu_torch.losses import EpipolarLoss_full, Preprocess_Line2Window

    el_cfg = {**EPIPOLAR, "use_std_as_weight": False}
    b = collate([SyntheticPairs(_stage1_config()["data_config_train"])[i] for i in range(2)])
    jb = {k: jnp.asarray(b[k]) for k in ("im1", "im2", "F1", "F2")}
    tb = {k: torch.from_numpy(np.asarray(b[k], np.float32)) for k in ("im1", "im2", "F1", "F2")}
    # bf16 values, so that the f32 reference reads the same maps
    maps = [torch.from_numpy(rng.randn(2, H // 4, W // 4, 32).astype(np.float32)).bfloat16().float().numpy()
            for _ in range(2)]
    jpp, jl = JaxLine2Window(copy.deepcopy(PREPROCESS)), JaxEpipolarLoss(el_cfg)
    k_pp = jax.random.PRNGKey(3)
    ones = jnp.ones((2, H, W, 1))
    draws = jax_line2window_draws(jpp, jb, {"preds1": {"local_point": ones}, "preds2": {"local_point": ones}}, k_pp)

    def jax_loss(m1, m2):
        out = {"preds1": {"local_map": m1, "local_point": ones},
               "preds2": {"local_map": m2, "local_point": ones}, "epoch": 1}
        return jl(jb, out, jpp(jb, out, k_pp))[0]

    ref = {}
    for dt in (jnp.float32, jnp.bfloat16):
        loss, g = jax.value_and_grad(jax_loss, argnums=(0, 1))(*(jnp.asarray(m).astype(dt) for m in maps))
        ref[dt] = (float(loss), np.concatenate([np.asarray(x, np.float32).ravel() for x in g]))
    ts = [torch.from_numpy(m).bfloat16().requires_grad_() for m in maps]
    out = {"preds1": {"local_map": ts[0], "local_point": torch.ones(2, H, W, 1)},
           "preds2": {"local_map": ts[1], "local_point": torch.ones(2, H, W, 1)}, "epoch": 1}
    pp = Preprocess_Line2Window(copy.deepcopy(PREPROCESS))
    loss = EpipolarLoss_full(el_cfg)(tb, out, pp(tb, out, None, draws=torch_line2window_draws(draws)))[0]
    loss.backward()
    got = np.concatenate([t.grad.float().numpy().ravel() for t in ts])
    np.testing.assert_allclose(float(loss.detach()), ref[jnp.bfloat16][0], rtol=LOSS_RTOL)
    print(f"stage 1 loss on the same bf16 maps: gradient cosine {_cos(got, ref[jnp.float32][1]):.5f} to JAX's "
          f"f32, {_cos(got, ref[jnp.bfloat16][1]):.5f} to its bf16; JAX's bf16 to its f32 "
          f"{_cos(ref[jnp.bfloat16][1], ref[jnp.float32][1]):.5f}")
    assert _cos(got, ref[jnp.float32][1]) >= MIN_COSINE, _cos(got, ref[jnp.float32][1])
    assert _cos(got, ref[jnp.bfloat16][1]) >= MIN_COSINE, _cos(got, ref[jnp.bfloat16][1])


def test_stage1_bf16_backbone_backward_matches_jax(rng):
    """The ResUNet at bf16 in training mode, f32 parameters: its local map
    (relative error to JAX's bf16 within 3e-2) and its parameters'
    gradient under one cotangent on the local map, at cosine >= 0.98 to
    JAX's bf16 gradient."""
    from posfeat_tpu.models import ResUNet as JaxResUNet
    from posfeat_tpu_torch.models.resunet import ResUNet

    _, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    cfg = SMALL_CONFIG["backbone_config"]
    x = rng.randn(2, H, W, 3).astype(np.float32)
    ct = rng.randn(2, H // 4, W // 4, cfg["fine_out_ch"]).astype(np.float32)
    model = ResUNet(**cfg, dtype=torch.bfloat16)
    model.load_state_dict(from_jax_variables(variables)["backbone"])
    model.train()
    out = model(torch.from_numpy(x))["local_map"]
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(ct)).sum().backward()
    jm = JaxResUNet(**cfg, dtype=jnp.bfloat16)
    jv = jax.tree.map(jnp.asarray, variables["backbone"])

    def f(params):
        o, _ = jm.apply({**jv, "params": params}, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(o["local_map"].astype(jnp.float32) * ct), o["local_map"]

    (_, ref_map), g = jax.value_and_grad(f, has_aux=True)(jv["params"])
    ref_map = np.asarray(ref_map, np.float32)
    err = np.linalg.norm(out.detach().float().numpy() - ref_map) / np.linalg.norm(ref_map)
    assert err < 3e-2, err
    want = backbone_state_dict({"params": jax.tree.map(np.asarray, g),
                                "batch_stats": jax.tree.map(np.asarray, variables["backbone"]["batch_stats"])})
    names = [n for n, _ in model.named_parameters() if "coarse" not in n and not n.endswith("conv.bias")]
    params = dict(model.named_parameters())
    c = _cos(np.concatenate([params[n].grad.numpy().ravel() for n in names]),
             np.concatenate([want[n].numpy().ravel() for n in names]))
    assert c >= 0.98, c
