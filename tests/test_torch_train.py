"""posfeat_tpu_torch's stage-2 Trainer on the CPU: one step against the
JAX trainer's loss and SGD update from the same weights and draws, the
optimizers, schedule and clipping against optax, the non-finite guard,
and the run directory (epoch checkpoints, resume, FileExistsError)."""

import copy
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posfeat_tpu.losses.disk_loss import DiskLoss as JaxDiskLoss
from posfeat_tpu.train.trainer import Trainer as JaxTrainer
from posfeat_tpu_torch.core.jax_weights import from_jax_variables, head_state_dict, to_jax_head_params
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.data.synthetic import SyntheticPairs
from posfeat_tpu_torch.train import Trainer
from posfeat_tpu_torch.train.trainer import clip_by_global_norm_
from torch_port_helpers import SMALL_CONFIG, jax_disk_draws, jax_posfeat, torch_draws

H, W, G = 64, 96, 8
DISK = {
    "grid_size": G, "loss_distance": "cos", "temperature_base": 60, "temperature_max": 60,
    "epipolar_reward": "constant_reward", "reward_config": {"reward_thr": 4, "rescale_thr": False},
    "cor_detach": True, "good_reward": 1, "bad_reward": -0.25, "kp_penalty": -0.001,
    "match_grad": False,
}


def _config(**over):
    cfg = {
        "checkpoint_name": "kp", "epoch": 1, "epoch_step": 2, "lr_decay_step": 1,
        "lr_decay_factor": 0.1, "log_freq": 1, "grad_clip": False, "clip_norm": 10.0,
        "optimal_modules": ["localheader"], "optimal_lrs": [0.05], "optimizer": "SGD",
        "compute_dtype": "float32", "seed": 0, "load_path": None, "model": "PoSFeat",
        "model_config": copy.deepcopy(SMALL_CONFIG), "data": "SyntheticPairs",
        "data_config_train": {"num_pairs": 6, "height": H, "width": W, "num_pts": 16,
                              "batch_size": 2, "workers": 2},
        "losses": ["DiskLoss"], "losses_weight": [1.0], "tb_component": ["reinforce"],
        "DiskLoss_config": copy.deepcopy(DISK),
    }
    cfg.update(over)
    return cfg


def _trainer(tmp_path, **over):
    return Trainer(_config(**over), ckpt_root=str(tmp_path), device="cpu")


def test_one_step_matches_jax_gradient_and_sgd_update(tmp_path):
    """The JAX trainer's loss (model.forward(train=False) + DiskLoss,
    trainer.py:276-305) and its SGD update, against the port's
    train_step from the same weights and the same draws."""
    jmodel, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    tr = _trainer(tmp_path)
    sds = from_jax_variables(variables)
    tr.model.backbone.load_state_dict(sds["backbone"])
    tr.model.localheader.load_state_dict(sds["localheader"])
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
    draws = jax_disk_draws(np.asarray(kp1), np.asarray(kp2), key, G)

    total, comps, grad_norms, finite = tr.train_step(tr.to_device(batch_np), 1, draws=torch_draws(draws))
    # the port's streamed path, plain on CPU, at the descriptors' width
    assert finite and tr.loss_fns[0][2]._use_streamed(SMALL_CONFIG["backbone_config"]["fine_out_ch"])
    np.testing.assert_allclose(float(total), float(l_ref), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(float(comps["reinforce"]), float(comps_ref["reinforce"]), rtol=1e-3, atol=2e-4)
    g_want = head_state_dict({"params": jax.tree.map(np.asarray, g_ref)})
    for name, p in tr.model.localheader.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[name].numpy(), rtol=1e-3, atol=2e-4, err_msg=name)
    np.testing.assert_allclose(
        float(grad_norms["localheader"]), float(optax.global_norm(g_ref)), rtol=1e-3)
    # SGD at lr 0.05: the updated head, compared in JAX's layout
    tx = optax.sgd(0.05)
    upd, _ = tx.update(g_ref, tx.init(g_ref))
    want = optax.apply_updates(jvars["localheader"]["params"], upd)
    got = to_jax_head_params(tr.model.localheader.state_dict())["params"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=2e-4, err_msg=str(path))
    # the backbone is frozen and untouched
    for k, v in tr.model.backbone.state_dict().items():
        assert torch.equal(v, sds["backbone"][k]), k


def test_schedule_clip_and_optimizers_match_optax(tmp_path):
    cfg = _config(epoch_step=3, lr_decay_step=2, lr_decay_factor=0.5, optimal_lrs=[0.01])
    jax_sched = JaxTrainer._lr_schedule(
        types.SimpleNamespace(config=cfg, steps_per_epoch=3), 1.0)
    rng = np.random.RandomState(0)
    for opt_name, tx_fn in (("SGD", optax.sgd), ("Adam", optax.adam), ("AdamW", optax.adamw)):
        tr = Trainer({**cfg, "optimizer": opt_name, "checkpoint_name": opt_name},
                     ckpt_root=str(tmp_path), device="cpu")
        assert [tr._lr_factor(k) for k in range(14)] == [float(jax_sched(k)) for k in range(14)]
        params = tr.params["localheader"]
        jp = [p.detach().numpy().copy() for p in params]
        tx = tx_fn(lambda c: 0.01 * jax_sched(c))  # optax.adamw keeps its default decay
        state = tx.init(jp)
        for _ in range(8):  # crosses two decay boundaries
            gs = [rng.randn(*p.shape).astype(np.float32) for p in params]
            for p, g in zip(params, gs):
                p.grad = torch.from_numpy(g.copy())
            tr.optimizers["localheader"].step()
            tr.schedulers["localheader"].step()
            upd, state = tx.update(gs, state, jp)
            jp = optax.apply_updates(jp, upd)
        if opt_name == "AdamW":
            assert tr.optimizers["localheader"].param_groups[0]["weight_decay"] == 1e-4
        for p, w in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                       err_msg=opt_name)
    # per-module global-norm clip, above and below the limit
    for scale in (10.0, 0.01):
        gs = [rng.randn(4, 3).astype(np.float32) * scale, rng.randn(7).astype(np.float32) * scale]
        want, _ = optax.clip_by_global_norm(1.0).update(gs, optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in gs]
        clip_by_global_norm_(got, 1.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_non_finite_step_skips_the_update(tmp_path):
    """As the JAX step: gradients zeroed, optimizer state advanced (step
    count, Adam's moments decay), parameters unchanged, batch dumped."""
    tr = _trainer(tmp_path, optimizer="Adam", epoch_step=2)
    real = tr.loss_fns[0][2]
    calls = []

    def second_nan(*args, **kw):
        loss, comps = real(*args, **kw)
        calls.append(1)
        return (loss * float("nan") if len(calls) == 2 else loss), comps

    tr.loss_fns = [("DiskLoss", 1.0, second_nan)]
    head = tr.model.localheader
    snap = {}
    real_step = tr.train_step

    def spy(batch, epoch, draws=None):
        snap["before"] = {k: v.clone() for k, v in head.state_dict().items()}
        st = tr.optimizers["localheader"].state
        snap["m"] = {i: st[p]["exp_avg"].clone() for i, p in enumerate(head.parameters()) if p in st}
        return real_step(batch, epoch, draws)

    tr.train_step = spy
    tr.train()
    dumps = glob.glob(os.path.join(tr.save_root, "error_step*.npz"))
    assert [os.path.basename(d) for d in dumps] == ["error_step2.npz"]
    assert not np.isfinite(np.load(dumps[0])["loss"])
    for k, v in head.state_dict().items():
        assert torch.equal(v, snap["before"][k]), k
    st = tr.optimizers["localheader"].state
    for i, p in enumerate(head.parameters()):
        assert float(st[p]["step"]) == 2
        torch.testing.assert_close(st[p]["exp_avg"], 0.9 * snap["m"][i], rtol=1e-6, atol=0)
    assert tr.schedulers["localheader"].last_epoch == 2
    # only the finite step is logged
    assert [json.loads(x)["global_step"] for x in open(tr.metrics_path)] == [1]


def test_trainer_run_directory_and_resume(tmp_path):
    tr = _trainer(tmp_path)
    head0 = {k: v.clone() for k, v in tr.model.localheader.state_dict().items()}
    tr.train()
    root = tr.save_root
    assert sorted(d for d in os.listdir(root) if d.isdigit()) == ["000", "001"]
    assert sorted(os.listdir(os.path.join(root, "001"))) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
    recs = [json.loads(x) for x in open(os.path.join(root, "metrics.jsonl"))]
    assert [r["global_step"] for r in recs] == [1, 2] and all(np.isfinite(r["total_loss"]) for r in recs)
    assert {"reinforce", "kp_penalty", "cor mean", "n_pairs", "grad_norm/localheader"} <= set(recs[0])
    assert len(open(os.path.join(root, "step_times.jsonl")).readlines()) == 2
    saved = torch.load(os.path.join(root, "000", "localheader.pth"), weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in head0.items())
    with pytest.raises(FileExistsError):
        _trainer(tmp_path)
    tr2 = _trainer(tmp_path, resume=True, epoch=2)
    assert tr2.start_epoch == 2 and tr2.schedulers["localheader"].last_epoch == 2
    assert tr2.optimizers["localheader"].param_groups[0]["lr"] == pytest.approx(0.005)
    end1 = torch.load(os.path.join(root, "001", "localheader.pth"), weights_only=True)
    assert all(torch.equal(end1[k], v) for k, v in tr2.model.localheader.state_dict().items())
    tr2.train()
    assert sorted(d for d in os.listdir(root) if d.isdigit()) == ["000", "001", "002"]
    assert [json.loads(x)["global_step"] for x in open(os.path.join(root, "metrics.jsonl"))] == [1, 2, 3, 4]


def test_cli_and_deferred_options(tmp_path):
    import yaml

    from posfeat_tpu_torch.train.__main__ import main

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(_config(checkpoint_name="cli", epoch_step=1)))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        main(["--config", str(path), "--device", "cpu"])
        assert os.path.isdir(tmp_path / "ckpts" / "cli" / "001")
        with pytest.raises(FileExistsError):
            main(["--config", str(path), "--device", "cpu"])
        main(["--config", str(path), "--device", "cpu", "--overwrite"])
    finally:
        os.chdir(cwd)
    # multihost: once refused, now a one-process group over gloo constructs and
    # trains, as the JAX trainer does with one process
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mh = {"coordinator_address": f"localhost:{port}", "num_processes": 1, "process_id": 0,
          "backend": "gloo", "timeout_s": 60}
    try:
        tr = Trainer(_config(checkpoint_name="x", multihost=mh), ckpt_root=str(tmp_path / "d"), device="cpu")
        assert dist.is_initialized() and (tr.process_id, tr.num_processes) == (0, 1)
        tr.train()
        assert os.path.isdir(tmp_path / "d" / "x" / "001")
    finally:
        dist.destroy_process_group()
    # bf16 and MegaDepth_SIFT, once refused, now construct: a bf16 model with
    # f32 parameters, and the MegaDepth loader on a fixture in its layout
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    from make_megadepth_fixture import write_megadepth_fixture

    md = write_megadepth_fixture(str(tmp_path / "md"), n_scenes=1, n_images=3, height=H, width=W)
    dcfg = {"data_path": md, "prune_kp": False, "num_pts": 16, "random_percent": 0.5, "rot_thr": 80,
            "batch_size": 2, "workers": 2}
    for over in ({"compute_dtype": "bfloat16"}, {"data": "MegaDepth_SIFT", "data_config_train": dcfg}):
        tr = Trainer(_config(checkpoint_name="y", **over), ckpt_root=str(tmp_path / "e"), device="cpu",
                     overwrite=True)
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
        assert tr.model.dtype == getattr(torch, over.get("compute_dtype", "float32"))
        assert type(tr.train_dataset).__name__ == _config(**over)["data"] and len(tr.train_dataset) > 0
    # the backbone in optimal_modules now trains with BatchNorm in training
    # mode; DiskLoss reaches it only through the head's detached input and
    # the detached match distribution, so its gradient is 0, as in JAX
    tr = Trainer(_config(checkpoint_name="bb", optimal_modules=["backbone", "localheader"],
                         optimal_lrs=[1e-3, 1e-3]), ckpt_root=str(tmp_path / "d"), device="cpu")
    bb0 = {k: v.clone() for k, v in tr.model.backbone.state_dict().items()}
    batch = tr.to_device(collate([tr.train_dataset[i] for i in range(2)]))
    total, _, grad_norms, finite = tr.train_step(batch, 1)
    assert finite and float(grad_norms["backbone"]) == 0 and float(grad_norms["localheader"]) > 0
    moved = {k for k, v in tr.model.backbone.state_dict().items() if not torch.equal(v, bb0[k])}
    assert moved == {k for k in bb0 if "running" in k or "num_batches" in k}
    assert isinstance(SyntheticPairs(_config()["data_config_train"])[0]["im1"], np.ndarray)
