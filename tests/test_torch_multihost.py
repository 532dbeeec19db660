"""posfeat_tpu_torch's ``multihost:`` training on the CPU: two gloo ranks
(tools/multihost_torch.py) take one stage-2 step and one stage-1 step on a
global batch of 2 (one pair per rank), held against the JAX Trainer's
one-process step on the same global batch with the same draws (JAX's
multi-process step is its global-batch step by SPMD semantics), at the
models' tolerance rtol 1e-3 / atol 2e-4; the std-weighted epipolar loss
with unequal per-rank inverse-std means against JAX's on the whole batch;
the run directory's process gating; and the global non-finite skip.

One run of both ranks serves every test (a module fixture); each rank has
a 60 s process-group timeout and the launch 240 s, so a dead rank fails
the test instead of hanging."""

import copy
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posfeat_tpu.losses.disk_loss import DiskLoss as JaxDiskLoss
from posfeat_tpu.losses.epipolar_loss import EpipolarLoss_full as JaxEpipolarLoss
from posfeat_tpu.losses.preprocess import Preprocess_Line2Window as JaxLine2Window
from posfeat_tpu.train.trainer import Trainer as JaxTrainer
from posfeat_tpu_torch.core.jax_weights import backbone_state_dict, from_jax_variables, head_state_dict
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.data.synthetic import SyntheticPairs
from test_torch_stage1_train import EPIPOLAR, PREPROCESS, _stage1_config
from test_torch_train import DISK, G, H, W
from test_torch_train import _config as _stage2_config
from tests.test_ops_parity import rand_fundamental
from torch_port_helpers import jax_disk_draws, jax_line2window_draws, jax_posfeat

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import multihost_torch  # noqa: E402

RTOL, ATOL = 1e-3, 2e-4
WORLD = 2


def _epipolar_inputs(rng, B=4, N=48):
    """Random preprocess results for EpipolarLoss_full whose last B/2
    rows (rank 1's) have 4× the spreads, so the ranks' inverse-std means
    differ by 4×."""
    F1 = rand_fundamental(rng, B).astype(np.float32)
    inputs = {"im1": np.zeros((B, H, W, 3), np.float32), "F1": F1,
              "F2": np.ascontiguousarray(F1.transpose(0, 2, 1))}
    pp = {}
    for i in (1, 2):
        pp[f"coord{i}"] = (rng.rand(B, N, 2) * [W, H]).astype(np.float32)
        for k in ("g", "w"):
            pp[f"feat{i}{k}_corloc"] = (rng.rand(B, N, 2) * [W, H]).astype(np.float32)
            std = rng.uniform(0.01, 0.1, (B, N)).astype(np.float32)
            std[B // 2:] *= 4
            pp[f"feat{i}{k}_std"] = std
        pp[f"valid_epi{i}"] = rng.rand(B, N) > 0.2
    return inputs, pp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the two ranks' results and JAX's references."""
    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.RandomState(3)
    # weights: JAX's, in the port's files (a load_path both stages read)
    jmodel, variables = jax_posfeat(seed=4, im_shape=(1, H, W, 3))
    ck = tmp / "weights"
    ck.mkdir()
    sds = from_jax_variables(variables)
    for name, sd in sds.items():
        torch.save(sd, ck / f"{name}.pth")
    jvars = jax.tree.map(jnp.asarray, variables)
    # one global batch of 2 pairs for both stages
    s2 = _stage2_config(load_path=str(ck))
    ds = SyntheticPairs(s2["data_config_train"])
    batch_np = collate([ds[i] for i in range(2)])
    batch_np = {k: v for k, v in batch_np.items() if isinstance(v, np.ndarray)}
    np.savez(tmp / "batch.npz", **batch_np)
    jbatch = {k: jnp.asarray(batch_np[k]) for k in ("im1", "im2", "F1", "F2")}

    # stage 2's draws, on JAX's score maps
    key2 = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(9))[1], 0)
    out = jax.jit(lambda v: jmodel.forward(v, jbatch, train=False))(jvars)
    kp1, kp2 = (np.asarray(out[p]["local_point"]) for p in ("preds1", "preds2"))
    (p1, a1), (p2, a2) = jax_disk_draws(kp1, kp2, key2, G)
    np.savez(tmp / "draws2.npz", prop1=p1, acc1=a1, prop2=p2, acc2=a2)
    # stage 1's draws (map_init identity: they read only the maps' shapes)
    el_cfg = {**EPIPOLAR, "use_std_as_weight": False}
    s1 = _stage1_config(EpipolarLoss_full_config=el_cfg, load_path=str(ck), checkpoint_name="desc")
    jpp = JaxLine2Window(copy.deepcopy(PREPROCESS))
    key1 = jax.random.PRNGKey(11)
    k_pp, _ = jax.random.split(key1)
    ones = {"local_point": jnp.ones((2, H, W, 1))}
    d1 = jax_line2window_draws(jpp, jbatch, {"preds1": ones, "preds2": ones}, k_pp)
    np.savez(tmp / "draws1.npz", kps1=d1["kps"][0], kps2=d1["kps"][1], jitter1=d1["jitter1"],
             jitter2=d1["jitter2"])
    # the std-weighted epipolar loss's inputs
    e_in, e_pp = _epipolar_inputs(rng)
    e_cfg = {**EPIPOLAR, "weight_grid": 0.5, "use_std_as_weight": True}
    np.savez(tmp / "epi.npz", **{f"in/{k}": v for k, v in e_in.items()}, **{f"pp/{k}": v for k, v in e_pp.items()})

    spec = {
        "world": WORLD, "device": "cpu", "backend": "gloo", "timeout_s": 60, "out": str(tmp / "ranks"),
        "jobs": [
            {"kind": "loss", "name": "epi", "loss": "EpipolarLoss_full", "config": e_cfg,
             "inputs": str(tmp / "epi.npz")},
            {"kind": "step", "name": "kp", "config": s2, "batch": str(tmp / "batch.npz"),
             "draws": str(tmp / "draws2.npz"), "train_steps": 2},
            {"kind": "step", "name": "desc", "config": s1, "batch": str(tmp / "batch.npz"),
             "draws": str(tmp / "draws1.npz")},
            {"kind": "train", "name": "nan", "nan_rank": 1,
             "config": _stage2_config(load_path=str(ck), checkpoint_name="nan", epoch_step=1)},
        ],
    }
    # the ranks run while JAX computes the references
    import threading

    result = {}
    worker = threading.Thread(target=lambda: result.update(zip(("rcs", "outs", "s"),
                                                               multihost_torch.launch(spec, 240))))
    worker.start()
    try:
        ref = {"epi": JaxEpipolarLoss(e_cfg)({k: jnp.asarray(v) for k, v in e_in.items()}, None,
                                             {k: jnp.asarray(v) for k, v in e_pp.items()})}

        # stage 2: the JAX trainer's loss and SGD step (tests/test_torch_train.py)
        jloss = JaxDiskLoss(copy.deepcopy(DISK))

        def loss2(head_params):
            v = dict(jvars)
            v["localheader"] = {"params": head_params}
            outputs = jmodel.forward(v, jbatch, train=False)
            outputs["epoch"] = 1
            return jloss(jbatch, outputs, None, key=key2)

        (l2, c2), g2 = jax.jit(jax.value_and_grad(loss2, has_aux=True))(jvars["localheader"]["params"])
        tx = optax.sgd(0.05)
        upd, _ = tx.update(g2, tx.init(g2))
        ref["kp"] = (l2, c2, g2, optax.apply_updates(jvars["localheader"]["params"], upd))

        # stage 1: JaxTrainer._build_step (tests/test_torch_stage1_train.py)
        ns = types.SimpleNamespace(config=s1, steps_per_epoch=s1["epoch_step"],
                                   optimal_modules=["backbone"], optimal_lrs=[1e-3])
        ns._lr_schedule = lambda lr: JaxTrainer._lr_schedule(ns, lr)
        optimizer = JaxTrainer._build_optimizer(ns)
        jel = JaxEpipolarLoss(el_cfg)
        ns.model, ns.preprocess, ns.optimizer = jmodel, jpp, optimizer
        ns.loss_fns, ns.train_backbone, ns._step_cache = [("EpipolarLoss_full", 1.0, jel)], True, {}

        def loss1(params):
            v = {**jvars, "backbone": {**jvars["backbone"], "params": params}}
            o, _ = jmodel.forward(v, jbatch, train=True, mutable_bn=True)
            o["epoch"] = 1
            return jel(jbatch, o, jpp(jbatch, o, k_pp))[0]

        g1 = jax.jit(jax.grad(loss1))(jvars["backbone"]["params"])
        trainable = {"backbone": jax.tree.map(jnp.array, jvars["backbone"]["params"])}
        new_tr, _, t1, c1, gn1, fin1, bn1 = JaxTrainer._build_step(ns, 1)(
            trainable, optimizer.init(trainable), jvars, jbatch, key1)
        assert bool(fin1)
        ref["desc"] = (t1, c1, gn1, g1, new_tr, bn1)
    finally:
        worker.join()
    for r, (rc, out) in enumerate(zip(result["rcs"], result["outs"])):
        assert rc == 0 and f"RANK_OK {r}" in out, f"rank {r} failed ({rc}):\n{out[-4000:]}"
    ranks = {name: [dict(np.load(tmp / "ranks" / f"{name}.rank{r}.npz")) for r in range(WORLD)]
             for name in ("epi", "kp", "desc", "nan")}
    return types.SimpleNamespace(ranks=ranks, ref=ref, sds=sds, variables=variables, root=tmp / "ranks",
                                 seconds=result["s"])


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_ranks_hold_the_global_batch_and_its_loss(run):
    """Each rank took its row of the global batch; both report JAX's
    global loss of both stages."""
    batch = np.load(run.root.parent / "batch.npz")
    for r, got in enumerate(run.ranks["kp"]):
        np.testing.assert_array_equal(got["batch/im1"], batch["im1"][r:r + 1])
        _close(got["loss"], run.ref["kp"][0], msg=f"stage 2 loss, rank {r}")
        _close(run.ranks["desc"][r]["loss"], run.ref["desc"][0], msg=f"stage 1 loss, rank {r}")


def test_two_rank_stage2_step_matches_jax(run):
    """Loss, components, the head's gradient (the ranks' sum) and the SGD
    update against the JAX trainer's step on the global batch."""
    l_ref, c_ref, g_ref, want = run.ref["kp"]
    g_want = head_state_dict({"params": jax.tree.map(np.asarray, g_ref)})
    p_want = head_state_dict({"params": jax.tree.map(np.asarray, want)})
    for r, got in enumerate(run.ranks["kp"]):
        for k in ("reinforce", "kp_penalty", "n_pairs", "n_kps", "cor mean", "cor max", "cor minmean",
                  "cor summin", "cor summax", "cor minmax"):
            _close(got[f"comp/{k}"], c_ref[k], msg=f"{k}, rank {r}")
        _close(got["grad_norm/localheader"], optax.global_norm(g_ref), msg="grad norm")
        for name in g_want:
            _close(got[f"grad/localheader/{name}"], g_want[name].numpy(), msg=f"grad {name}, rank {r}")
            _close(got[f"state/localheader/{name}"], p_want[name].numpy(), msg=f"param {name}, rank {r}")


def test_two_rank_stage1_step_matches_jax(run):
    """Loss, components, the backbone's gradient, Adam's update and the
    synchronised BatchNorm's running statistics against JaxTrainer's step
    on the global batch: a rank-local BatchNorm (each rank normalizing its
    one pair) fails here."""
    t_ref, c_ref, gn_ref, g_ref, new_tr, bn_ref = run.ref["desc"]
    stats = jax.tree.map(np.asarray, run.variables["backbone"]["batch_stats"])
    g_want = backbone_state_dict({"params": jax.tree.map(np.asarray, g_ref), "batch_stats": stats})
    after = backbone_state_dict({"params": jax.tree.map(np.asarray, new_tr["backbone"]),
                                 "batch_stats": jax.tree.map(np.asarray, bn_ref["batch_stats"])})
    norm = float(gn_ref["backbone"])
    before = run.sds["backbone"]
    for r, got in enumerate(run.ranks["desc"]):
        for k in ("loss_g1", "loss_w1", "loss_g2", "loss_w2", "percent_g", "percent_w"):
            _close(got[f"comp/{k}"], c_ref[k], msg=f"{k}, rank {r}")
        _close(got["grad_norm/backbone"], norm, msg="grad norm")
        for name, want in g_want.items():
            if "running" in name or "num_batches" in name:
                continue
            g, want = got[f"grad/backbone/{name}"], want.numpy()
            if name.startswith("conv_coarse."):  # stage 1's loss reads only local_map
                assert not np.abs(g).any() and not np.abs(want).any(), name
                continue
            if name.endswith("conv.bias"):  # before BatchNorm: 0 up to rounding
                assert np.abs(g).max() <= 1e-6 * norm and np.abs(want).max() <= 1e-6 * norm, name
                continue
            _close(g, want, RTOL, ATOL * np.abs(want).max(), f"grad {name}, rank {r}")
            # Adam's first update, where the gradient's sign is clear of rounding
            clear = np.abs(want) > 1e-3 * np.abs(want).max()
            _close(got[f"state/backbone/{name}"][clear], after[name].numpy()[clear], 1e-6, 1e-7, name)
        for name in after:
            if "running" in name:  # image 1's global batch, then image 2's
                _close(got[f"state/backbone/{name}"], after[name].numpy(), msg=f"{name}, rank {r}")
                assert not np.array_equal(got[f"state/backbone/{name}"], before[name].numpy()), name
        assert int(got["state/backbone/firstbn.num_batches_tracked"]) == 2


def test_std_weighted_epipolar_normaliser_is_global(run):
    """The ranks' shares of the std-weighted loss sum to JAX's loss on the
    whole batch, with rank 1's spreads 4× rank 0's (a rank-local
    inverse-std mean fails here); every rank logs the global components."""
    loss_ref, comps_ref = run.ref["epi"]
    shares = [float(r["loss"]) for r in run.ranks["epi"]]
    _close(sum(shares), loss_ref, msg="loss")
    assert abs(shares[0] - shares[1]) > 1e-3 * abs(sum(shares))
    for r, got in enumerate(run.ranks["epi"]):
        for k, v in comps_ref.items():
            _close(got[f"comp/{k}"], v, msg=f"{k}, rank {r}")


def test_rank_zero_alone_writes_the_run(run):
    """config.yaml, checkpoints, metrics and TensorBoard events come from
    rank 0 (one record and one event file); rank 1 logs to its own file;
    both ranks' step times are kept, tagged with the rank."""
    root = run.root / "ckpts" / "kp"
    names = set(os.listdir(root))
    assert {"config.yaml", "logging_file.txt", "logging_file.proc1.txt", "metrics.jsonl", "000",
            "001"} <= names, names
    assert sorted(os.listdir(root / "001")) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
    recs = [json.loads(x) for x in open(root / "metrics.jsonl")]
    assert [r["global_step"] for r in recs] == [1, 2]
    assert len([f for f in names if f.startswith("events.out.tfevents")]) == 1
    times = [json.loads(x) for x in open(root / "step_times.jsonl")]
    assert sorted((t["rank"], t["step"]) for t in times) == [(0, 1), (0, 2), (1, 1), (1, 2)]
    saved = torch.load(root / "001" / "localheader.pth", weights_only=True)
    assert set(saved) == set(run.sds["localheader"])  # the reference's names, no "module." prefix


def test_non_finite_on_one_rank_skips_every_rank(run):
    """Rank 1's loss is NaN: no rank steps (a rank that decided on its own
    finite loss would step with the summed NaN gradient), each rank dumps
    its own batch and nothing is logged."""
    for r, got in enumerate(run.ranks["nan"]):
        for k in got:
            if k.startswith("before/"):
                np.testing.assert_array_equal(got["after/" + k[7:]], got[k], err_msg=f"{k}, rank {r}")
    root = run.root / "ckpts" / "nan"
    assert {"error_step1.npz", "error_step1.proc1.npz"} <= set(os.listdir(root))
    assert not os.path.exists(root / "metrics.jsonl") or not open(root / "metrics.jsonl").read()
