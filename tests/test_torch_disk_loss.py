"""posfeat_tpu_torch's DiskLoss against posfeat_tpu's on the CPU, given the
same draws: the loss (rtol 2e-4), d loss / d score maps (rtol 2e-3) and
every diagnostic component, on the dense path and on the streamed path
(JAX runs its Pallas reduction with interpret=True, the port its plain
version). Tolerances are those of test_pallas_reinforce.py:121-128. The
port's own draws get a statistical check against the cell softmax and
the accept sigmoid."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.losses.disk_loss import DiskLoss as JaxDiskLoss
from posfeat_tpu_torch.data.utils import skew
from posfeat_tpu_torch.losses import LOSSES, PREPROCESSES, DiskLoss
from posfeat_tpu_torch.ops import samplers
from torch_port_helpers import jax_disk_draws, torch_draws

B, H, W, C, G = 2, 64, 96, 8, 8

BASE_CONFIG = {
    "grid_size": G,
    "loss_distance": "cos",
    "temperature_base": 5,
    "temperature_max": 60,
    "epipolar_reward": "constant_reward",
    "reward_config": {"reward_thr": 4, "rescale_thr": False},
    "cor_detach": True,
    "good_reward": 1,
    "bad_reward": -0.25,
    "kp_penalty": -0.001,
    "match_grad": False,
}

# (use_pallas, epipolar_reward, rescale_thr, anneal, epoch)
CASES = [
    (False, "constant_reward", False, False, 1),
    ("interpret", "constant_reward", False, False, 1),
    (False, "constant_reward", True, False, 1),
    (False, "dynamic_reward", False, False, 1),
    (False, "dynamic_reward", True, False, 2),
    (False, "constant_reward", False, True, 4),
    ("interpret", "constant_reward", False, True, 1),
    ("interpret", "constant_reward", False, True, 4),
]


def _config(use_pallas, reward, rescale, anneal):
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["use_pallas"] = use_pallas
    cfg["epipolar_reward"] = reward
    cfg["reward_config"]["rescale_thr"] = rescale
    if anneal:
        cfg["reward_config"].update(reward_thr_final=1.0, reward_anneal_epochs=3)
    return cfg


def _problem(seed=0):
    """Score maps, descriptor maps and valid planar-scene fundamental
    matrices (F = [e]x H as the synthetic pairs build them)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    kp1 = rng.randn(B, H, W, 1).astype(f)
    kp2 = rng.randn(B, H, W, 1).astype(f)
    xf1 = rng.randn(B, H // 4, W // 4, C).astype(f)
    xf2 = (xf1 + 0.3 * rng.randn(B, H // 4, W // 4, C)).astype(f)
    F1, F2 = [], []
    for _ in range(B):
        Hm = np.eye(3) + np.diag([0.02, -0.01, 0.0]) + 1e-3 * rng.randn(3, 3)
        Hm[2, :2] *= 1e-2
        e2, e1 = rng.randn(3), rng.randn(3)
        e2[2], e1[2] = abs(e2[2]) + 0.5, abs(e1[2]) + 0.5
        a, b = skew(e2) @ Hm, skew(e1) @ np.linalg.inv(Hm)
        F1.append(a / a[-1, -1])
        F2.append(b / b[-1, -1])
    return kp1, kp2, xf1, xf2, np.stack(F1).astype(f), np.stack(F2).astype(f)


def _jax_loss(cfg, prob, epoch, key):
    kp1, kp2, xf1, xf2, F1, F2 = map(jnp.asarray, prob)
    loss_mod = JaxDiskLoss(copy.deepcopy(cfg))
    inputs = {"F1": F1, "F2": F2}

    def f(kp1_, kp2_):
        outputs = {
            "preds1": {"local_point": kp1_, "local_map": xf1},
            "preds2": {"local_point": kp2_, "local_map": xf2},
            "epoch": epoch,
        }
        return loss_mod(inputs, outputs, None, key=key)

    (loss, comps), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(kp1, kp2)
    return float(loss), {k: float(v) for k, v in comps.items()}, [np.asarray(g) for g in grads]


def _port_loss(cfg, prob, epoch, draws):
    kp1, kp2, xf1, xf2, F1, F2 = (torch.from_numpy(a) for a in prob)
    kp1.requires_grad_(True)
    kp2.requires_grad_(True)
    outputs = {
        "preds1": {"local_point": kp1, "local_map": xf1},
        "preds2": {"local_point": kp2, "local_map": xf2},
        "epoch": epoch,
    }
    loss, comps = DiskLoss(copy.deepcopy(cfg))({"F1": F1, "F2": F2}, outputs, None,
                                                draws=torch_draws(draws))
    loss.backward()
    return loss.item(), {k: float(v) for k, v in comps.items()}, [kp1.grad.numpy(), kp2.grad.numpy()]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_disk_loss_matches_jax_given_draws(case):
    use_pallas, reward, rescale, anneal, epoch = case
    cfg = _config(use_pallas, reward, rescale, anneal)
    prob = _problem()
    key = jax.random.PRNGKey(3)
    l_ref, c_ref, g_ref = _jax_loss(cfg, prob, epoch, key)
    draws = jax_disk_draws(prob[0], prob[1], key, G)
    loss_mod = DiskLoss(copy.deepcopy(cfg))
    assert loss_mod._use_streamed() == (use_pallas == "interpret"
                                        and reward == "constant_reward" and not rescale)
    l_got, c_got, g_got = _port_loss(cfg, prob, epoch, draws)

    np.testing.assert_allclose(l_got, l_ref, rtol=2e-4, atol=1e-5)
    for g, r in zip(g_got, g_ref):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5)
    assert set(c_got) == set(c_ref)
    for k in c_ref:
        np.testing.assert_allclose(c_got[k], c_ref[k], rtol=2e-4, atol=1e-6, err_msg=k)
    # the draws give the reward real signal: some pairs are good
    assert c_ref["reinforce"] != 0.0


def test_reward_thr_anneal_schedule():
    loss_mod = DiskLoss(_config(False, "constant_reward", False, True))
    for epoch, want in [(1, 4.0), (2, 3.0), (3, 2.0), (4, 1.0), (9, 1.0)]:
        assert loss_mod._reward_config(epoch)["reward_thr"] == pytest.approx(want)
    assert DiskLoss(BASE_CONFIG)._reward_config(7)["reward_thr"] == 4


def test_unported_levers_raise():
    for key, val in (("loc_weight", 0.1), ("reward_at_refined", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DiskLoss({**BASE_CONFIG, key: val})
    with pytest.raises(ValueError, match="epipolar_reward"):
        DiskLoss({**BASE_CONFIG, "epipolar_reward": "linear_reward"})
    assert LOSSES["DiskLoss"] is DiskLoss
    assert PREPROCESSES["Preprocess_Skip"]()({}, {}) is None


def test_port_draws_follow_softmax_and_sigmoid():
    """Categorical proposal frequencies against the cell softmax, accept
    frequencies against the sigmoid of the proposed logit, within 5 sigma
    of the sampling noise; and the draw is reproducible from its seed."""
    rng = np.random.RandomState(0)
    cell = (rng.randn(G, G) * 1.5).astype(np.float32)
    reps = 60  # 60 x 60 cells of the same logits per draw
    kp = torch.from_numpy(np.tile(cell, (reps, reps))[None, :, :, None])
    loss_mod = DiskLoss(BASE_CONFIG)
    gen = torch.Generator().manual_seed(5)
    counts = np.zeros(G * G)
    acc_dev = []
    n = 0
    for _ in range(4):
        prop, accept = loss_mod.draw(kp, gen)
        counts += np.bincount(prop.flatten().numpy(), minlength=G * G)
        n += prop.numel()
        p_acc = torch.sigmoid(torch.from_numpy(cell.reshape(-1))[prop.flatten()])
        acc_dev.append((accept.flatten().float() - p_acc).numpy())
    p = torch.softmax(torch.from_numpy(cell.reshape(-1)), 0).numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(counts - n * p) <= 5 * sigma + 1).all()
    dev = np.concatenate(acc_dev)
    assert abs(dev.mean()) <= 5 * 0.5 / np.sqrt(dev.size)
    # same seed, same draws; scores carry the gradient
    a = loss_mod.draw(kp, torch.Generator().manual_seed(1))
    b = loss_mod.draw(kp, torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    kpg = kp.clone().requires_grad_(True)
    coords, logp = loss_mod.point_score(kpg, *a)
    assert coords.shape == (1, reps, reps, 2) and logp.requires_grad
    # the proposed pixel lies in its own cell
    cx = coords[..., 0] // G
    assert torch.equal(cx, torch.arange(reps, dtype=torch.float32)[None, None, :].expand_as(cx))


def test_samplers_match_jax_scoring():
    """unfold, cell coordinates and log-probs against the JAX samplers."""
    from posfeat_tpu.ops import samplers as js

    rng = np.random.RandomState(1)
    kp = rng.randn(2, 20, 27, 1).astype(np.float32)  # ragged: trailing rows/cols dropped
    key = jax.random.PRNGKey(0)
    k_cat, k_bern = jax.random.split(key)
    idx, logp, cells = js.grid_categorical_sample(jnp.asarray(kp), 4, k_cat)
    acc, alogp = js.grid_bernoulli_accept(cells, idx, k_bern)
    kpt = torch.from_numpy(kp)
    np.testing.assert_array_equal(samplers.unfold(kpt, 4).numpy(), np.asarray(js.unfold(jnp.asarray(kp), 4)))
    cells_t = samplers.grid_cells(kpt, 4)
    idx_t = torch.from_numpy(np.array(idx)).long()
    np.testing.assert_allclose(samplers.categorical_logp(cells_t, idx_t).numpy(), np.asarray(logp), rtol=1e-6, atol=1e-6)
    acc_t = torch.from_numpy(np.array(acc))
    np.testing.assert_allclose(
        samplers.bernoulli_logp(samplers.accept_logits(cells_t, idx_t), acc_t).numpy(),
        np.asarray(alogp), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_array_equal(
        samplers.cell_coords_pixel(20, 27, 4, idx_t).numpy(),
        np.asarray(js.cell_coords_pixel(20, 27, 4, idx)),
    )
    # the JAX-named draw-and-score wrappers score their own draws
    gen = torch.Generator().manual_seed(0)
    idx2, logp2, cells2 = samplers.grid_categorical_sample(kpt, 4, gen)
    torch.testing.assert_close(logp2, samplers.categorical_logp(cells_t, idx2))
    acc2, alogp2 = samplers.grid_bernoulli_accept(cells2, idx2, gen)
    torch.testing.assert_close(alogp2, samplers.bernoulli_logp(samplers.accept_logits(cells_t, idx2), acc2))
    s, lp = samplers.bernoulli_sample_logp(cells_t[..., 0], gen)
    torch.testing.assert_close(lp, samplers.bernoulli_logp(cells_t[..., 0], s))
    assert s.dtype == torch.float32 and set(s.unique().tolist()) <= {0.0, 1.0}
