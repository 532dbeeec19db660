"""DiskLoss's sub-pixel levers, ``reward_at_refined`` and ``loc_weight``
(with ``loc_temperature`` and ``loc_window``), against posfeat_tpu's on
the CPU, given the same draws: the loss and every component within rtol
1e-4 of JAX's, the score maps' gradient at cosine >= 0.9999. Either lever
takes the dense loss, as JAX's ``_use_pallas`` does.

Two faults of the JAX code are not inherited, each with its own test:
its loc gate compares against the raw ``reward_thr`` even where
``rescale_thr`` rescales the reward's thresholds (disk_loss.py:344), and
it computes the offsets over the whole dense map to read them at the
sampled cells (disk_loss.py:330); the port reads the rescaled thresholds
and computes the offsets at the sampled cells only.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.ops import detect as jd
from posfeat_tpu_torch.losses import DiskLoss
from posfeat_tpu_torch.ops import detect as td
from posfeat_tpu_torch.ops.coords import normalize_coords
from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord
from test_torch_disk_loss import BASE_CONFIG, G, _jax_loss, _port_loss, _problem
from torch_port_helpers import jax_disk_draws, torch_draws

LEVERS = [
    dict(reward_at_refined=True),
    dict(loc_weight=1.0, loc_window=3),
    dict(loc_weight=10.0, loc_window=5, loc_temperature=10.0),
    dict(loc_weight=10.0, loc_window=3, reward_at_refined=True),
    dict(loc_weight=1.0, loc_window=5, reward_at_refined=True, epipolar_reward="dynamic_reward"),
]


def _config(**levers):
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["use_pallas"] = "interpret"  # eligible for the streamed loss but for the levers
    cfg.update(levers)
    return cfg


def _problem_peaked(seed=0):
    """_problem's maps smoothed, so that the sampled cells sit on peaks
    with real sub-pixel offsets."""
    kp1, kp2, xf1, xf2, F1, F2 = _problem(seed)
    k = np.array([0.25, 0.5, 0.25], np.float32)

    def smooth(m):
        m = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, m)
        return np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 2, m).astype(np.float32) * 3

    return smooth(kp1), smooth(kp2), xf1, xf2, F1, F2


def _cos(a, b):
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("levers", LEVERS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_levers_match_jax_given_draws(levers):
    cfg = _config(**levers)
    prob = _problem_peaked()
    key = jax.random.PRNGKey(3)
    epoch = 1
    l_ref, c_ref, g_ref = _jax_loss(cfg, prob, epoch, key)
    draws = jax_disk_draws(prob[0], prob[1], key, G)
    assert not DiskLoss(copy.deepcopy(cfg))._use_streamed()
    l_got, c_got, g_got = _port_loss(cfg, prob, epoch, draws)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-4)
    assert set(c_got) == set(c_ref)
    assert ("loc_pen" in c_got) == bool(levers.get("loc_weight"))
    for k in c_ref:
        np.testing.assert_allclose(c_got[k], c_ref[k], rtol=1e-4, atol=1e-7, err_msg=k)
    for g, r in zip(g_got, g_ref):
        assert _cos(g, r) >= 0.9999, _cos(g, r)
    if levers.get("loc_weight"):
        assert c_ref["loc_pen"] > 0  # the gate passes some pairs


def test_reward_at_refined_moves_the_reward():
    """The refined reward differs from the integer-pixel one on these draws
    (the lever is live), and the offsets move each pair by at most 0.5 px."""
    prob = _problem_peaked()
    key = jax.random.PRNGKey(3)
    draws = jax_disk_draws(prob[0], prob[1], key, G)
    l_off, c_off, _ = _port_loss(_config(), prob, 1, draws)
    l_on, c_on, _ = _port_loss(_config(reward_at_refined=True), prob, 1, draws)
    assert c_on["reinforce"] != c_off["reinforce"]


def test_offsets_at_sampled_cells_equal_the_dense_maps():
    """quad_offsets_at and softargmax_offsets_at, from each pixel's own
    window, equal JAX's dense offset maps read at the same pixels, the
    1-px ring included, and the soft offsets' gradient equals the dense
    map's gathered gradient."""
    rng = np.random.RandomState(4)
    kp = _problem_peaked(1)[0]
    Bk, Hk, Wk, _ = kp.shape
    xs = np.concatenate([rng.randint(0, Wk, 60), [0, Wk - 1, 0, Wk - 1, 5]])
    ys = np.concatenate([rng.randint(0, Hk, 60), [0, Hk - 1, Hk - 1, 0, 0]])
    coord = np.stack([np.broadcast_to(xs, (Bk, xs.size)), np.broadcast_to(ys, (Bk, ys.size))], -1).astype(np.float32)
    kpt, ct = torch.from_numpy(kp), torch.from_numpy(coord)
    xi, yi = coord[..., 0].astype(int), coord[..., 1].astype(int)
    bi = np.arange(Bk)[:, None]

    dense_q = np.asarray(jd.quad_refine_offsets(jnp.asarray(kp)))
    np.testing.assert_allclose(td.quad_offsets_at(kpt, ct).numpy(), dense_q[bi, yi, xi], atol=1e-6)
    assert (td.quad_offsets_at(kpt, ct).numpy()[:, 60:] == 0).all()  # ring pixels
    for window, temp in ((3, 20.0), (5, 10.0)):
        dense_s = np.asarray(jd.softargmax3_offsets(jnp.asarray(kp), temp, window=window))
        got = td.softargmax_offsets_at(kpt, ct, temp, window)
        np.testing.assert_allclose(got.numpy(), dense_s[bi, yi, xi], atol=1e-6)
        # gradients: sampled-cell windows against the dense map's gather
        wts = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
        a = kpt.clone().requires_grad_(True)
        (td.softargmax_offsets_at(a, ct, temp, window) * wts).sum().backward()
        b = kpt.clone().requires_grad_(True)
        (td.softargmax3_offsets(b, temp, window)[torch.from_numpy(bi), torch.from_numpy(yi),
                                                  torch.from_numpy(xi)] * wts).sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)


def test_loss_builds_no_dense_offset_map(monkeypatch):
    """DiskLoss with both levers never calls the dense offset maps."""
    def refuse(*a, **k):
        raise AssertionError("a dense offset map was computed")

    monkeypatch.setattr(td, "quad_refine_offsets", refuse)
    monkeypatch.setattr(td, "softargmax3_offsets", refuse)
    prob = _problem_peaked()
    draws = jax_disk_draws(prob[0], prob[1], jax.random.PRNGKey(3), G)
    loss, comps, _ = _port_loss(_config(loc_weight=1.0, reward_at_refined=True), prob, 1, draws)
    assert np.isfinite(loss) and comps["loc_pen"] > 0


def test_loc_gate_reads_rescaled_thresholds():
    """With rescale_thr the port gates loc_pen by reward_thr · scale, as
    its reward does; JAX gates by the raw reward_thr, so the two differ
    where the scales are not 1. The port's value is recomputed here from
    its definition."""
    cfg = _config(loc_weight=1.0)
    cfg["reward_config"]["rescale_thr"] = True
    prob = list(_problem_peaked())
    # epipoles at infinity: vertical lines in image 2, horizontal in image 1,
    # so the mean distances differ as the 96 x 64 frame's sides do
    from posfeat_tpu_torch.data.utils import skew

    prob[4] = np.broadcast_to(skew(np.array([0.0, 1.0, 0.0])), prob[4].shape).astype(np.float32)
    prob[5] = np.broadcast_to(skew(np.array([1.0, 0.0, 0.0])), prob[5].shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draws = jax_disk_draws(prob[0], prob[1], key, G)
    _, c_ref, _ = _jax_loss(cfg, prob, 1, key)
    _, c_got, _ = _port_loss(cfg, prob, 1, draws)
    assert max(c_got["scale1"], c_got["scale2"]) > 1.05

    kp1, kp2, xf1, xf2, F1, F2 = (torch.from_numpy(a) for a in prob)
    loss_mod = DiskLoss(copy.deepcopy(cfg))
    (p1, a1), (p2, a2) = torch_draws(draws)
    b, H, W = kp1.shape[:3]
    c1 = loss_mod.point_score(kp1, p1, a1)[0].reshape(b, -1, 2)
    c2 = loss_mod.point_score(kp2, p2, a2)[0].reshape(b, -1, 2)
    f1 = sample_feat_by_coord(xf1, normalize_coords(c1, H, W), True)
    f2 = sample_feat_by_coord(xf2, normalize_coords(c2, H, W), True)
    T = min(cfg["temperature_base"] + 1, cfg["temperature_max"])
    aff = -T * (1 - torch.bmm(f1, f2.transpose(1, 2)))
    sp = torch.softmax(aff, 2) * torch.softmax(aff, 1)
    inputs = {"F1": F1, "F2": F2}
    d1, d2 = loss_mod._epipolar_dists(inputs, c1, c2)
    thr1, thr2, _, _ = loss_mod._thresholds(d1, d2, 4, True)
    l1 = c1 + td.softargmax_offsets_at(kp1, c1, 20.0, 3)
    l2 = c2 + td.softargmax_offsets_at(kp2, c2, 20.0, 3)
    d1r, d2r = loss_mod._epipolar_dists(inputs, l1, l2)
    acc = (a1.reshape(b, -1)[:, :, None] & a2.reshape(b, -1)[:, None, :]).float()
    w = acc * ((d1r < thr1) & (d2r < thr2)).float() * sp
    want = float((w * (d1r + d2r)).sum() / w.sum().clamp_min(1.0))
    np.testing.assert_allclose(c_got["loc_pen"], want, rtol=1e-5)
    assert abs(c_got["loc_pen"] - c_ref["loc_pen"]) > 1e-3 * abs(want), (c_got["loc_pen"], c_ref["loc_pen"])


def test_lever_config_is_checked():
    with pytest.raises(ValueError, match="loc_window"):
        DiskLoss({**BASE_CONFIG, "loc_weight": 1.0, "loc_window": 4})
