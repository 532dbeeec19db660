"""posfeat_tpu_torch's sub-pixel refiners, Gumbel selection and the other
detectors against posfeat_tpu's on the CPU, on the same numpy-seeded maps
(2 images, 48×64) that hold flat plateaus (no well-posed peak) and peaks
on the 1-px border ring.

Tolerances: offsets and refined grids atol 1e-5 (normalized coordinates
or pixels); slates index-equal (each keypoint within 1e-5 of JAX's, in
JAX's order) with scores within rtol 1e-6. Gumbel top-k, the grid
detectors and the batched detectors take JAX's noise and draws; the
port's own draws are held to their distributions by a chi-square test on
a 4×4 map over 2,000 draws (the 0.1% critical value at 15 degrees of
freedom, 37.70).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.ops import detect as jd
from posfeat_tpu.ops import samplers as js
from posfeat_tpu_torch.ops import detect as td
from posfeat_tpu_torch.ops import samplers as ts

B, H, W = 2, 48, 64
CHI2_15_P001 = 37.697


def _maps(seed=0):
    """Smooth blobs plus noise, with a flat plateau and peaks on the ring."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((B, H, W, 1), np.float32)
    for b in range(B):
        m = 0.1 * rng.rand(H, W)
        for _ in range(12):
            cy, cx = rng.uniform(-1, H), rng.uniform(-1, W)
            s = rng.uniform(1.0, 3.0)
            m += rng.uniform(0.5, 2.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        m[10:16, 20:30] = 1.5  # a plateau: the Hessian vanishes there
        m[0, 7] += 3.0  # peaks on the outer ring
        m[5, 0] += 3.0
        m[1, 40] += 3.0  # and on the interior's edge
        m[H - 2, W - 2] += 3.0
        out[b, ..., 0] = m
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol, equal_nan=True)


def test_dense_offsets_match_jax():
    kp = _maps()
    q = td.quad_refine_offsets(_t(kp))
    _close(q, jd.quad_refine_offsets(jnp.asarray(kp)))
    # the plateau gives no offset, the ring is zero
    assert (q[:, 11:15, 21:29] == 0).all() and (q[:, 0] == 0).all() and (q[:, :, -1] == 0).all()
    assert (q.abs() <= 0.5).all() and (q != 0).any()
    for window in (3, 5):
        for temp in (20.0, 5.0):
            _close(td.softargmax3_offsets(_t(kp), temp, window),
                   jd.softargmax3_offsets(jnp.asarray(kp), temp, window=window))
    with pytest.raises(ValueError, match="odd"):
        td.softargmax3_offsets(_t(kp), 20.0, 4)


@pytest.mark.parametrize("refine,stride", [("quad", 1), ("quad5", 1), ("soft", 1), ("soft5", 1), ("avg3", 1),
                                           ("avg3", 2)])
def test_refined_grids_match_jax(refine, stride):
    kp = _maps(1)
    got = td.refined_grids(_t(kp), refine, stride)
    if refine == "quad":
        ref = jd._quad_refine_grids(jnp.asarray(kp))
    elif refine == "quad5":
        ref = jd._quad5_refine_grids(jnp.asarray(kp))
    elif refine in ("soft", "soft5"):
        off = jd.softargmax3_offsets(jnp.asarray(kp), 20.0, window=5 if refine == "soft5" else 3)[:, 1:-1, 1:-1]
        ref = np.stack([-1.0 + 2.0 * (np.arange(1, W - 1)[None, None, :] + off[..., 0]) / (W - 1),
                        -1.0 + 2.0 * (np.arange(1, H - 1)[None, :, None] + off[..., 1]) / (H - 1)], -1)
    else:
        from posfeat_tpu.ops.coords import gen_grid
        from posfeat_tpu.ops.pooling import avg_pool2d

        g = gen_grid(-1, 1, -1, 1, H, W).reshape(1, H, W, 2)
        ref = avg_pool2d(jnp.asarray(kp) * g, 3, stride) / avg_pool2d(jnp.asarray(kp), 3, stride)
    assert tuple(got.shape) == tuple(np.shape(ref))
    _close(got, ref)
    if refine == "quad5":
        f = td._quad5_filters().numpy()
        np.testing.assert_array_equal(f, np.asarray(jd._quad5_filters()))


@pytest.mark.parametrize("refine", ["avg3", "quad", "quad5", "soft", "soft5"])
@pytest.mark.parametrize("cfg", [
    dict(num_pts=64, nms_radius=1, thr=0.5, thr_mod="mean"),
    dict(num_pts=400, nms_radius=2, thr=False),
], ids=["r1_thr", "r2_pad"])
def test_generate_kpts_single_refiners_match_jax(refine, cfg):
    kp = _maps(2)
    got = td.generate_kpts_single(_t(kp), refine=refine, **cfg)
    ref = jd.generate_kpts_single(jnp.asarray(kp), refine=refine, **cfg)
    _close(got[0], ref[0])
    _close(got[1], ref[1], atol=0.0, rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    # the bf16 map: the quad fit runs in f32, the grids come out bf16
    if refine in ("quad", "quad5"):
        kb = _t(kp).to(torch.bfloat16)
        g16 = td.generate_kpts_single(kb, refine=refine, **cfg)
        r16 = jd.generate_kpts_single(jnp.asarray(kp, jnp.bfloat16), refine=refine, **cfg)
        _close(g16[0].float(), np.asarray(r16[0], np.float32))


def test_strided_avg3_and_refuse_bad_refine():
    kp = _maps(3)
    cfg = dict(num_pts=50, nms_radius=1, thr=False, stride=2)
    got = td.generate_kpts_single(_t(kp), **cfg)
    ref = jd.generate_kpts_single(jnp.asarray(kp), **cfg)
    # the strided grids are smaller than the interior the top-k ranks: JAX's
    # gather fills NaN past their end, and so does the port
    assert np.isnan(np.asarray(ref[0])).any()
    _close(got[0], ref[0])
    _close(got[1], ref[1], atol=0.0, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown refine"):
        td.generate_kpts_single(_t(kp), num_pts=8, nms_radius=1, refine="quadratic")
    with pytest.raises(ValueError, match="stride 1 only"):
        td.generate_kpts_single(_t(kp), num_pts=8, nms_radius=1, refine="quad", stride=2)


def test_gumbel_selection_given_jax_noise():
    kp = _maps(4)
    key = jax.random.PRNGKey(7)
    n = 32
    h2w2 = (H - 2) * (W - 2)
    noise = np.asarray(js.gumbel_noise(key, (B, n, h2w2)))
    prob = kp[:, 1:-1, 1:-1]
    for temp in (1.0, 0.01):
        sel = ts.gumbel_topk_select(_t(prob), n, _t(noise), temp)
        ref = js.gumbel_topk_select(jnp.asarray(prob), n, key, temp)
        _close(sel, ref, atol=1e-6)
        np.testing.assert_array_equal(sel.argmax(-1).numpy(), np.asarray(ref).argmax(-1))
    for refine in ("avg3", "quad"):
        cfg = dict(num_pts=n, nms_radius=1, thr=0.5, thr_mod="mean", stable=False, temperature=0.01,
                   refine=refine)
        got = td.generate_kpts_single(_t(kp), noise=_t(noise), **cfg)
        ref = jd.generate_kpts_single(jnp.asarray(kp), key=key, **cfg)
        _close(got[0], ref[0])
        _close(got[1], ref[1], atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    with pytest.raises(ValueError, match="generator"):
        td.generate_kpts_single(_t(kp), num_pts=4, nms_radius=1, stable=False)


@pytest.mark.parametrize("cfg", [
    dict(num_pts=40, nms_radius=1, thr=0.5, thr_mod="mean"),
    dict(num_pts=5000, nms_radius=2, thr=False),
    dict(num_pts=64, nms_radius=1, use_nms="softnms", thr=0.7, thr_mod="abs"),
    dict(num_pts=64, nms_radius=1, use_nms=False, thr=1.0, thr_mod="max"),
], ids=["r1_thr", "pad", "softnms", "nonms"])
def test_noavg_matches_jax(cfg):
    kp = _maps(5)
    got = td.generate_kpts_single_noavg(_t(kp), **cfg)
    ref = jd.generate_kpts_single_noavg(jnp.asarray(kp), **cfg)
    _close(got[0], ref[0])
    _close(got[1], ref[1], atol=0.0, rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("cfg", [
    dict(grid_size=8, num_pts=0, use_nms=True, nms_radius=1),
    dict(grid_size=8, num_pts=20, use_nms=True, nms_radius=1, thr=0.5),
    dict(grid_size=4, num_pts=500, use_nms=False),
    dict(grid_size=8, num_pts=16, use_nms="softnms", nms_radius=2, thr=0.8, thr_mod="max"),
], ids=["slate", "top20", "pad", "softnms"])
@pytest.mark.parametrize("stable", [True, False])
def test_regular_grid_matches_jax(cfg, stable):
    kp = _maps(6)
    key = jax.random.PRNGKey(11)
    ref = jd.generate_kpts_regular_grid_single(jnp.asarray(kp), stable=stable, key=key, **cfg)
    draw = None
    if not stable:
        m = jnp.asarray(kp)
        if cfg.get("use_nms") == "softnms":
            from posfeat_tpu.ops.nms import soft_nms

            m = soft_nms(m, cfg["nms_radius"]) * m
        draw = _t(np.array(jax.random.categorical(key, js.unfold(m, cfg["grid_size"])[:, :, :, 0, :], axis=-1)))
    got = td.generate_kpts_regular_grid_single(_t(kp), stable=stable, draw=draw, **cfg)
    _close(got[0], ref[0])
    _close(got[1], ref[1], atol=0.0, rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("stable_prob", [1.0, 0.0])
def test_batched_detectors_given_jax_draws(stable_prob):
    k1m, k2m = _maps(7), _maps(8)
    outputs_j = {"preds1": {"local_point": jnp.asarray(k1m)}, "preds2": {"local_point": jnp.asarray(k2m)}}
    outputs_t = {"preds1": {"local_point": _t(k1m)}, "preds2": {"local_point": _t(k2m)}}
    key = jax.random.PRNGKey(5)
    k_choice, k1, k2 = jax.random.split(key, 3)
    u = float(jax.random.uniform(k_choice))
    n, epoch = 24, 1
    shape = (B, n, (H - 2) * (W - 2))
    ref = jd.generate_kpts(outputs_j, key, nms_radius=1, num_pts=n, stable_prob=stable_prob, epoch=epoch)
    draws = (u, _t(js.gumbel_noise(k1, shape)), _t(js.gumbel_noise(k2, shape)))
    got = td.generate_kpts(outputs_t, nms_radius=1, num_pts=n, stable_prob=stable_prob, epoch=epoch,
                           draws=draws)
    # Gumbel's soft selection at T = 0.005 scales a one-ulp difference of
    # prob + noise by 200 in its weights: values within 1e-4, and every
    # keypoint on JAX's pixel (index-equal)
    atol = 1e-5 if stable_prob else 1e-4
    for g_, r_ in zip(got, ref):
        _close(g_, r_, atol=atol)
    for g_, r_ in zip(got[:2], ref[:2]):
        px = lambda k: np.rint((np.asarray(k) + 1) / 2 * [W - 1, H - 1])
        np.testing.assert_array_equal(px(g_.numpy()), px(r_))

    g = 8
    ref = jd.generate_kpts_regular_grid(outputs_j, key, grid_size=g, num_pts=30, stable_prob=stable_prob,
                                        nms_radius=1)
    cells = [np.array(jax.random.categorical(k, js.unfold(jnp.asarray(m), g)[:, :, :, 0, :], axis=-1))
             for k, m in ((k1, k1m), (k2, k2m))]
    got = td.generate_kpts_regular_grid(outputs_t, grid_size=g, num_pts=30, stable_prob=stable_prob,
                                        nms_radius=1, draws=(u, _t(cells[0]), _t(cells[1])))
    for g_, r_ in zip(got, ref):
        _close(g_, r_, atol=1e-5)


def _chi2(counts, p):
    expected = counts.sum() * p
    return float(((counts - expected) ** 2 / expected).sum())


def test_port_draws_follow_their_distributions():
    """On a 4×4 map, 2,000 draws: the Gumbel selection's argmax and the
    grid detector's Categorical pick against softmax(map); the batched
    detectors' stable pick against stable_prob (within 5 sigma)."""
    rng = np.random.RandomState(0)
    cell = (rng.randn(4, 4) * 0.8).astype(np.float32)
    p = torch.softmax(torch.from_numpy(cell.reshape(-1)), 0).numpy()
    n = 2000
    gen = torch.Generator().manual_seed(0)
    prob = torch.from_numpy(np.broadcast_to(cell, (n, 4, 4))[..., None].copy())
    sel = ts.gumbel_topk_select(prob, 1, ts.gumbel_noise((n, 1, 16), gen), 1e-3)
    counts = np.bincount(sel[:, 0].argmax(-1).numpy(), minlength=16)
    assert _chi2(counts, p) < CHI2_15_P001, counts

    kps, _, _ = td.generate_kpts_regular_grid_single(prob, grid_size=4, num_pts=0, stable=False,
                                                     use_nms=False, generator=gen)
    pix = ((kps[:, 0, 1] + 1) / 2 * 3).round().long() * 4 + ((kps[:, 0, 0] + 1) / 2 * 3).round().long()
    counts = np.bincount(pix.numpy(), minlength=16)
    assert _chi2(counts, p) < CHI2_15_P001, counts

    outputs = {"preds1": {"local_point": prob[:1]}, "preds2": {"local_point": prob[:1]}}
    stable = 0
    for _ in range(n):
        stable += td._stable_choice(0.9, gen, "cpu", None)
    assert abs(stable - 0.9 * n) <= 5 * np.sqrt(n * 0.9 * 0.1), stable
    k1, k2, s1, s2 = td.generate_kpts_regular_grid(outputs, gen, grid_size=4, num_pts=1, nms_radius=1)
    assert k1.shape == (1, 1, 2) and s2.shape == (1, 1, 1)
    # same seed, same draws
    a = ts.gumbel_noise((2, 3), torch.Generator().manual_seed(1))
    b = ts.gumbel_noise((2, 3), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_detectors_registry():
    assert set(td.DETECTORS) == set(jd.DETECTORS)
