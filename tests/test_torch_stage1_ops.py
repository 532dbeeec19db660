"""The stage-1 ops of posfeat_tpu_torch against posfeat_tpu's on the same
seeded inputs, f32 on the CPU: grid_sample, the grid sampler on JAX's
draws, correlation and matchers, the epipolar line geometry and search,
the window expectation (fused against reference), the fused Line2Window
engine on JAX's jitter, and sampled_similarity.

Tolerances: rtol 1e-3 / atol 2e-4 for whole computations (the models'
parity tolerance, tests/test_models_parity.py), rtol 1e-3 / atol 1e-4
for the window stage (tests/test_line_window.py:30), 1e-5 / 1e-6 for
single elementwise ops. An argmax over a near-tie may pick another pixel
in either package; those queries (top-2 gap below MARGIN) are counted,
and compared only where the gap clears it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posfeat_tpu.ops import correlation as jcor
from posfeat_tpu.ops import epipolar as jep
from posfeat_tpu.ops import line_window as jlw
from posfeat_tpu.ops import sampled_sim as jss
from posfeat_tpu.ops import samplers as jsm
from posfeat_tpu.ops.grid_sample import grid_sample as jgrid_sample
from posfeat_tpu_torch.ops import correlation as tcor
from posfeat_tpu_torch.ops import epipolar as tep
from posfeat_tpu_torch.ops import line_window as tlw
from posfeat_tpu_torch.ops import sampled_sim as tss
from posfeat_tpu_torch.ops import samplers as tsm
from posfeat_tpu_torch.ops.grid_sample import grid_sample, l2_normalize
from tests.test_ops_parity import rand_fundamental

RTOL, ATOL = 1e-3, 2e-4
WIN_RTOL, WIN_ATOL = 1e-3, 1e-4
# an argmax whose top-2 gap is below this (in the map's units, T-scaled
# cosines here) may resolve differently in the two packages
MARGIN = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float32)


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol, err_msg=msg)


def _unit(rng, *shape, scale=1.0):
    x = rng.randn(*shape).astype(np.float32)
    return scale * x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_matches_jax(rng, padding):
    img = rng.randn(2, 7, 9, 5).astype(np.float32)
    grid = (rng.rand(2, 4, 6, 2) * 2.6 - 1.3).astype(np.float32)  # a quarter off the image
    got = grid_sample(_t(img), _t(grid), padding)
    assert got.shape == (2, 4, 6, 5)
    _close(got, jgrid_sample(jnp.asarray(img), jnp.asarray(grid), padding), 1e-5, 1e-6)


@pytest.mark.parametrize("select", ["random", "regular_random"])
def test_grid_sampler_on_jax_draws(rng, select):
    """generate_kpts_regular_grid_random on JAX's draws, in its key order
    (samplers.py:146-150)."""
    g = 8
    kp1, kp2 = rng.randn(2, 2, 32, 48, 1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jsm.generate_kpts_regular_grid_random(jnp.asarray(kp1), jnp.asarray(kp2), key, g, select)
    draws = []
    for kp, k in zip((kp1, kp2), jax.random.split(key)):
        if select == "random":
            draws.append(_t(jax.random.categorical(k, jsm.unfold(jnp.asarray(kp), g)[..., 0, :], -1)).long())
        else:
            draws.append(_t(jax.random.uniform(k, (2, 1, 1, 2), jnp.float32)))
    got = tsm.generate_kpts_regular_grid_random(_t(kp1), _t(kp2), g, draws, select)
    # the jittered grid's coordinates are rounded once more in each package
    for a, b, name in zip(got, ref, ("kps1", "kps2", "score1", "score2")):
        assert a.shape == b.shape, name
        _close(a, b, 1e-5, 1e-5, name)
    flat = tsm.generate_kpts_regular_grid_random(_t(kp1), _t(kp2), g, draws, select, keep_spatial=False)
    assert flat[0].shape == (2, 24, 2) and flat[2].shape == (2, 24, 1)
    # the port draws as JAX does: proposals in range, jitter within half a cell
    gen = torch.Generator().manual_seed(0)
    d = tsm.draw_grid_random(_t(kp1), g, select, gen)
    if select == "random":
        assert d.shape == (2, 4, 6) and 0 <= int(d.min()) and int(d.max()) < g * g
    else:
        assert d.shape == (2, 1, 1, 2) and 0 <= float(d.min()) and float(d.max()) < 1
    with pytest.raises(ValueError):
        tsm.draw_grid_random(_t(kp1), g, "nearest", gen)


def test_cell_coords_normalized(rng):
    prop = rng.randint(0, 64, (2, 3, 5))
    got = tsm.cell_coords_normalized(24, 40, 8, _t(prop).long())
    _close(got, jsm.cell_coords_normalized(24, 40, 8, jnp.asarray(prop)), 1e-6, 1e-7)


def _corr_inputs(rng):
    return _unit(rng, 2, 9, 16), _unit(rng, 2, 11, 16)


@pytest.mark.parametrize("case", ["cos", "cos_scaled_sim", "euc"])
def test_compute_prob(rng, case):
    f1, f2 = _corr_inputs(rng)
    kw = {"cos": {}, "cos_scaled_sim": dict(with_scale=True, return_sim=True),
          "euc": dict(loss_distance="euc")}[case]
    got = tcor.compute_prob(_t(f1 * 5), _t(f2), **kw)
    ref = jcor.compute_prob(jnp.asarray(f1 * 5), jnp.asarray(f2), **kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        _close(a, b)


def test_expected_correspondence_locs(rng):
    f1 = _unit(rng, 2, 9, 16, scale=8.0)
    fm = _unit(rng, 2, 6, 7, 16)
    got = tcor.get_expected_correspondence_locs(_t(f1), _t(fm), with_std=True)
    ref = jcor.get_expected_correspondence_locs(jnp.asarray(f1), jnp.asarray(fm), with_std=True)
    for a, b, name in zip(got, ref, ("expected", "std", "kurtosis", "prob")):
        _close(a, b, msg=name)
    _close(tcor.get_expected_correspondence_locs(_t(f1), _t(fm)), ref[0])


@pytest.mark.parametrize("matcher", ["ot_sinkhorn_log", "ot_sinkhorn_log_unmatch", "dual_softmax"])
def test_matchers(rng, matcher):
    f1, f2 = _corr_inputs(rng)
    costs = 1 - np.einsum("bmd,bnd->bmn", f1, f2)
    got = getattr(tcor, matcher)(_t(costs), iters=7, temperature=10.0)
    ref = getattr(jcor, matcher)(jnp.asarray(costs), iters=7, temperature=10.0)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b)


def test_epipolar_cost(rng):
    c1 = (rng.rand(2, 13, 2) * [95, 63]).astype(np.float32)
    c2 = (rng.rand(2, 13, 2) * [95, 63]).astype(np.float32)
    Fm = rand_fundamental(rng, 2).astype(np.float32)
    _close(tep.epipolar_cost(_t(c1), _t(c2), _t(Fm)),
           jep.epipolar_cost(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(Fm)))


def test_endpoints_on_missing_and_corner_lines():
    """Lines chosen through F's third column (the line of pixel (0, 0)):
    crossing the image twice, through two corners (four candidates), along
    a border, missing it to the left, above and beyond a corner, and a
    horizontal and a vertical line (divisions by zero)."""
    h, w = 48, 64
    lines = np.array([
        [1.0, 2.0, -60.0],  # crosses twice
        [h - 1.0, -(w - 1.0), 0.0],  # the diagonal through (0, 0) and (w-1, h-1)
        [-(h - 1.0), -(w - 1.0), (h - 1.0) * (w - 1.0)],  # the other diagonal
        [0.0, 1.0, 0.0],  # the top border y = 0: two corners, the other two nan/inf
        [1.0, 0.0, 5.0],  # x = -5: misses left
        [0.0, 1.0, -(h + 3.0)],  # y = h + 3: misses below
        [1.0, 1.0, 200.0],  # misses beyond a corner
        [0.0, 1.0, -17.5],  # horizontal through the image
        [1.0, 0.0, -30.25],  # vertical through the image
    ], np.float32)
    n = len(lines)
    Fm = np.zeros((1, 3, 3), np.float32)
    Fm[0] = np.eye(3)
    coords = np.zeros((1, 1, 2), np.float32)
    got, ref = [], []
    for ln in lines:
        Fm[0, :, 2] = ln
        got.append(tep.get_endpoints(_t(coords), _t(Fm), h, w))
        ref.append(jep.get_endpoints(jnp.asarray(coords), jnp.asarray(Fm), h, w))
    for i in range(n):
        for a, b, name in zip(got[i], ref[i], ("e1", "e2", "valid")):
            np.testing.assert_array_equal(np.isfinite(a.numpy()), np.isfinite(np.asarray(b)), err_msg=f"{i} {name}")
            _close(a, b, 1e-5, 1e-6, f"line {i} {name}")
    assert [bool(g[2]) for g in got] == [True, False, False, True, False, False, False, True, True]
    epi = _t(lines.T[None])  # [1, 3, n]
    for thr in (0.0, 0.5, 1.5):
        v = tep.valid_points(epi, (h, w), thr)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jep.valid_points(jnp.asarray(lines.T[None]), (h, w), thr)))


def _search_inputs(rng, B=2, Hf=12, Wf=16, D=16, n=20, T=30.0):
    h, w = 4 * Hf, 4 * Wf
    fm = _unit(rng, B, Hf, Wf, D, scale=T)
    f1 = _unit(rng, B, n, D)
    coord = (rng.rand(B, n, 2) * [w - 1, h - 1]).astype(np.float32)
    Fm = rand_fundamental(rng, B).astype(np.float32)
    return fm, f1, coord, Fm, h, w


@pytest.mark.parametrize("use_nn", [True, False])
def test_epipolar_line_search(rng, use_nn):
    fm, f1, coord, Fm, h, w = _search_inputs(rng)
    key = jax.random.PRNGKey(1)
    ref = jep.epipolar_line_search(jnp.asarray(coord), jnp.asarray(Fm), jnp.asarray(f1), jnp.asarray(fm),
                                   h, w, key=key, line_step=50, use_nn=use_nn, window_size=0.2)
    u = np.array(jax.random.uniform(key, coord.shape, jnp.float32))
    got = tep.epipolar_line_search(_t(coord), _t(Fm), _t(f1), _t(fm), h, w, jitter_u=_t(u),
                                   line_step=50, use_nn=use_nn, window_size=0.2)
    keep = np.ones(coord.shape[:2], bool)
    if use_nn:  # the probes' prob, as JAX forms it: compare where the max is clear
        e1, e2, _ = jep.get_endpoints(jnp.asarray(coord), jnp.asarray(Fm), h, w)
        ts = jnp.linspace(0.0, 1.0, 50)[:, None]
        grids = (e2 - e1)[:, :, None] * ts + e1[:, :, None]
        s = np.asarray(jgrid_sample(jnp.asarray(fm), grids, "border"))
        sim = np.sort(np.einsum("bnsd,bnd->bns", s, f1), -1)
        keep = sim[..., -1] - sim[..., -2] > MARGIN
        assert keep.mean() >= 0.9, keep.mean()
    for a, b, name in zip(got, ref, ("expected", "expected_org", "valid", "std")):
        _close(np.asarray(a)[keep], np.asarray(b)[keep], msg=name)
    with pytest.raises(ValueError, match="jitter"):
        tep.epipolar_line_search(_t(coord), _t(Fm), _t(f1), _t(fm), h, w)


def _window_inputs(rng, B=2, Hf=24, Wf=32, D=16, N=33):
    fm = _unit(rng, B, Hf, Wf, D, scale=30.0)
    f1 = _unit(rng, B, N, D)
    centers = (rng.rand(B, N, 2) * 2.2 - 1.1).astype(np.float32)
    return fm, f1, centers


def test_window_reference_matches_jax(rng):
    fm, f1, centers = _window_inputs(rng)
    got = tep.get_expected_correspondence_within_window(_t(f1), _t(fm), _t(centers), 0.25,
                                                        with_std=True, with_sim=True)
    ref = jep.get_expected_correspondence_within_window(jnp.asarray(f1), jnp.asarray(fm),
                                                        jnp.asarray(centers), 0.25, with_std=True,
                                                        with_sim=True)
    for a, b, name in zip(got, ref, ("expected", "grid", "std", "prob", "sim")):
        assert a.shape == b.shape, name
        _close(a, b, WIN_RTOL, WIN_ATOL, name)


def test_window_fused_matches_reference_values_and_grads(rng):
    """The fused window stage against the port's reference op, values and
    gradients into both the map and the queries, at tests/test_line_window.py's
    tolerance; and against JAX's fused stage."""
    fm, f1, centers = _window_inputs(rng)
    fm_t, f1_t = _t(fm).requires_grad_(), _t(f1).requires_grad_()
    ref_exp, _, ref_std, _ = tep.get_expected_correspondence_within_window(f1_t, fm_t, _t(centers), 0.25,
                                                                          with_std=True)
    g_ref = torch.autograd.grad((ref_exp ** 2).sum() + ref_std.sum(), (fm_t, f1_t))
    exp, std = tlw.window_expectation_fused(fm_t, f1_t, _t(centers), 0.25, chunk=8)
    g = torch.autograd.grad((exp ** 2).sum() + std.sum(), (fm_t, f1_t))
    _close(exp, ref_exp, WIN_RTOL, WIN_ATOL)
    _close(std, ref_std, WIN_RTOL, WIN_ATOL)
    for a, b in zip(g, g_ref):
        _close(a, b, WIN_RTOL, WIN_ATOL)
    j_exp, j_std = jlw.window_expectation_fused(jnp.asarray(fm), jnp.asarray(f1), jnp.asarray(centers), 0.25)
    _close(exp, j_exp, WIN_RTOL, WIN_ATOL)
    _close(std, j_std, WIN_RTOL, WIN_ATOL)


def _band_margin(fm, f1, coord, Fm, h, w, band_px=0.71):
    """Top-2 gap of the band-masked correlation map per query, as
    _line_band_argmax forms it (numpy)."""
    B, Hf, Wf, _ = fm.shape
    pf = np.einsum("bpd,byxd->bpyx", f1, fm)
    cW, cH = (w - 1) / 2.0, (h - 1) / 2.0
    line = np.einsum("bij,bnj->bin", Fm, np.concatenate([coord, np.ones_like(coord[..., :1])], -1))
    a = line[:, 0] * (2 * cW / Wf)
    b = line[:, 1] * (2 * cH / Hf)
    c = line[:, 2] + line[:, 0] * (cW / Wf) + line[:, 1] * (cH / Hf)
    nrm = np.sqrt(a * a + b * b)
    ys, xs = np.mgrid[0:Hf, 0:Wf]
    dist = np.abs((a / nrm)[..., None, None] * xs + (b / nrm)[..., None, None] * ys + (c / nrm)[..., None, None])
    masked = np.where(dist <= band_px, pf, -np.inf).reshape(B, -1, Hf * Wf)
    top = np.sort(masked, -1)
    with np.errstate(invalid="ignore"):  # an empty band: -inf - -inf
        return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("use_nn", [True, False])
def test_fused_line_window_on_jax_jitter(rng, use_nn):
    """fused_line_window on JAX's jitter (one key per JAX chunk of 8) with
    the port's chunk of 5: every output, argmax centres compared where
    the band's top-2 gap clears MARGIN."""
    fm, f1, coord, Fm, h, w = _search_inputs(rng, Hf=15, Wf=20, n=21)
    key = jax.random.PRNGKey(2)
    ref = jlw.fused_line_window(jnp.asarray(fm), jnp.asarray(f1), jnp.asarray(coord), jnp.asarray(Fm), h, w,
                                key=key, window_size=0.2, use_nn=use_nn, chunk=8)
    keys = jax.random.split(key, 3)
    u = np.concatenate([np.array(jax.random.uniform(k, (2, 8, 2), jnp.float32)) for k in keys], 1)[:, :21]
    fm_t, f1_t = _t(fm).requires_grad_(), _t(f1).requires_grad_()
    got = tlw.fused_line_window(fm_t, f1_t, _t(coord), _t(Fm), h, w, window_size=0.2, jitter_u=_t(u),
                                use_nn=use_nn, chunk=5)
    keep = np.ones(coord.shape[:2], bool)
    if use_nn:
        margin = _band_margin(fm, f1, coord, Fm, h, w)
        keep = ~(margin <= MARGIN)  # a band with one pixel has gap inf, none nan
        assert keep.mean() >= 0.9, keep.mean()
    names = ("center", "center_org", "valid", "win_expected", "win_std")
    for a, b, name in zip(got, ref, names):
        assert a.shape == b.shape, name
        _close(np.asarray(a.detach())[keep], np.asarray(b)[keep], WIN_RTOL, WIN_ATOL, name)
    assert bool(got[2].any())
    assert not got[0].requires_grad
    if use_nn:
        # gradients reach both the map and the queries through the window
        # stage (without use_nn a band with no pixel gives a nan centre, in
        # JAX as here)
        g = torch.autograd.grad(got[3].sum() + got[4].sum(), (fm_t, f1_t))
        assert all(bool(x.abs().sum() > 0) and bool(torch.isfinite(x).all()) for x in g)
    # the chunk does not change the result beyond the matmul's rounding
    again = tlw.fused_line_window(_t(fm), _t(f1), _t(coord), _t(Fm), h, w, window_size=0.2,
                                  jitter_u=_t(u), use_nn=use_nn, chunk=64)
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_sampled_similarity(rng, padding):
    fm = rng.randn(2, 9, 11, 8).astype(np.float32)
    f1 = rng.randn(2, 7, 8).astype(np.float32)
    pos = (rng.rand(2, 7, 5, 2) * 2.4 - 1.2).astype(np.float32)
    got = tss.sampled_similarity(_t(fm), _t(f1), _t(pos), padding, chunk=3)
    _close(got, jss.sampled_similarity(jnp.asarray(fm), jnp.asarray(f1), jnp.asarray(pos), padding, chunk=4))
    # the definition: the dot of grid_sample's samples with the queries
    direct = (grid_sample(_t(fm), _t(pos), padding) * _t(f1)[:, :, None]).sum(-1)
    _close(got, direct, 1e-5, 1e-5)
