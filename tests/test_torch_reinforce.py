"""posfeat_tpu_torch's streamed REINFORCE reduction: its plain version on
the CPU against the Pallas ``reinforce_reduction`` run with
interpret=True, and the CUDA kernels against their plain versions on the
card (marked ``gpu``).

JAX is imported inside the tests that use it: the card's machine has no
JAX, and runs the ``gpu`` test with
``python -m pytest --noconftest -m gpu tests/test_torch_reinforce.py``."""

import numpy as np
import pytest
import torch

from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import reinforce as rf

# tolerance of the JAX reduction test (test_pallas_reinforce.py:70)
RTOL, ATOL = 2e-4, 1e-5
KW = dict(temperature=10.0, thr=5.0, good_reward=1.0, bad_reward=-0.25)


def _fundamental(rng, B):
    """Random rank-2 fundamental matrices (test_ops_parity.rand_fundamental)."""
    out = []
    for _ in range(B):
        u, _, vt = np.linalg.svd(rng.randn(3, 3))
        out.append(u @ np.diag([1.0, rng.uniform(0.3, 1.0), 0.0]) @ vt)
    return np.stack(out).astype(np.float32)


def _problem(rng, B=2, m=37, n=29, D=16):
    """Numpy inputs of the reduction, drawn as test_pallas_reinforce's
    ``_random_problem`` draws them."""

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def homog(c):
        return np.concatenate([c, np.ones_like(c[..., :1])], -1)

    def lines_of(fm, c):
        line = fm @ homog(c).transpose(0, 2, 1)
        line = line / np.clip(np.linalg.norm(line[:, :2], axis=1, keepdims=True), 1e-8, None)
        return line.transpose(0, 2, 1)

    f1 = unit(rng.randn(B, m, D).astype(np.float32))
    f2 = unit(rng.randn(B, n, D).astype(np.float32))
    c1 = rng.rand(B, m, 2).astype(np.float32) * 100
    c2 = rng.rand(B, n, 2).astype(np.float32) * 100
    F1, F2 = _fundamental(rng, B), _fundamental(rng, B)
    a1 = (rng.rand(B, m) > 0.4).astype(np.float32)
    a2 = (rng.rand(B, n) > 0.4).astype(np.float32)
    args = (f1, f2, lines_of(F1, c1), homog(c2), lines_of(F2, c2), homog(c1), a1, a2)
    return [np.ascontiguousarray(a, np.float32) for a in args]


def test_plain_reduction_matches_pallas_interpret(rng):
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.reinforce import reinforce_reduction as jax_reduction

    args = _problem(rng)
    ref = jax_reduction(*map(jnp.asarray, args), **KW, tm=16, interpret=True)
    got = rf.reinforce_reduction(*map(torch.from_numpy, args), **KW)
    assert len(got) == 7
    for g, r in zip(got, ref):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_kernel_wrappers_take_plain_versions_on_cpu(rng):
    """On CPU tensors the two kernel wrappers are their plain versions,
    and their composition is the dense reduction."""
    f1, f2, l1, c2h, l2, c1h, a1, a2 = map(torch.from_numpy, _problem(rng, m=70, n=65))
    rf.lse_pass.launches = rf.reward_pass.launches = 0
    row_lse, col_lse = rf.lse_pass(f1, f2, KW["temperature"])
    aff = KW["temperature"] * torch.bmm(f1, f2.mT) - KW["temperature"]
    torch.testing.assert_close(row_lse, torch.logsumexp(aff, 2), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(col_lse, torch.logsumexp(aff, 1), rtol=1e-6, atol=1e-6)
    out = rf.reward_pass(f1, f2, l1, c2h, l2, c1h, a1, a2, row_lse, col_lse, **KW)
    dense = rf.reinforce_reduction(f1, f2, l1, c2h, l2, c1h, a1, a2, **KW)
    for o, d in zip(out[:7], dense):
        torch.testing.assert_close(o, d)
    good = (rf._line_dist(l1, c2h) < KW["thr"]) & (rf._line_dist(c1h, l2) < KW["thr"])
    torch.testing.assert_close(out[7], good.sum(dim=(1, 2)).float())
    assert rf.lse_pass.launches == rf.reward_pass.launches == 0
    # p sums to at most 1 along each row and column of the dual softmax
    assert (out[3] <= 1 + 1e-5).all() and (out[4] <= 1 + 1e-5).all()


def _row_tile_partials(aff, tile):
    """Per-row-tile column (max, Σexp) partials [B, tiles, n] of aff
    [B, m, n], as the lse-pass kernel writes them."""
    tiles = torch.split(aff, tile, dim=1)
    mx = torch.stack([t.amax(dim=1) for t in tiles], 1)
    se = torch.stack([torch.exp(t - m[:, None]).sum(dim=1) for t, m in zip(tiles, mx.unbind(1))], 1)
    return mx, se


@pytest.mark.parametrize("D", [36, 256])
@pytest.mark.parametrize("temperature", [10.0, 60.0])
def test_col_partials_merge_matches_logsumexp(rng, temperature, D):
    """The lse wrapper's merge of the kernel's column partials, fed
    partials of the plain affinity at a ragged m (three tiles of TILE_M
    rows, the last one short) as the kernel writes them, is the column
    log-sum-exp: one partial per row tile where f1 stays resident (D =
    36), one per half tile where it streams (D = 256), the last half tile
    holding no row (max -1e30 in base 2, Σexp 0)."""
    m = 2 * rf.TILE_M + 44
    f1, f2 = (torch.from_numpy(a) for a in _problem(rng, B=2, m=m, n=97, D=D)[:2])
    aff = rf._affinity(f1, f2, temperature)
    rows = rf.TILE_M * -(-m // rf.TILE_M) // rf._partials(m, D)
    mx, se = _row_tile_partials(aff, rows)
    empty = rf._partials(m, D) - mx.shape[1]
    mx = torch.cat([mx, torch.full((2, empty, 97), -1e30 * float(np.log(2.0)))], 1)
    se = torch.cat([se, torch.zeros(2, empty, 97)], 1)
    assert mx.shape == (2, 3 if D == 36 else 6, 97)
    torch.testing.assert_close(rf.merge_col_partials(mx, se), torch.logsumexp(aff, 1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("blocks, n_ct, sms, want", [(228, 38, 132, 4), (264, 38, 132, 1), (12, 3, 132, 1),
                                                     (12, 38, 132, 4), (228, 38, 114, 1)])
def test_column_splits_shorten_the_longest_path(blocks, n_ct, sms, want):
    """The streamed passes cut each row tile's column tiles into the count
    of ranges (up to 4, each at least 4 tiles) whose waves of blocks give
    the fewest tiles on the longest path: at the training path's 228 blocks
    of 38 tiles on 132 SMs, 4 (7 waves of 10 tiles against 2 of 38); none
    where the blocks fill whole waves or a tile row is short."""
    assert rf._column_splits(blocks, n_ct, sms) == want


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half of the last kept bit to
    the magnitude's bits, then clear the 13 dropped bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product_3xtf32(f1, f2):
    """f1·f2ᵀ as the lse-pass kernel's tensor cores form it: each operand
    split once into TF32 hi + lo, lo·hi + hi·lo + hi·hi summed in f32."""
    def split(x):
        hi = _tf32_rna(x)
        return torch.from_numpy(hi), torch.from_numpy(_tf32_rna(x - hi))

    h1, l1 = split(f1)
    h2, l2 = split(f2)
    mm = lambda a, b: torch.bmm(a, b.transpose(1, 2))
    return (mm(l1, h2) + mm(h1, l2)) + mm(h1, h2)


def _rz(x):
    """float64 x rounded to f32 toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _product_3xtf32_truncating(f1, f2, depth=8):
    """f1·f2ᵀ as the passes' product forms it on the card: per chunk of
    ``depth`` (8 or 16) depths, lo·hi and hi·lo of each 8-deep step of
    the chunk, then hi·hi of each, into one tensor-core accumulator, each
    result truncated toward zero (the tensor cores' accumulation), then
    added to an f32 running sum rounded to nearest."""
    h1, h2 = _tf32_rna(f1), _tf32_rna(f2)
    parts = [torch.from_numpy(a).double() for a in (h1, _tf32_rna(f1 - h1), h2, _tf32_rna(f2 - h2))]
    h1, l1, h2, l2 = parts
    mm = lambda a, b: torch.bmm(a, b.transpose(1, 2))  # noqa: E731
    acc = torch.zeros(f1.shape[0], f1.shape[1], f2.shape[1])
    for k in range(0, f1.shape[2], depth):
        steps = [slice(j, j + 8) for j in range(k, min(k + depth, f1.shape[2]), 8)]
        terms = [t for s in steps for t in ((l1, h2, s), (h1, l2, s))] + [(h1, h2, s) for s in steps]
        d = None
        for a, b, s in terms:
            p = mm(a[..., s], b[..., s])
            d = _rz(p if d is None else d.double() + p)
        acc = acc + d
    return acc


def _kernel_dots(f1, f2):
    """The dots of the passes' product at f1 and f2's width: a rounded
    add per 8-deep step while f1 stays resident, per 16-deep chunk where
    it streams (csrc/reinforce.cu product_tiles, stream_product)."""
    return _product_3xtf32_truncating(f1, f2, 8 if rf.f1_resident(f1.shape[-1]) else rf.CHUNK)


def test_tf32_rounding_model():
    """The bit model of cvt.rna.tf32.f32: 10 mantissa bits kept, halfway
    cases rounded away from zero, the rest to nearest."""
    up = 1.0 + 2.0 ** -10  # the TF32 neighbour above 1
    x = np.array([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, -7.25],
                 np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), np.array([1.0, up, -up, 1.0, up, -7.25], np.float32))
    y = np.random.RandomState(0).randn(1000).astype(np.float32)
    r = _tf32_rna(y)
    assert not (r.view(np.uint32) & 0x1FFF).any() and (np.abs(r - y) <= 2.0 ** -11 * np.abs(y)).all()


def _unsplit(f1s, f2s, B, m, n, D):
    """(hi, lo) of f1 [B, m', depth] and of f2 [B, n', depth] (m', n'
    whole tiles) read back from the split tiles at the offsets the
    kernels read them: up to D = RESIDENT_D a block's f1 tile at
    (b * row_tiles + tile) * 2 * (depth / 4) * 128 * 4 floats, hi then
    lo, each [depth / 4][128][4]; f2's chunk i = column_tile * chunks + c
    at i * 2 * 16 * 128 floats, hi then lo, each [4][128][4], and so a
    wider f1's chunk c of row tile i. Where f1 streams, a tile holds an
    even count of chunks (zero beyond D)."""
    t, ck = rf.TILE_M, rf.CHUNK
    nck = -(-D // ck)
    if not rf.f1_resident(D):
        nck += nck % 2
    depth, mt, nt = ck * nck, -(-m // t), -(-n // t)

    def chunked(x, tiles):
        c = x.view(B * tiles, nck, 2, ck // 4, t, 4)  # [tile][chunk][hi, lo][q][r][k]
        return c.permute(2, 0, 4, 1, 3, 5).reshape(2, B, tiles * t, depth)

    if rf.f1_resident(D):
        a = f1s.view(B * mt, 2, depth // 4, t, 4)  # [block][hi, lo][q][r][k]
        a = a.permute(1, 0, 3, 2, 4).reshape(2, B, mt * t, depth)
    else:
        a = chunked(f1s, mt)
    return a, chunked(f2s, nt)


@pytest.mark.parametrize("D", [128, 36, 20, 126, 30, 5, 256, 200])
def test_split_layout_is_what_both_kernels_read(D):
    """``_split_operands`` on the CPU, ``_split_plain``, gives f1 and f2 as
    the kernels read them, in the tile layout [B][tile][chunk][hi, lo][cq]
    [128][4] that ``lse_split_kernel`` writes (f1 whole up to D = 128, in
    16-deep chunks beyond, where it streams, an even count of them per
    tile, as f2's there): read back at the passes' offsets, hi is x
    rounded to TF32 bit for bit (the numpy model of cvt.rna), lo is x - hi
    rounded, zero beyond m, n and D; the 3xTF32 product of the tiles is
    the modelled one."""
    B, m, n = 2, 2 * rf.TILE_M + 3, rf.TILE_M + 1
    args = _problem(np.random.RandomState(D), B=B, m=m, n=n, D=D)
    f1s, f2s = rf._split_operands(torch.from_numpy(args[0]), torch.from_numpy(args[1]))
    assert f1s.shape == (rf._split_floats(B, m, D),) and f2s.shape == (rf._split_floats(B, n, D),)
    (h1, l1), (h2, l2) = _unsplit(f1s, f2s, B, m, n, D)
    for x, hi, lo, rows in ((args[0], h1, l1, m), (args[1], h2, l2, n)):
        want_hi = _tf32_rna(x)
        np.testing.assert_array_equal(hi[:, :rows, :D].numpy(), want_hi)
        np.testing.assert_array_equal(lo[:, :rows, :D].numpy(), _tf32_rna(x - want_hi))
        assert not hi[:, rows:].any() and not hi[:, :, D:].any() and not lo[:, rows:].any() and not lo[:, :, D:].any()
    mm = lambda a, b: torch.bmm(a, b.transpose(1, 2))  # noqa: E731
    got = ((mm(l1, h2) + mm(h1, l2)) + mm(h1, h2))[:, :m, :n]
    torch.testing.assert_close(got, _product_3xtf32(args[0], args[1]), rtol=0, atol=1e-6)


def test_column_operands_pack_and_padding(rng):
    """``_pack_columns`` lays each column tile's c2h, line2, accept2 and
    col_lse out as 8 arrays of 128; the columns beyond n and, as the
    reward kernel fills them, the rows beyond m (NaN lines, accept 0, lse
    1e30) add nothing to any output of the plain reward arithmetic."""
    B, m, n, D = 2, 130, rf.TILE_M + 5, 16
    f1, f2, l1, c2h, l2, c1h, a1, a2 = map(torch.from_numpy, _problem(rng, B=B, m=m, n=n, D=D))
    T = KW["temperature"]
    rl, cl = rf.lse_pass_plain(f1, f2, T)
    cols = rf._pack_columns(c2h, l2, a2, cl)
    assert cols.shape == (B, 2, 8, rf.TILE_M) and cols.is_contiguous()
    flat = cols.permute(0, 1, 3, 2).reshape(B, 2 * rf.TILE_M, 8)
    torch.testing.assert_close(flat[:, :n], torch.cat([c2h, l2, a2[..., None], cl[..., None]], -1), rtol=0, atol=0)
    assert flat[:, n:, :6].isnan().all() and (flat[:, n:, 6] == 0).all() and (flat[:, n:, 7] == 1e30).all()
    # rows padded as the kernel pads them
    mp = 2 * rf.TILE_M
    nan_rows = torch.full((B, mp - m, 3), float("nan"))
    rows = dict(line1=torch.cat([l1, nan_rows], 1), c1h=torch.cat([c1h, nan_rows], 1),
                accept1=torch.cat([a1, torch.zeros(B, mp - m)], 1),
                row_lse=torch.cat([rl, torch.full((B, mp - m), 1e30)], 1))
    aff = torch.nn.functional.pad(rf._affinity(f1, f2, T), (0, flat.shape[1] - n, 0, mp - m), value=-T)
    padded = rf._reward_of_affinity(aff, rows["line1"], flat[..., :3], flat[..., 3:6], rows["c1h"], rows["accept1"],
                                    flat[..., 6], rows["row_lse"], flat[..., 7], thr=KW["thr"],
                                    good_reward=KW["good_reward"], bad_reward=KW["bad_reward"])
    want = rf.reward_pass_plain(f1, f2, l1, c2h, l2, c1h, a1, a2, rl, cl, **KW)
    got = (padded[0], padded[1][:, :m], padded[2][:, :n], padded[3][:, :m], padded[4][:, :n], *padded[5:])
    assert not padded[1][:, m:].any() and not padded[3][:, m:].any() and not padded[2][:, n:].any()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _aff_of_dots(dot, T):
    """aff as both passes form it from their dots (csrc/reinforce.cu
    ``aff_log2``, then the reward pass's scale by ln 2): v = fmaf(dot, Tl,
    -Tl) with Tl = T * log2(e) rounded to f32, one rounding (dot * Tl is
    exact in float64), then v * ln 2 rounded to f32."""
    tl = float(np.float32(T) * np.float32(np.log2(np.e)))
    v = (dot.double() * tl - tl).float()
    return v * torch.tensor(np.log(2.0), dtype=torch.float32)


@pytest.mark.parametrize("D", [128, 36, 126, 256, 200])
def test_3xtf32_reward_model_matches_pallas_interpret(D):
    """The reward pass on the lse pass's 3xTF32 product, modelled on the
    CPU at the training path's T = 60: the modelled dots (the tensor
    cores' truncation included), turned into aff with the kernels'
    arithmetic (base 2, then ln 2), with the log-sum-exps of the same
    modelled affinity, pushed through the plain reward arithmetic; all
    seven outputs against the Pallas reduction (interpret=True) and the
    plain reduction at the reduction's tolerance, and the good decisions
    as the plain version's (they read no product)."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.reinforce import reinforce_reduction as jax_reduction

    kw = dict(KW, temperature=60.0)
    T = kw["temperature"]
    args = _problem(np.random.RandomState(D + 1), B=2, m=300, n=290, D=D)
    t = list(map(torch.from_numpy, args))
    aff = _aff_of_dots(_kernel_dots(args[0], args[1]), T)
    row_lse, col_lse = torch.logsumexp(aff, 2), torch.logsumexp(aff, 1)
    rkw = {k: kw[k] for k in ("thr", "good_reward", "bad_reward")}
    got = rf._reward_of_affinity(aff, *t[2:], row_lse, col_lse, **rkw)
    ref = jax_reduction(*map(jnp.asarray, args), **kw, interpret=True)
    for g, r in zip(got[:7], ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    plain = rf.reinforce_reduction_plain(*t, **kw)
    n_good = rf.reward_pass_plain(*t, *rf.lse_pass_plain(t[0], t[1], T), **kw)[7]
    assert (got[7] - n_good).abs().sum() <= 1e-3 * n_good.sum()
    for g, p in zip(got[:7], plain):
        torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [128, 64, 130, 126, 30, 129])
def test_streamed_loss_only_at_widths_the_kernels_take(D):
    """The kernels take any positive width, as the JAX reduction does, so
    DiskLoss picks the streamed reduction in the streamed configuration
    at every width, D = 129 and 130 beyond the resident f1 tile included,
    with no warning; ``use_pallas: False`` still takes the dense loss."""
    import warnings

    from posfeat_tpu_torch.losses import DiskLoss

    cfg = dict(_SHIPPED_LOSS, use_pallas="auto")
    assert rf.kernels_take(D) and not rf.kernels_take(0)
    assert rf.f1_resident(D) is (D <= 128)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert DiskLoss(cfg)._use_streamed() is True
        assert DiskLoss(dict(cfg, use_pallas=False))._use_streamed() is False
    assert not caught


# configs/train_kp.yaml's DiskLoss_config, the streamed path's configuration
_SHIPPED_LOSS = {
    "grid_size": 8, "loss_distance": "cos", "temperature_base": 5, "temperature_max": 60,
    "epipolar_reward": "constant_reward", "reward_config": {"reward_thr": 4, "rescale_thr": False},
    "cor_detach": True, "good_reward": 1, "bad_reward": -0.25, "kp_penalty": -0.001, "match_grad": False,
}


@pytest.mark.parametrize("D", [130, 256])
def test_wide_descriptors_take_the_streamed_loss(D, monkeypatch):
    """At D = 130 and 256 (beyond the resident f1 tile of 128) a DiskLoss
    step in the streamed configuration takes the streamed reduction, with
    no warning, on the same draws as the dense step and as JAX's DiskLoss
    with its Pallas reduction (interpret=True): the loss at rtol 2e-4 and
    the score maps' gradient at rtol 2e-3 (test_pallas_reinforce.py:121-128),
    the streamed against the dense step and against JAX."""
    import warnings

    import jax
    import jax.numpy as jnp

    from posfeat_tpu.losses.disk_loss import DiskLoss as JaxDiskLoss
    from posfeat_tpu_torch.losses import DiskLoss
    from posfeat_tpu_torch.losses import disk_loss as dl
    from torch_port_helpers import jax_disk_draws, torch_draws

    rng = np.random.RandomState(4)
    B, H, W, G = 2, 32, 48, 8
    kp1, kp2 = (rng.randn(B, H, W, 1).astype(np.float32) for _ in range(2))
    xf1 = rng.randn(B, H // 4, W // 4, D).astype(np.float32)
    xf2 = (xf1 + 0.3 * rng.randn(B, H // 4, W // 4, D)).astype(np.float32)
    F = _fundamental(rng, B)
    Ft = np.ascontiguousarray(F.transpose(0, 2, 1))
    key = jax.random.PRNGKey(5)
    draws = jax_disk_draws(kp1, kp2, key, G)

    def step(cfg):
        k1, k2 = torch.from_numpy(kp1).requires_grad_(True), torch.from_numpy(kp2).requires_grad_(True)
        out = {"preds1": {"local_point": k1, "local_map": torch.from_numpy(xf1)},
               "preds2": {"local_point": k2, "local_map": torch.from_numpy(xf2)}, "epoch": 1}
        loss, comps = DiskLoss(cfg)({"F1": torch.from_numpy(F), "F2": torch.from_numpy(Ft)}, out, None,
                                    draws=torch_draws(draws))
        loss.backward()
        return loss.item(), comps, [k1.grad.numpy(), k2.grad.numpy()]

    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape[-1])
        return rf.reinforce_reduction(*a, **k)

    monkeypatch.setattr(dl, "reinforce_reduction", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        l_st, c_st, g_st = step(dict(_SHIPPED_LOSS, use_pallas="auto"))
    assert calls == [D]
    l_de, c_de, g_de = step(dict(_SHIPPED_LOSS, use_pallas=False))
    assert calls == [D] and np.isfinite(l_st)

    jax_loss = JaxDiskLoss(dict(_SHIPPED_LOSS, use_pallas="interpret"))

    def f(a, b):
        outputs = {"preds1": {"local_point": a, "local_map": jnp.asarray(xf1)},
                   "preds2": {"local_point": b, "local_map": jnp.asarray(xf2)}, "epoch": 1}
        return jax_loss({"F1": jnp.asarray(F), "F2": jnp.asarray(Ft)}, outputs, None, key=key)

    (l_jax, c_jax), g_jax = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(kp1), jnp.asarray(kp2))
    for l_ref, g_ref in ((l_de, g_de), (float(l_jax), [np.asarray(g) for g in g_jax])):
        np.testing.assert_allclose(l_st, l_ref, rtol=2e-4, atol=1e-5)
        for g, r in zip(g_st, g_ref):
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(float(c_st["reinforce"]), float(c_jax["reinforce"]), rtol=2e-4, atol=1e-6)
    assert set(c_st) == set(c_de) and "cor max" in c_st


@pytest.mark.parametrize("D", [128, 36, 256, 200])
def test_3xtf32_lse_model_matches_pallas_interpret(D):
    """The lse pass's 3xTF32 product, modelled on the CPU, at the
    training path's T = 60: its row and column log-sum-exp against the
    plain f32 version, and the whole reduction on them against the
    Pallas reduction (interpret=True), at the reduction's tolerance.
    Where f1 streams (D = 256, 200) the model is the streamed product's
    schedule, the tensor cores' truncation and a rounded add per 16-deep
    chunk, turned into aff with the kernels' arithmetic."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.reinforce import reinforce_reduction as jax_reduction

    kw = dict(KW, temperature=60.0)
    T = kw["temperature"]
    args = _problem(np.random.RandomState(D), B=2, m=300, n=290, D=D)
    t = list(map(torch.from_numpy, args))
    if rf.f1_resident(D):
        aff = T * _product_3xtf32(args[0], args[1]) - T
    else:
        aff = _aff_of_dots(_kernel_dots(args[0], args[1]), T)
    row_lse, col_lse = torch.logsumexp(aff, 2), torch.logsumexp(aff, 1)
    rlp, clp = rf.lse_pass_plain(t[0], t[1], T)
    torch.testing.assert_close(row_lse, rlp, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(col_lse, clp, rtol=RTOL, atol=ATOL)
    got = rf.reward_pass_plain(*t, row_lse, col_lse, **kw)[:7]
    ref = jax_reduction(*map(jnp.asarray, args), **kw, interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [(2, 150, 97, 128), (1, 64, 64, 16), (3, 37, 200, 36), (2, 129, 257, 16), (1, 129, 257, 128),
     (2, 150, 97, 36), (1, 300, 130, 128), (2, 150, 600, 36), (2, 389, 261, 128), (1, 517, 300, 20),
     (2, 150, 97, 126), (1, 260, 131, 30), (2, 129, 70, 5), (2, 150, 97, 256), (1, 389, 261, 256),
     (2, 129, 257, 200), (1, 300, 130, 130), (2, 150, 97, 129), (1, 260, 131, 520)],
    ids=["ragged_d128", "one_tile_d16", "ragged_d36", "ragged_129x257_d16", "ragged_129x257_d128",
         "ragged_d36_b", "three_row_tiles_d128", "five_column_tiles_d36", "four_row_tiles_d128",
         "five_row_tiles_d20", "ragged_depth_d126", "ragged_depth_d30", "ragged_depth_d5",
         "streamed_d256", "four_row_tiles_d256", "streamed_ragged_depth_d200", "streamed_d130",
         "streamed_ragged_depth_d129", "streamed_d520"],
)
def test_cuda_kernels_match_plain_versions(shape):
    """Each kernel against its plain version on the same inputs (the
    split bit for bit), and the whole reduction, on one split, against
    the dense one, ragged edges included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")  # also keeps the f32 plain versions out of TF32
    B, m, n, D = shape
    args = [torch.from_numpy(a).to(dev) for a in _problem(np.random.RandomState(1), B, m, n, D)]
    f1, f2, l1, c2h, l2, c1h, a1, a2 = args
    T = KW["temperature"]
    f1s, f2s = rf._split_operands(f1, f2)
    torch.cuda.synchronize()
    assert torch.equal(f1s, rf._split_plain(f1, rf.f1_resident(D))) and torch.equal(f2s, rf._split_plain(f2, False))
    n0 = (rf.lse_pass.launches, rf.reward_pass.launches, rf._split_operands.launches)
    rl, cl = rf.lse_pass(f1, f2, T)
    torch.cuda.synchronize()
    rlp, clp = rf.lse_pass_plain(f1, f2, T)
    torch.testing.assert_close(rl, rlp, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cl, clp, rtol=RTOL, atol=ATOL)
    out = rf.reward_pass(*args, rlp, clp, **KW)
    torch.cuda.synchronize()
    ref = rf.reward_pass_plain(*args, rlp, clp, **KW)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=RTOL, atol=ATOL)
    # each pass alone splits for itself; the reduction splits once for both
    assert rf._split_operands.launches == n0[2] + 2
    got = rf.reinforce_reduction(*args, **KW)
    want = rf.reinforce_reduction_plain(*args, **KW)
    for o, r in zip(got, want):
        torch.testing.assert_close(o, r, rtol=RTOL, atol=ATOL)
    assert (rf.lse_pass.launches, rf.reward_pass.launches, rf._split_operands.launches) == (
        n0[0] + 2, n0[1] + 2, n0[2] + 3)
    with pytest.raises(TypeError):
        rf.lse_pass(f1.double(), f2.double(), T)
