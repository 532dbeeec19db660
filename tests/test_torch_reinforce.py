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


@pytest.mark.parametrize("temperature", [10.0, 60.0])
def test_col_partials_merge_matches_logsumexp(rng, temperature):
    """The lse wrapper's merge of the kernel's column partials, fed
    partials of the plain affinity over row tiles of TILE_M rows at a
    ragged m (three tiles, the last one short), is the column
    log-sum-exp."""
    f1, f2 = (torch.from_numpy(a) for a in _problem(rng, B=2, m=2 * rf.TILE_M + 44, n=97, D=36)[:2])
    aff = rf._affinity(f1, f2, temperature)
    mx, se = _row_tile_partials(aff, rf.TILE_M)
    assert mx.shape == (2, 3, 97)
    torch.testing.assert_close(rf.merge_col_partials(mx, se), torch.logsumexp(aff, 1), rtol=1e-6, atol=1e-5)


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


@pytest.mark.parametrize("D", [128, 36])
def test_3xtf32_lse_model_matches_pallas_interpret(D):
    """The lse pass's 3xTF32 product, modelled on the CPU, at the
    training path's T = 60: its row and column log-sum-exp against the
    plain f32 version, and the whole reduction on them against the
    Pallas reduction (interpret=True), at the reduction's tolerance."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.reinforce import reinforce_reduction as jax_reduction

    kw = dict(KW, temperature=60.0)
    T = kw["temperature"]
    args = _problem(np.random.RandomState(D), B=2, m=300, n=290, D=D)
    t = list(map(torch.from_numpy, args))
    aff = T * _product_3xtf32(args[0], args[1]) - T
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
     (2, 150, 97, 36), (1, 300, 130, 128), (2, 150, 600, 36)],
    ids=["ragged_d128", "one_tile_d16", "ragged_d36", "ragged_129x257_d16", "ragged_129x257_d128",
         "ragged_d36_b", "three_row_tiles_d128", "five_column_tiles_d36"],
)
def test_cuda_kernels_match_plain_versions(shape):
    """Each kernel against its plain version on the same inputs, and the
    whole reduction against the dense one, ragged edges included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")  # also keeps the f32 plain versions out of TF32
    B, m, n, D = shape
    args = [torch.from_numpy(a).to(dev) for a in _problem(np.random.RandomState(1), B, m, n, D)]
    f1, f2, l1, c2h, l2, c1h, a1, a2 = args
    T = KW["temperature"]
    n0 = (rf.lse_pass.launches, rf.reward_pass.launches)
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
    got = rf.reinforce_reduction(*args, **KW)
    want = rf.reinforce_reduction_plain(*args, **KW)
    for o, r in zip(got, want):
        torch.testing.assert_close(o, r, rtol=RTOL, atol=ATOL)
    assert (rf.lse_pass.launches, rf.reward_pass.launches) == (n0[0] + 2, n0[1] + 2)
    with pytest.raises(TypeError):
        rf.lse_pass(f1.double(), f2.double(), T)
