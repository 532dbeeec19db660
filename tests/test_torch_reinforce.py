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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 150, 97, 128), (1, 64, 64, 16), (3, 37, 200, 36)],
                         ids=["ragged_d128", "one_tile_d16", "ragged_d36"])
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
