"""posfeat_tpu_torch's fused head (plain versions of K1/K2 on the CPU)
against the Pallas ``fused_head_tail`` run with interpret=True, and the
CUDA kernels against their plain versions on the card (marked ``gpu``).

JAX is imported inside the tests that use it: the card's machine has no
JAX, and runs the ``gpu`` test with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_head.py``."""

import numpy as np
import pytest
import torch

from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import fused_head as fh

# tolerance of the JAX fused-head tests (test_pallas_fused_head.py:97)
RTOL, ATOL = 2e-3, 2e-4


def _setup(rng, B=2, h=12, w=16, cin=24, cy=16, cout=32, out=2):
    """Same shapes and draws as test_pallas_fused_head._setup."""
    f = np.float32
    return (
        rng.randn(B, h, w, cin).astype(f),
        rng.randn(B, 4 * h, 4 * w, 3).astype(f),
        rng.randn(3, 3, 3, cy).astype(f) * 0.2,
        rng.randn(cy).astype(f) * 0.1,
        rng.randn(3, 3, cin, cout).astype(f) * 0.1,
        rng.randn(3, 3, cy, cout).astype(f) * 0.1,
        rng.randn(cout).astype(f) * 0.1,
        rng.randn(1, 1, cout, out).astype(f) * 0.1,
        rng.randn(out).astype(f) * 0.1,
        np.asarray([0.25], f),
    )


def _img_branch_np(s, k1, b1):
    import jax
    import jax.numpy as jnp

    y = jax.lax.conv_general_dilated(
        jnp.asarray(s), jnp.asarray(k1), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    ) + jnp.asarray(b1)
    n = y.shape[1] * y.shape[2]
    mu = jnp.sum(y, axis=(1, 2)) / n
    var = jnp.maximum(jnp.sum(y * y, axis=(1, 2)) / n - mu * mu, 0.0)
    return np.asarray(y), np.asarray(mu), np.asarray(jax.lax.rsqrt(var + 1e-5))


def _both(args, debug=False):
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.fused_head import fused_head_tail as jax_fused_head_tail

    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = args
    y, mu, ia = _img_branch_np(s, k1, b1)
    ops = (trunk, s, y, mu, ia, k1, b1, k2t, k2i, b2, w3, b3, a)
    ref = jax_fused_head_tail(
        *map(jnp.asarray, ops), act="Softplus", interpret=True,
        debug_intermediates=debug,
    )
    port_ops = (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)  # IN stats from the gram form
    got = fh.fused_head_tail(
        *(torch.from_numpy(np.array(o)) for o in port_ops), act="Softplus",
        debug_intermediates=debug,
    )
    return ref, got


@pytest.mark.parametrize(
    "shape",
    [
        dict(out=1),
        dict(out=2),
        # odd tiles: h=6 -> the JAX th=2 fallback, w=20 -> tw=4
        dict(B=1, h=6, w=20, cin=8, cy=8, cout=16, out=1),
    ],
    ids=["out1", "out2", "odd_tiles"],
)
def test_fused_head_matches_pallas_interpret(rng, shape):
    ref, got = _both(_setup(rng, **shape))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_fused_head_intermediates_match(rng):
    """K1's z and pooled IN1 moments, and K2's u (ring rewritten), against
    JAX's debug_intermediates."""
    (_, dref), (_, dgot) = _both(_setup(rng, out=2), debug=True)
    B, cout = dgot["mu"].shape
    kk = 16
    np.testing.assert_allclose(dgot["z"].numpy(), np.asarray(dref["z"]), rtol=RTOL, atol=ATOL)
    s1_ref = np.asarray(dref["ssum"]).reshape(B, -1, kk, cout).sum(axis=(1, 2))
    np.testing.assert_allclose(dgot["s1"].numpy(), s1_ref, rtol=RTOL, atol=1e-2)
    for key in ("mu", "sc", "u", "mu2", "sc2", "us", "e_top", "u_top_e"):
        np.testing.assert_allclose(
            dgot[key].numpy(), np.asarray(dref[key]), rtol=RTOL, atol=ATOL, err_msg=key
        )
    np.testing.assert_allclose(dgot["d1"].numpy(), np.asarray(dref["d1"]), rtol=RTOL, atol=1e-3)


def test_plain_kernels_on_cpu_are_the_plain_versions(rng):
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    B, h, w, C, N, KP = 1, 4, 16, 32, 128, 192
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    args = (t(B, h + 2, w + 2, C), t(9, C, N), t(B, h, w, KP), t(B, KP, N), t(B, N))
    n1, n2 = fh.conv_phase.launches, fh.head_tail.launches
    z, s, q = fh.conv_phase(*args)
    z2, s2, q2 = fh.conv_phase_plain(*args)
    assert torch.equal(z, z2) and torch.equal(s, s2) and torch.equal(q, q2)
    u, us, uq = fh.head_tail(z, t(B, 8), t(B, 8).abs(), torch.tensor([0.25]), t(8, 2), t(2))
    assert u.shape == (B, h, w, 16 * 2) and us.shape == (B, 1, 2)
    assert (fh.conv_phase.launches, fh.head_tail.launches) == (n1, n2)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """K1 and K2 on the card against their plain versions, on the same
    bf16 inputs (a shape with ragged tiles and a small flagship-like one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")  # also keeps the f32 plain versions out of TF32
    rng = np.random.RandomState(0)
    for B, h, w, C, cout, out_ch in ((1, 6, 20, 32, 16, 1), (2, 12, 32, 192, 128, 2)):
        N, KP = 16 * cout, 192
        g = lambda *s, sc=1.0: torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).to(dev)
        bf = torch.bfloat16
        tp, kph = g(B, h + 2, w + 2, C).to(bf), g(9, C, N, sc=0.05).to(bf)
        pat, wm, b2b = g(B, h, w, KP).to(bf), g(B, KP, N, sc=0.05).to(bf), g(B, N, sc=0.1)
        n1 = fh.conv_phase.launches
        z, s, q = fh.conv_phase(tp, kph, pat, wm, b2b)
        torch.cuda.synchronize()
        assert fh.conv_phase.launches == n1 + 1
        zr, sr, qr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)
        # z at bf16 resolution, moments at rtol 1e-3 (f32 sums, other order)
        torch.testing.assert_close(z.float(), zr.float(), rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(s.sum(1), sr.sum(1), rtol=1e-3, atol=1e-1)
        torch.testing.assert_close(q.sum(1), qr.sum(1), rtol=1e-3, atol=1e-1)
        mu, sc = g(B, cout, sc=0.1), g(B, cout).abs() + 0.5
        a, w3, b3 = torch.tensor([0.25], device=dev), g(cout, out_ch, sc=0.1), g(out_ch)
        u, us, uq = fh.head_tail(z, mu, sc, a, w3, b3)
        torch.cuda.synchronize()
        ur, usr, uqr = fh.head_tail_plain(z, mu, sc, a, w3, b3)
        torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(us.sum(1), usr.sum(1), rtol=1e-3, atol=1e-2)
        torch.testing.assert_close(uq.sum(1), uqr.sum(1), rtol=1e-3, atol=1e-2)
