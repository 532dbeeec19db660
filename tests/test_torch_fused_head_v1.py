"""The fused head's v1 dataflow and its conv kernels K3, T1, T2
(posfeat_tpu_torch.ops.fused_head.conv_phase_img).

On the CPU: the port's v1 ``fused_head_tail`` (plain K3/K2) against the
Pallas ``fused_head_tail`` run with interpret=True under
POSFEAT_HEAD_MODE=v1, at the tolerance of the JAX fused-head tests
(test_pallas_fused_head.py:97, 131), and the plain versions of K3, T1
and T2 against a direct computation of their definitions. On the card
(marked ``gpu``): each kernel against its plain version, run with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_head_v1.py``.
"""

import numpy as np
import pytest
import torch

from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import fused_head as fh
from test_torch_fused_head import ATOL, RTOL, _close_conv, _img_branch_np, _setup


def _both_v1(monkeypatch, args, act="Softplus", debug=False):
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.fused_head import fused_head_tail as jax_fused_head_tail

    monkeypatch.setenv("POSFEAT_HEAD_MODE", "v1")
    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = args
    y, mu, ia = _img_branch_np(s, k1, b1)
    ops = (trunk, s, y, mu, ia, k1, b1, k2t, k2i, b2, w3, b3, a)
    ref = jax_fused_head_tail(
        *map(jnp.asarray, ops), act=act, interpret=True, debug_intermediates=debug
    )
    # the port computes img_y's IN statistics itself
    t = lambda o: torch.from_numpy(np.array(o))
    got = fh.fused_head_tail(
        *map(t, (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)), act=act,
        debug_intermediates=debug, mode="v1",
    )
    return ref, got


@pytest.mark.parametrize(
    "shape, act",
    [
        (dict(out=1), "Softplus"),
        (dict(out=2), "Softplus"),
        # odd tiles: h=6 -> the JAX th=2 fallback, w=20 -> tw=4
        (dict(B=1, h=6, w=20, cin=8, cy=8, cout=16, out=1), "Softplus"),
        (dict(out=2), "Sigmoid"),
    ],
    ids=["out1", "out2", "odd_tiles", "sigmoid"],
)
def test_v1_head_matches_pallas_interpret(rng, monkeypatch, shape, act):
    ref, got = _both_v1(monkeypatch, _setup(rng, **shape), act)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_v1_intermediates_match(rng, monkeypatch):
    """K3's z and the pooled IN1 moments, the 1-px ring's exact values,
    and K2's u (ring rewritten), against JAX's debug_intermediates."""
    (_, dref), (_, dgot) = _both_v1(monkeypatch, _setup(rng, out=2), debug=True)
    B, cout = dgot["mu"].shape
    np.testing.assert_allclose(dgot["z"].numpy(), np.asarray(dref["z"]), rtol=RTOL, atol=ATOL)
    s1_ref = np.asarray(dref["ssum"]).reshape(B, -1, 16, cout).sum(axis=(1, 2))
    np.testing.assert_allclose(dgot["s1"].numpy(), s1_ref, rtol=RTOL, atol=1e-2)
    for key in ("mu", "sc", "u", "mu2", "sc2", "us", "e_top", "u_top_e"):
        np.testing.assert_allclose(
            dgot[key].numpy(), np.asarray(dref[key]), rtol=RTOL, atol=ATOL, err_msg=key
        )
    np.testing.assert_allclose(dgot["d1"].numpy(), np.asarray(dref["d1"]), rtol=RTOL, atol=1e-3)


def _direct(tp, kph, zimg, b2, layout):
    """The definition of K3/T1/T2 in float64, loop by loop:
    z[b,y,x,(ry·4+rx)·Cout+c] = Σ_{tap,ci} tp[b,y+dy,x+dx,ci]·kph[tap,ci,n]
    + Z + b2[n]."""
    tp, kph, b2 = (np.asarray(t, np.float64) for t in (tp, kph, b2))
    B, hp, wp, C = tp.shape
    h, w, N = hp - 2, wp - 2, kph.shape[-1]
    cout = N // 16
    z = np.zeros((B, h, w, N))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        z += tp[:, dy : dy + h, dx : dx + w] @ kph[tap]
    if layout == "full":
        zi = np.asarray(zimg, np.float64)
        for n in range(N):
            ph, c = divmod(n, cout)
            ry, rx = divmod(ph, 4)
            z[..., n] += zi[:, ry::4, rx::4, c]
    elif layout == "phase":
        z += np.asarray(zimg, np.float64)
    z += b2
    return z, z.sum(axis=(1, 2))[:, None], (z * z).sum(axis=(1, 2))[:, None]


@pytest.mark.parametrize("layout", ["full", "none", "phase"], ids=["K3", "T1", "T2"])
def test_plain_versions_match_their_definition(rng, layout):
    B, h, w, C, cout = 2, 5, 7, 8, 4
    N = 16 * cout
    f = lambda *s: rng.randn(*s).astype(np.float32)
    tp, kph, b2 = f(B, h + 2, w + 2, C), f(9, C, N), f(N)
    zimg = {"full": f(B, 4 * h, 4 * w, cout), "none": None, "phase": f(B, h, w, N)}[layout]
    t = lambda a: None if a is None else torch.from_numpy(a)
    z, s, q = fh.conv_phase_img_plain(t(tp), t(kph), t(zimg), t(b2), layout)
    zr, sr, qr = _direct(tp, kph, zimg, b2, layout)
    assert z.dtype == torch.float32 and z.shape == (B, h, w, N) and s.shape == (B, 1, N)
    np.testing.assert_allclose(z.numpy(), zr, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), sr, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(q.numpy(), qr, rtol=1e-5, atol=1e-3)


def test_conv_phase_img_on_cpu_is_the_plain_version(rng):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; an unknown layout raises."""
    B, h, w, C, N = 1, 4, 16, 32, 128
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    tp, kph, zimg, b2 = t(B, h + 2, w + 2, C), t(9, C, N), t(B, 4 * h, 4 * w, N // 16), t(N)
    before = dict(fh.conv_phase_img.launches)
    got = fh.conv_phase_img(tp, kph, zimg, b2, "full")
    want = fh.conv_phase_img_plain(tp, kph, zimg, b2, "full")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fh.conv_phase_img.launches == before
    with pytest.raises(ValueError, match="layout"):
        fh.conv_phase_img(tp, kph, zimg, b2, "transposed")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_conv_phase_img_matches_plain_versions(dtype):
    """K3, T1 and T2 on the card against their plain versions, on the same
    inputs, in each compute dtype's instance: ragged tiles (h, w not multiples of the 8 x 16 tile), B >= 2,
    the least C (32), N = 256, 384 (a last half step of 128 channels) and
    2048, a small flagship-like shape, C = 256 and 800, too wide for the
    halo to stay resident, which the bf16 kernel stages in slices, and the
    head input of ``fine_out_ch: 256`` (C = 320): z and moments as
    ``_close_conv`` holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")  # also keeps the f32 plain versions out of TF32
    rng = np.random.RandomState(0)
    shapes = (
        (1, 6, 20, 32, 16), (2, 12, 32, 192, 128),
        (2, 13, 21, 32, 16), (2, 9, 35, 192, 128), (3, 17, 33, 96, 24),
        (2, 9, 21, 256, 16), (1, 10, 20, 800, 16), (1, 9, 21, 320, 16),
    )
    for B, h, w, C, cout in shapes:
        N = 16 * cout
        g = lambda *s, sc=1.0: torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).to(dev)
        tp, kph, b2 = g(B, h + 2, w + 2, C).to(dtype), g(9, C, N, sc=0.05).to(dtype), g(N, sc=0.1)
        zimgs = {"full": g(B, 4 * h, 4 * w, cout).to(dtype), "none": None, "phase": g(B, h, w, N).to(dtype)}
        counts = fh.conv_phase_img.launches_f32 if dtype == torch.float32 else fh.conv_phase_img.launches
        for layout, zimg in zimgs.items():
            n0 = counts[layout]
            z, s, q = fh.conv_phase_img(tp, kph, zimg, b2, layout)
            torch.cuda.synchronize()
            assert counts[layout] == n0 + 1
            zr, sr, qr = fh.conv_phase_img_plain(tp, kph, zimg, b2, layout)
            _close_conv(z, s, q, zr, sr, qr, dtype, bf16_rtol=2 ** -7)
