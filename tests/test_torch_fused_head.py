"""posfeat_tpu_torch's fused head (plain versions of K1/K2 on the CPU)
against the Pallas ``fused_head_tail`` run with interpret=True, and the
CUDA kernels against their plain versions on the card (marked ``gpu``).

JAX is imported inside the tests that use it: the card's machine has no
JAX, and runs the ``gpu`` test with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_head.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _tile_split(conv_fn):
    """``conv_fn`` (a plain conv version, moments [B, 1, N]) with its
    moments split over the kernels' tiles, [B, T, N], as the card's
    kernels return them; ``.tiles`` records each call's T."""

    def split(tp, kph, *rest):
        z, _, _ = conv_fn(tp, kph, *rest)
        th, tw = fh.K1_TILE
        B, h, w, N = z.shape
        zt = F.pad(z.float(), (0, 0, 0, -w % tw, 0, -h % th))
        zt = zt.reshape(B, -(-h // th), th, -(-w // tw), tw, N).permute(0, 1, 3, 2, 4, 5)
        zt = zt.reshape(B, -1, th * tw, N)
        split.tiles.append(zt.shape[1])
        return z, zt.sum(dim=2), (zt * zt).sum(dim=2)

    split.tiles = []
    return split


@pytest.mark.parametrize("mode", ["v3", "v1"])
def test_head_takes_moments_split_over_tiles(rng, mode):
    """The partials contract: the head pools K1's/K3's moments over dim 1,
    so moments split over the tiles of a ragged shape (h, w not multiples
    of the tile) give the score of the single-row plain moments."""
    h, w = 11, 21
    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = map(
        torch.from_numpy, _setup(rng, B=2, h=h, w=w, cout=16, out=1)
    )
    y = F.conv2d(s.permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1), b1, padding=1).permute(0, 2, 3, 1)
    plain = fh.conv_phase_plain if mode == "v3" else fh.conv_phase_img_plain
    th, tw = fh.K1_TILE
    assert h % th and w % tw  # ragged in both directions
    args = (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)
    want = fh._fused_head_tail(plain, fh.head_tail_plain, *args, mode=mode)
    split = _tile_split(plain)
    got = fh._fused_head_tail(split, fh.head_tail_plain, *args, mode=mode)
    assert split.tiles == [-(-h // th) * -(-w // tw)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _block_split(tail_fn):
    """``tail_fn`` (the plain K2, moments [B, 1, out]) with its moments
    split over K2's blocks, [B, T2, out], each block a contiguous range of
    ``head_tail_rows_per_block`` phase rows, as the card's kernel returns
    them; ``.rows`` records each call's (R, rows per block)."""

    def split(z, mu, sc, a, w3, b3):
        u, _, _ = tail_fn(z, mu, sc, a, w3, b3)
        B, out_ch = u.shape[0], w3.shape[1]
        ur = u.reshape(B, -1, out_ch)
        R = ur.shape[1]
        rows = fh.head_tail_rows_per_block(B, R)
        split.rows.append((R, rows))
        parts = torch.split(ur, rows, dim=1)
        return (u, torch.stack([p.sum(dim=1) for p in parts], 1),
                torch.stack([(p * p).sum(dim=1) for p in parts], 1))

    split.rows = []
    return split


@pytest.mark.parametrize("mode", ["v3", "v1"])
def test_head_takes_k2_moments_split_over_blocks(rng, mode):
    """K2's partials contract: the head pools K2's moments over dim 1, so
    moments split over K2's block row ranges at a ragged R (not a
    multiple of the rows per block) give the score of the single-row
    plain moments."""
    h, w = 11, 23
    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = map(
        torch.from_numpy, _setup(rng, B=2, h=h, w=w, cout=16, out=1)
    )
    y = F.conv2d(s.permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1), b1, padding=1).permute(0, 2, 3, 1)
    conv = fh.conv_phase_plain if mode == "v3" else fh.conv_phase_img_plain
    args = (trunk, s, y, k1, b1, k2t, k2i, b2, w3, b3, a)
    want = fh._fused_head_tail(conv, fh.head_tail_plain, *args, mode=mode)
    split = _block_split(fh.head_tail_plain)
    got = fh._fused_head_tail(conv, split, *args, mode=mode)
    (R, rows), = split.rows
    assert R == h * w * 16 and R % rows and -(-R // rows) > 2  # several blocks, the last one short
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_head_tail_rows_per_block():
    """About K2_BLOCKS blocks per launch, at least K2_MIN_ROWS rows each
    (or all R), covering every row."""
    for B, R in ((16, 307200), (1, 307200), (2, 3696), (2, 4048), (3, 100), (1093, 4096)):
        rows = fh.head_tail_rows_per_block(B, R)
        T2 = -(-R // rows)
        assert rows >= min(R, fh.K2_MIN_ROWS) and T2 * rows >= R > (T2 - 1) * rows
        assert B * T2 <= fh.K2_BLOCKS + B
    assert fh.head_tail_rows_per_block(16, 307200) == 4800  # the flagship point: 64 blocks per image


@pytest.mark.parametrize("depth", [8, 16], ids=["add_per_step", "add_per_chunk"])
def test_f32_conv_split_and_3xtf32_steps_on_cpu(depth):
    """The f32 conv kernels' arithmetic on the CPU (csrc/fused_head_f32.cu):
    the split's hi has its 13 low mantissa bits clear and hi + lo is x
    within 2^-22 |x|; and at the flagship depth (C = KP = 192, one 8 x 16
    tile, N = 128), 3xTF32 products (lo.hi + hi.lo + hi.hi) summed with an
    f32 rounded add per 8-deep step, or per 16-deep chunk as the kernel
    adds them, read from the split's layouts in the kernel's order (halo
    slices x 9 taps as shifted cells, then patch slices), give z within
    1e-5 x max|z| of conv_phase_plain (chip_smoke.py's F32_Z_TOL)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32))
    hi, lo = fh.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * x.double().abs()).all()

    C, KP, N, th, tw = 192, 192, 128, *fh.K1_TILE
    g = lambda *s, sc=1.0: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * sc)
    tp, kph, pat, wm, b2b = g(1, th + 2, tw + 2, C), g(9, C, N, sc=0.03), g(1, th, tw, KP), g(1, KP, N, sc=0.03), g(1, N)
    halo, kb, pt, wb = fh.split_conv_operands(tp, kph, pat, wm)  # the plain split on CPU tensors
    halo = halo.view(C // 16, 2, 4, (th + 2) * (tw + 2), 4)  # [slice][hi, lo][4][cell][4]
    kb, pt, wb = kb.view(-1, 2, 4, N, 4), pt.view(KP // 16, 2, 4, (th + 2) * (tw + 2), 4), wb.view(-1, 2, 4, N, 4)
    cells = (torch.arange(th)[:, None] * (tw + 2) + torch.arange(tw)).flatten()  # the tile's cells at tap 0
    acc = torch.zeros(th * tw, N)

    def chunk(a, b):  # a [hi, lo][4][128 rows][4], b [hi, lo][4][N][4]: 16 deep
        nonlocal acc
        a = a.permute(0, 2, 1, 3).reshape(2, th * tw, 16).double()
        b = b.permute(0, 1, 3, 2).reshape(2, 16, N).double()
        for k in (slice(0, 8), slice(8, 16)) if depth == 8 else (slice(0, 16),):
            d = a[1][:, k] @ b[0][k] + a[0][:, k] @ b[1][k] + a[0][:, k] @ b[0][k]
            acc = acc + d.float()  # the rounded f32 add

    for j in range(C // 16):
        for tap in range(9):
            chunk(halo[j][:, :, cells + (tap // 3) * (tw + 2) + tap % 3], kb[j * 9 + tap])
    for p in range(KP // 16):
        chunk(pt[p][:, :, cells], wb[p])  # the patch rows at the tile's cells, as at tap 0
    z = (acc + b2b).reshape(1, th, tw, N)
    zr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)[0]
    err = (z - zr).abs().max().item()
    assert err <= 1e-5 * zr.abs().max().item(), (err, zr.abs().max().item())


def _close_conv(z, s, q, zr, sr, qr, dtype, bf16_rtol):
    """A conv kernel's z and summed moments against its plain version's:
    bf16 z at bf16 resolution (``bf16_rtol``) and moments at rtol 1e-3
    (f32 sums, another order); f32 z within 1e-5 of max|z| and moments at
    rtol 1e-5 of the sums of |z| and z^2 (f32 FMAs in another order: no
    rounding of z)."""
    if dtype == torch.bfloat16:
        torch.testing.assert_close(z.float(), zr.float(), rtol=bf16_rtol, atol=1e-2)
        torch.testing.assert_close(s.sum(1), sr.sum(1), rtol=1e-3, atol=1e-1)
        torch.testing.assert_close(q.sum(1), qr.sum(1), rtol=1e-3, atol=1e-1)
        return
    assert z.dtype == torch.float32
    torch.testing.assert_close(z, zr, rtol=0, atol=1e-5 * zr.abs().max().item())
    torch.testing.assert_close(s.sum(1), sr.sum(1), rtol=1e-5, atol=1e-5 * zr.abs().sum((1, 2)).max().item())
    torch.testing.assert_close(q.sum(1), qr.sum(1), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_kernels_match_plain_versions(dtype):
    """K1 and K2 on the card against their plain versions, on the same
    inputs, in each compute dtype's instance: ragged tiles (h, w not multiples of the 8 x 16 tile), B = 2
    (wm[b] and b2b[b] differ per image), the least C (32), N = 256, 384 (a
    last half step of 128 channels) and 2048, a small flagship-like shape,
    C or KP too wide for the bf16 halo and patch tile to stay resident
    (C = 224 and 736 at KP = 192, KP = 512), which that kernel stages in
    slices, and the head input of ``fine_out_ch: 256`` (C = 320). The f32
    instance streams its halo and patch slices at every C."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")  # also keeps the f32 plain versions out of TF32
    rng = np.random.RandomState(0)
    shapes = (
        (1, 6, 20, 32, 16, 1, 192), (2, 12, 32, 192, 128, 2, 192),
        (2, 13, 21, 32, 16, 1, 192), (2, 9, 35, 192, 128, 2, 192), (3, 17, 33, 96, 16, 1, 192),
        (2, 9, 35, 64, 24, 1, 192), (2, 9, 21, 224, 16, 1, 192), (1, 10, 20, 736, 16, 1, 192),
        (2, 6, 20, 32, 16, 1, 512), (1, 9, 21, 320, 16, 1, 192),
    )
    for B, h, w, C, cout, out_ch, KP in shapes:
        N = 16 * cout
        g = lambda *s, sc=1.0: torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).to(dev)
        tp, kph = g(B, h + 2, w + 2, C).to(dtype), g(9, C, N, sc=0.05).to(dtype)
        pat, wm, b2b = g(B, h, w, KP).to(dtype), g(B, KP, N, sc=0.05).to(dtype), g(B, N, sc=0.1)
        count = "launches_f32" if dtype == torch.float32 else "launches"
        n1, n_other = getattr(fh.conv_phase, count), fh.conv_phase.launches + fh.conv_phase.launches_f32
        z, s, q = fh.conv_phase(tp, kph, pat, wm, b2b)
        torch.cuda.synchronize()
        assert getattr(fh.conv_phase, count) == n1 + 1
        assert fh.conv_phase.launches + fh.conv_phase.launches_f32 == n_other + 1
        zr, sr, qr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)
        _close_conv(z, s, q, zr, sr, qr, dtype, bf16_rtol=1e-2)
        if (cout // 8) & (cout // 8 - 1):
            continue  # K2 takes Cout / 8 a power of two
        mu, sc = g(B, cout, sc=0.1), g(B, cout).abs() + 0.5
        a, w3, b3 = torch.tensor([0.25], device=dev), g(cout, out_ch, sc=0.1), g(out_ch)
        u, us, uq = fh.head_tail(z, mu, sc, a, w3, b3)
        torch.cuda.synchronize()
        ur, usr, uqr = fh.head_tail_plain(z, mu, sc, a, w3, b3)
        torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(us.sum(1), usr.sum(1), rtol=1e-3, atol=1e-2)
        torch.testing.assert_close(uq.sum(1), uqr.sum(1), rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cout", [8, 16, 32, 64, 128, 256])
def test_cuda_head_tail_every_instance(cout, dtype):
    """K2 against its plain version for every compiled instance: z in bf16
    and f32, lanes per row Cout / 8 = 1 ... 32, out_ch 1-4, at B = 2 and an R (5 x 10 x 16
    = 800 phase rows, 3 blocks of 267) that is a multiple of neither the
    rows per block nor a warp's trip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = resolve_device("cuda")
    rng = np.random.RandomState(cout)
    B, h, w = 2, 5, 10
    R = h * w * 16
    rows = fh.head_tail_rows_per_block(B, R)
    assert R % rows and rows % 32
    g = lambda *s, sc=1.0: torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).to(dev)
    z = g(B, h, w, 16 * cout).to(dtype)
    mu, sc = g(B, cout, sc=0.1), g(B, cout).abs() + 0.5
    a = torch.tensor([0.25], device=dev)
    count = "launches_f32" if dtype == torch.float32 else "launches"
    for out_ch in (1, 2, 3, 4):
        w3, b3 = g(cout, out_ch, sc=0.1), g(out_ch)
        n0 = getattr(fh.head_tail, count)
        u, us, uq = fh.head_tail(z, mu, sc, a, w3, b3)
        torch.cuda.synchronize()
        assert getattr(fh.head_tail, count) == n0 + 1 and us.shape == (B, -(-R // rows), out_ch)
        ur, usr, uqr = fh.head_tail_plain(z, mu, sc, a, w3, b3)
        torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(us.sum(1), usr.sum(1), rtol=1e-3, atol=1e-2)
        torch.testing.assert_close(uq.sum(1), uqr.sum(1), rtol=1e-3, atol=1e-2)
