"""Fused KeypointDet tail: ×4 upsample + conv2 -> IN -> PReLU -> conv3 ->
IN -> act, without a full-resolution 128-channel tensor
(posfeat_tpu/ops/pallas/fused_head.py, modes v3 and v1, with the exact
border ring or in the ring-skip dataflow).

The conv runs in PHASE layout: z [B, h, w, 16·Cout], channel
(ry·4 + rx)·Cout + c holds full-res pixel (4y + ry, 4x + rx). Two
dataflows differ in how conv2's image half enters z:

- v3 (the default): the image branch (convimg 3->64, its IN, conv2's
  image half 64->Cout) folds into one per-image composite 5×5 kernel,
  applied as a matmul on stride-4 8×8×3 patches inside K1.
- v1: conv2's image half runs at full resolution through cuDNN
  (``F.conv2d``), and K3 adds that ``z_img`` to the trunk conv,
  reordering it into phase layout as it reads it.

Kernels (``csrc/fused_head.cu``; the f32 conv instances in
``csrc/fused_head_f32.cu``), each in the head's compute dtype, bf16 or
f32, as the JAX head runs its kernels at the trunk's dtype:

- K1 ``conv_phase``: z = phase conv of the edge-padded trunk + patches @
  Wm[b] + b2b[b], stored in the compute dtype, plus per-tile f32 column
  Σz and Σz² of the accumulator before rounding.
- K3, T1, T2 ``conv_phase_img``: the same trunk conv + an image term +
  b2: a full-res z_img (K3, ``layout="full"``), nothing (T1, "none") or
  a z_img already in phase layout (T2, "phase"). T1 and T2 are the
  per-stage head bench's variants (tools/bench_fused_parts.py).
- K2 ``head_tail``: u = PReLU((z − μ)·s) @ w3 + b3 in f32, plus per-tile
  Σu and Σu².

The f32 conv instances run 3×TF32 on the tensor cores: a split
(``split_conv_operands``) first writes every operand as TF32 hi and lo
parts, x = hi + lo, into scratch laid out as the conv kernel reads it.

On a CUDA tensor each wrapper launches its hand-written kernel or
raises; on a CPU tensor it runs the plain PyTorch version beside it.
``launches`` counts the bf16 instance's launches, ``launches_f32`` the
f32 one's.
Everything else here is plain PyTorch: the composite fold, the convimg
IN statistics (patch gram form, or img_y's own), v1's full-res conv, the
border-ring corrections, IN statistics and the final activation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .phase import _edge_pad1, _phase_kernel, ring_correction_strips, space_to_phase
from .reinforce import _tf32_rna

# conv tile (trunk rows × columns per CUDA block) of K1/K3/T1/T2;
# csrc/fused_head.cu rejects a launch whose tile differs from its
# compile-time constants
K1_TILE = (8, 16)
# output channels per step of a block's sweep over N; the kernel masks a
# last half step, so N % (K1_BN // 2) == 0 is enough
K1_BN = 256
# K2 blocks per launch to aim for: a few per SM of a 132-SM card, each
# over a contiguous range of one image's phase rows
K2_BLOCKS = 1024
K2_MIN_ROWS = 256  # at least one trip of every warp of a block
K2_MAX_OUT = 4


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the compute dtypes the kernels take


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The compute dtype a kernel instance is picked by: t's, bf16 or f32."""
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernels take {KERNEL_DTYPES}")
    return t.dtype


def k_major(t: torch.Tensor) -> torch.Tensor:
    """A B operand [..., K, N] (kph, wm) as the conv kernels read it:
    [..., N, K], contiguous, the layout wgmma takes untransposed."""
    return t.transpose(-2, -1).contiguous()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from ._build import load_kernels

        msg = load_kernels().posfeat_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({rc}): {msg}")


# ------------------------------------------------- the f32 instances' split


def tf32_split(x):
    """x [f32] = hi + lo, both TF32 values kept as f32, as the split kernels
    form them: hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to
    nearest, ties away from zero, by bit arithmetic on the f32 word: the
    reduction's ``_tf32_rna``), lo = x − hi rounded the same way."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


SPLIT_SLICE = 16  # channels of a halo or patch slice = depths of a kph or wm chunk
SPLIT_BN = 128  # output channels of a kph or wm chunk (N % SPLIT_BN == 0)


def _split_tiles_plain(x, rh, rw, h, w):
    """x [B, HH, WW, CC] -> for each K1 tile of an h × w output the rh × rw
    cells at its origin, zeros beyond x, split: flat [B][T][CC / 16][hi,
    lo][4][rh·rw][4] (4-channel groups of each cell's 16-channel slice)."""
    B, HH, WW, CC = x.shape
    th, tw = K1_TILE
    nty, ntx = -(-h // th), -(-w // tw)
    xp = x.new_zeros((B, (nty - 1) * th + rh, (ntx - 1) * tw + rw, CC))
    hh, ww = min(HH, xp.shape[1]), min(WW, xp.shape[2])
    xp[:, :hh, :ww] = x[:, :hh, :ww]
    reg = xp.unfold(1, rh, th).unfold(2, rw, tw)  # [B, nty, ntx, CC, rh, rw]
    reg = reg.reshape(B, nty * ntx, CC // SPLIT_SLICE, 4, 4, rh * rw).permute(0, 1, 2, 3, 5, 4)
    return torch.stack(tf32_split(reg), 3).flatten()


def _split_b_plain(x, taps_inner):
    """x [G, K, N] -> chunks of 16 depths × 128 columns, split: flat
    [chunk][hi, lo][4][128][4], chunks in the order (N step, depth chunk,
    g) when ``taps_inner`` (kph, G = 9 taps), else (g, N step, depth
    chunk) (wm, G = B)."""
    G, K, N = x.shape
    y = x.reshape(G, K // SPLIT_SLICE, 4, 4, N // SPLIT_BN, SPLIT_BN)  # [g, kc, q, e, ns, n]
    t = torch.stack(tf32_split(y), 0)  # [hl, g, kc, q, e, ns, n]
    order = (5, 2, 1, 0, 3, 6, 4) if taps_inner else (1, 5, 2, 0, 3, 6, 4)
    return t.permute(*order).flatten()


def split_conv_operands_plain(tp, kph, pat=None, wm=None):
    """Plain version of the f32 conv kernels' split (csrc/fused_head_f32.cu
    ``split_tiles_kernel``, ``split_b_kernel``): (halo, kph chunks) for K3,
    T1 and T2, plus (patch rows, wm chunks) for K1, each flat in the
    layout the conv kernel reads. tp [B, h+2, w+2, C]: each tile's 10 × 18
    halo; kph [9, C, N]; pat [B, h, w, KP]: the 10 × 18 cells at each
    tile's origin too (the kernel reads its 8 × 16 patch rows there, in the
    halo's geometry); wm [B, KP, N]."""
    h, w = tp.shape[1] - 2, tp.shape[2] - 2
    th, tw = K1_TILE
    out = (_split_tiles_plain(tp, th + 2, tw + 2, h, w), _split_b_plain(kph, True))
    if pat is None:
        return out
    return out + (_split_tiles_plain(pat, th + 2, tw + 2, h, w), _split_b_plain(wm, False))


def split_conv_operands(tp, kph, pat=None, wm=None):
    """The f32 conv kernels' split (csrc/fused_head_f32.cu, one launch per
    operand, counted as one split in ``launches``): same contract as
    ``split_conv_operands_plain``, which runs on CPU tensors; f32 operands
    only, C and KP multiples of 32, N of 128."""
    if tp.device.type == "cpu":
        return split_conv_operands_plain(tp, kph, pat, wm)
    from ._build import load_kernels

    B, hp, wp, C = tp.shape
    h, w = hp - 2, wp - 2
    N = kph.shape[-1]
    KP = 0 if pat is None else pat.shape[-1]
    th, tw = K1_TILE
    T = -(-h // th) * -(-w // tw)
    f32, dev = torch.float32, tp.device
    _check(tp, "tp", f32, (B, hp, wp, C), dev)
    _check(kph, "kph", f32, (9, C, N), dev)
    sizes = [B * T * C * 2 * (th + 2) * (tw + 2), 9 * C * N * 2]
    if pat is not None:
        _check(pat, "pat", f32, (B, h, w, KP), dev)
        _check(wm, "wm", f32, (B, KP, N), dev)
        sizes += [B * T * KP * 2 * (th + 2) * (tw + 2), B * KP * N * 2]
    if C % 32 or KP % 32 or N % SPLIT_BN:
        raise ValueError(f"the f32 split needs C, KP % 32 == 0 and N % {SPLIT_BN} == 0; got {C}, {KP}, {N}")
    out = tuple(torch.empty(n, dtype=f32, device=dev) for n in sizes)
    none = ctypes.c_void_p(None)
    ptrs = [none if t is None else _ptr(t) for t in (tp, kph, pat, wm, *out, *(None,) * (4 - len(out)))]
    rc = load_kernels().posfeat_conv_split_f32(*ptrs, B, h, w, C, KP, N, _stream())
    split_conv_operands.launches += 1
    _raise_on(rc, "f32 conv split")
    return out


split_conv_operands.launches = 0


# ------------------------------------------------------------------- K1


def _trunk_conv_plain(tp, kph):
    """f32 phase conv of the edge-padded trunk: [B, h+2, w+2, C] ×
    [9, C, N] -> [B, h, w, N]."""
    C, N = kph.shape[1:]
    k4 = kph.float().reshape(3, 3, C, N).permute(3, 2, 0, 1)
    return F.conv2d(tp.float().permute(0, 3, 1, 2), k4).permute(0, 2, 3, 1)


def _with_moments(z, dtype):
    return z.to(dtype), z.sum(dim=(1, 2))[:, None], (z * z).sum(dim=(1, 2))[:, None]


def conv_phase_plain(tp, kph, pat, wm, b2b):
    """Plain version of K1, in f32. tp [B, h+2, w+2, C] edge-padded trunk;
    kph [9, C, N] phase kernel (tap = dy·3 + dx); pat [B, h, w, KP]
    patches; wm [B, KP, N]; b2b [B, N] f32 -> (z [B, h, w, N] in tp's
    dtype, Σz [B, 1, N], Σz² [B, 1, N]) with moments of the f32 values."""
    B, h, w = pat.shape[:3]
    z = _trunk_conv_plain(tp, kph)
    z = z + (pat.float().reshape(B, h * w, -1) @ wm.float()).reshape(z.shape)
    z = z + b2b.float()[:, None, None, :]
    return _with_moments(z, tp.dtype)


def conv_phase(tp, kph, pat, wm, b2b):
    """K1 (replaces posfeat_tpu/ops/pallas/fused_head.py:148
    ``_conv_kernel_v3``). Same contract as ``conv_phase_plain``, except
    that the moments come per K1 tile: [B, T, N]. tp's dtype, bf16 or
    f32, picks the kernel instance; every operand but b2b has it."""
    if tp.device.type == "cpu":
        return conv_phase_plain(tp, kph, pat, wm, b2b)
    from ._build import load_kernels

    B, hp, wp, C = tp.shape
    h, w = hp - 2, wp - 2
    N, KP = kph.shape[-1], pat.shape[-1]
    dev, dt = tp.device, _kernel_dtype(tp, "tp")
    _check(tp, "tp", dt, (B, hp, wp, C), dev)
    _check(kph, "kph", dt, (9, C, N), dev)
    _check(pat, "pat", dt, (B, h, w, KP), dev)
    _check(wm, "wm", dt, (B, KP, N), dev)
    _check(b2b, "b2b", torch.float32, (B, N), dev)
    if C < 32 or C % 32 or KP % 32 or N % (K1_BN // 2):
        raise ValueError(f"K1 needs C, KP % 32 == 0, C > 0 and N % {K1_BN // 2} == 0; got {C}, {KP}, {N}")
    th, tw = K1_TILE
    T = -(-h // th) * -(-w // tw)
    z = torch.empty((B, h, w, N), dtype=dt, device=dev)
    psum = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    lib = load_kernels()
    if dt == torch.float32:
        # 3xTF32 on the split's hi and lo tiles
        halo_s, kph_s, pat_s, wm_s = split_conv_operands(tp, kph, pat, wm)
        rc = lib.posfeat_conv_phase_f32(
            _ptr(halo_s), _ptr(kph_s), _ptr(pat_s), _ptr(wm_s), _ptr(b2b),
            _ptr(z), _ptr(psum), _ptr(psq), B, h, w, C, KP, N, th, tw, _stream(),
        )
        conv_phase.launches_f32 += 1
    else:
        # one K-major copy of kph and of wm per call, 20 MB at the flagship point
        kph_t, wm_t = k_major(kph), k_major(wm)
        rc = lib.posfeat_conv_phase(
            _ptr(tp), _ptr(kph_t), _ptr(pat), _ptr(wm_t), _ptr(b2b),
            _ptr(z), _ptr(psum), _ptr(psq), B, h, w, C, KP, N, th, tw, _stream(),
        )
        conv_phase.launches += 1
    _raise_on(rc, f"K1 conv_phase ({dt})")
    return z, psum, psq


conv_phase.launches = 0
conv_phase.launches_f32 = 0


# --------------------------------------------------------- K3, T1, T2

IMG_LAYOUTS = ("full", "none", "phase")  # K3, T1, T2; the kernel's layout code is the index
IMG_KERNELS = {"full": "K3", "none": "T1", "phase": "T2"}


def conv_phase_img_plain(tp, kph, zimg, b2, layout):
    """Plain version of K3 (``layout="full"``), T1 ("none") and T2
    ("phase"), in f32. tp [B, h+2, w+2, C] edge-padded trunk; kph
    [9, C, N] phase kernel, N = 16·Cout; zimg [B, 4h, 4w, Cout] at full
    resolution ("full"), unused ("none", may be None) or [B, h, w, N] in
    phase layout ("phase"); b2 [N] f32 -> (z [B, h, w, N] in tp's dtype,
    Σz [B, 1, N], Σz² [B, 1, N]) with moments of the f32 values."""
    if layout not in IMG_LAYOUTS:
        raise ValueError(f"layout must be one of {IMG_LAYOUTS}, got {layout!r}")
    z = _trunk_conv_plain(tp, kph)
    if layout == "full":
        z = z + space_to_phase(zimg.float(), 4).reshape(z.shape)
    elif layout == "phase":
        z = z + zimg.float()
    z = z + b2.float()
    return _with_moments(z, tp.dtype)


def conv_phase_img(tp, kph, zimg, b2, layout):
    """K3 (replaces posfeat_tpu/ops/pallas/fused_head.py:70
    ``_conv_kernel``, ``layout="full"``), T1 (tools/bench_fused_parts.py:105
    ``_conv_kernel_noz``, "none") and T2 (bench_fused_parts.py:154
    ``_conv_kernel_prephase``, "phase"). Same contract as
    ``conv_phase_img_plain``, except that the moments come per tile:
    [B, T, N]. tp's dtype, bf16 or f32, picks the kernel instance; kph
    and zimg have it. ``launches`` (bf16) and ``launches_f32`` count each
    layout's kernel apart."""
    if layout not in IMG_LAYOUTS:
        raise ValueError(f"layout must be one of {IMG_LAYOUTS}, got {layout!r}")
    if tp.device.type == "cpu":
        return conv_phase_img_plain(tp, kph, zimg, b2, layout)
    from ._build import load_kernels

    B, hp, wp, C = tp.shape
    h, w = hp - 2, wp - 2
    N = kph.shape[-1]
    cout = N // 16
    dev, dt = tp.device, _kernel_dtype(tp, "tp")
    _check(tp, "tp", dt, (B, hp, wp, C), dev)
    _check(kph, "kph", dt, (9, C, N), dev)
    _check(b2, "b2", torch.float32, (N,), dev)
    if layout == "full":
        _check(zimg, "zimg", dt, (B, 4 * h, 4 * w, cout), dev)
    elif layout == "phase":
        _check(zimg, "zimg", dt, (B, h, w, N), dev)
    if C < 32 or C % 32 or N % (K1_BN // 2) or N != 16 * cout or cout % 8:
        raise ValueError(
            f"{IMG_KERNELS[layout]} needs C % 32 == 0, C > 0, N = 16·Cout, N % {K1_BN // 2} == 0 and "
            f"Cout % 8 == 0; got C={C}, N={N}"
        )
    th, tw = K1_TILE
    T = -(-h // th) * -(-w // tw)
    z = torch.empty((B, h, w, N), dtype=dt, device=dev)
    psum = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    img = ctypes.c_void_p(None) if layout == "none" else _ptr(zimg)
    f32 = dt == torch.float32
    lib = load_kernels()
    if f32:
        # 3xTF32 on the split's hi and lo tiles
        a, b = split_conv_operands(tp, kph)
        launch = lib.posfeat_conv_phase_img_f32
    else:
        a, b, launch = tp, k_major(kph), lib.posfeat_conv_phase_img
    rc = launch(
        _ptr(a), _ptr(b), img, _ptr(b2), _ptr(z), _ptr(psum), _ptr(psq),
        B, h, w, C, N, cout, IMG_LAYOUTS.index(layout), th, tw, _stream(),
    )
    (conv_phase_img.launches_f32 if f32 else conv_phase_img.launches)[layout] += 1
    _raise_on(rc, f"{IMG_KERNELS[layout]} conv_phase_img ({dt})")
    return z, psum, psq


conv_phase_img.launches = dict.fromkeys(IMG_LAYOUTS, 0)
conv_phase_img.launches_f32 = dict.fromkeys(IMG_LAYOUTS, 0)


# ------------------------------------------------------------------- K2


def head_tail_plain(z, mu, sc, a, w3, b3):
    """Plain version of K2, in f32. z [B, h, w, kk·Cout]; mu, sc
    [B, Cout] f32 (IN1 mean and rsqrt(var + eps)); a [1] PReLU slope;
    w3 [Cout, out] f32; b3 [out] f32 -> (u [B, h, w, kk·out] f32,
    Σu [B, 1, out], Σu² [B, 1, out])."""
    B, h, w, n = z.shape
    cout, out_ch = w3.shape
    x = z.float().reshape(B, h, w, n // cout, cout)
    x = (x - mu[:, None, None, None, :]) * sc[:, None, None, None, :]
    x = torch.where(x >= 0, x, a.float() * x)
    u = x @ w3.float() + b3.float()  # [B, h, w, kk, out]
    usum = u.sum(dim=(1, 2, 3))[:, None]
    usq = (u * u).sum(dim=(1, 2, 3))[:, None]
    return u.reshape(B, h, w, -1), usum, usq


def head_tail_rows_per_block(B: int, R: int) -> int:
    """Phase rows per K2 block for B images of R rows: about K2_BLOCKS
    blocks in all, each at least K2_MIN_ROWS rows (or all R). The
    moments come as one partials row per block: [B, ceil(R / rows), out]."""
    per_image = max(1, min(-(-K2_BLOCKS // B), R // K2_MIN_ROWS))
    return -(-R // per_image)


def head_tail(z, mu, sc, a, w3, b3):
    """K2 (replaces posfeat_tpu/ops/pallas/fused_head.py:284
    ``_tail_kernel``). Same contract as ``head_tail_plain``, except that
    the moments come per K2 block: [B, T2, out]. z's dtype, bf16 or f32,
    picks the kernel instance."""
    if z.device.type == "cpu":
        return head_tail_plain(z, mu, sc, a, w3, b3)
    from ._build import load_kernels

    B, h, w, n = z.shape
    cout, out_ch = w3.shape
    dev, f32 = z.device, torch.float32
    _check(z, "z", _kernel_dtype(z, "z"), (B, h, w, n), dev)
    _check(mu, "mu", f32, (B, cout), dev)
    _check(sc, "sc", f32, (B, cout), dev)
    _check(a, "a", f32, (1,), dev)
    _check(w3, "w3", f32, (cout, out_ch), dev)
    _check(b3, "b3", f32, (out_ch,), dev)
    lanes = cout // 8
    if cout % 8 or lanes & (lanes - 1) or lanes > 32 or n % cout or out_ch > K2_MAX_OUT:
        raise ValueError(
            f"K2 needs Cout in 8·2^i up to 256 and out_ch <= {K2_MAX_OUT}; got {cout}, {out_ch}"
        )
    R = h * w * (n // cout)  # phase rows per image
    rows = head_tail_rows_per_block(B, R)
    T2 = -(-R // rows)
    u = torch.empty((B, h, w, (n // cout) * out_ch), dtype=f32, device=dev)
    usum = torch.empty((B, T2, out_ch), dtype=f32, device=dev)
    usq = torch.empty_like(usum)
    z_f32 = z.dtype == f32
    rc = load_kernels().posfeat_head_tail(
        _ptr(z), _ptr(mu), _ptr(sc), _ptr(a), _ptr(w3), _ptr(b3),
        _ptr(u), _ptr(usum), _ptr(usq), B, R, cout, out_ch, rows, int(z_f32), _stream(),
    )
    if z_f32:
        head_tail.launches_f32 += 1
    else:
        head_tail.launches += 1
    _raise_on(rc, f"K2 head_tail ({z.dtype})")
    return u, usum, usq


head_tail.launches = 0
head_tail.launches_f32 = 0


# ------------------------------------------------------- the head tail


def _patches(x: torch.Tensor, size: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """NHWC patches, feature order (c, ky, kx) as
    conv_general_dilated_patches gives: [B, H, W, C] -> [B, h', w', C·size²]."""
    B = x.shape[0]
    ho = (x.shape[1] + 2 * pad - size) // stride + 1
    wo = (x.shape[2] + 2 * pad - size) // stride + 1
    p = F.unfold(x.permute(0, 3, 1, 2), size, padding=pad, stride=stride)
    return p.transpose(1, 2).reshape(B, ho, wo, -1)


def _img_ring_deltas(s, y, mu, a, K5, k2i, b_z):
    """f32 deltas (composite − exact) of the image branch on the 2-px
    border ring, where composite-of-zero-pads != zero-pad-of-composite
    (fused_head.py:342-410). s [B, Hf, Wf, 3] prior-scaled image; y
    [B, Hf, Wf, Cy] unnormalized convimg output; mu/a [B, Cy]; K5
    [B, 5, 5, 3, Cout] f32; b_z [B, Cout]. Returns (G_top, G_bot)
    [B, 2, Wf, Cout] and (G_left, G_right) [B, Hf, 2, Cout]."""
    B = y.shape[0]
    cout = k2i.shape[-1]
    k2i32 = k2i.float()
    # rows of K5cm ordered (c, gy, gx) to match the patch feature order
    K5cm = K5.permute(0, 3, 1, 2, 4).reshape(B, 75, cout)
    K5Tcm = K5.permute(0, 3, 2, 1, 4).reshape(B, 75, cout)  # gy <-> gx

    def row_deltas(strip6, y3, pad_rows, K5m, k2m):
        # strip6 [B, 6, L+4, 3]; y3 [B, 3, L, Cy] (rows without border)
        pt = _patches(strip6, 5)  # [B, 2, L, 75]
        comp = torch.einsum("brxk,bkh->brxh", pt, K5m) + b_z[:, None, None, :]
        yin = (y3 - mu[:, None, None, :]) * a[:, None, None, :]
        yin = F.pad(yin, (0, 0, 1, 1) + pad_rows)
        ex = F.conv2d(yin.permute(0, 3, 1, 2), k2m.permute(3, 2, 0, 1))
        return comp - ex.permute(0, 2, 3, 1)  # [B, 2, L, Cout]

    s32 = lambda sl: s[sl].float()
    y32 = lambda sl: y[sl].float()
    a_ = slice(None)
    st_top = F.pad(s32((a_, slice(0, 4))), (0, 0, 2, 2, 2, 0))
    st_bot = F.pad(s32((a_, slice(-4, None))), (0, 0, 2, 2, 0, 2))
    st_left = F.pad(s32((a_, a_, slice(0, 4))), (0, 0, 2, 0, 2, 2))
    st_right = F.pad(s32((a_, a_, slice(-4, None))), (0, 0, 0, 2, 2, 2))

    G_top = row_deltas(st_top, y32((a_, slice(0, 3))), (1, 0), K5cm, k2i32)
    G_bot = row_deltas(st_bot, y32((a_, slice(-3, None))), (0, 1), K5cm, k2i32)
    k2T = k2i32.permute(1, 0, 2, 3)
    G_left = row_deltas(
        st_left.transpose(1, 2), y32((a_, a_, slice(0, 3))).transpose(1, 2),
        (1, 0), K5Tcm, k2T,
    ).transpose(1, 2)  # [B, Hf, 2, Cout]
    G_right = row_deltas(
        st_right.transpose(1, 2), y32((a_, a_, slice(-3, None))).transpose(1, 2),
        (0, 1), K5Tcm, k2T,
    ).transpose(1, 2)
    return G_top, G_bot, G_left, G_right


IMG_STATS = ("gram", "xla")  # fused_head_tail's convimg IN statistics


def _in_stats(y: torch.Tensor, eps: float):
    """f32 instance-norm statistics of y [B, H, W, C]: (mean, rsqrt(var +
    eps)), var = E[y²] − mean² clamped at 0, sums over y widened to f32."""
    y = y.float()
    n = y.shape[1] * y.shape[2]
    mu = y.sum(dim=(1, 2)) / n
    var = torch.clamp((y * y).sum(dim=(1, 2)) / n - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def fused_head_tail(
    trunk, img_s, img_y, k1_img, b1_img, k2_trunk, k2_img, b2, w3, b3, prelu_a,
    act: str = "Softplus", k: int = 4, eps: float = 1e-5,
    debug_intermediates: bool = False, mode: str = "v3", ring: bool = True, im2col: bool = False,
    img_stats: str = "gram",
):
    """Reference-exact head tail -> full-res score [B, k·h, k·w, out]
    (posfeat_tpu/ops/pallas/fused_head.py:413-1155).

    Equivalent to (DeteNet.py:108-113, identity prior):
        z = conv3x3_zeropad(upsample_x4(trunk))
            + conv3x3_zeropad(IN(conv3x3_zeropad(img_s) + b1)) + b2
        x = prelu(instance_norm(z)); u = conv1x1(x) + b3
        score = act(instance_norm(u))

    Layouts are the JAX ones: NHWC maps, conv kernels [kh, kw, in, out].
    trunk [B, h, w, Cin] (post conv1 + IN + PReLU); img_s [B, 4h, 4w, 3];
    img_y [B, 4h, 4w, Cy] unnormalized convimg output. ``mode`` is the
    JAX package's POSFEAT_HEAD_MODE: "v3" (K1; img_y is read only on the
    border ring, and the convimg IN statistics come from the patch gram
    matrix) or "v1" (cuDNN's full-res conv of img_y normalised by its
    own f32 IN statistics, then K3). Under a bf16 trunk the score comes
    out f32.

    ``ring=False`` is the ring-skip dataflow of POSFEAT_HEAD_RING=0
    (fused_head.py:475-483, 698-712): a zero halo in place of the edge
    clamp, no thin-strip ring correction, and IN statistics that carry the
    2-px ring's composite values. In v3 it reads img_y nowhere, which may
    then be None.

    ``im2col`` is POSFEAT_HEAD_IM2COL=1 (fused_head.py:463-474, 720-737):
    on the MXU it lays the trunk operand out as one matmul of depth 9·Cin,
    so that all 9·Cin products of an output meet in one f32 accumulator.
    K1's 9-tap wgmma K-loop already accumulates them into one f32
    accumulator per output, and Cin = 192 needs no padding here, so the
    option runs K1 as it is (and is accepted in v1, where JAX ignores it).

    The JAX head's ``triple`` (fused_head.py:432, :460-474), a row-tripled
    trunk layout for the MXU, has no counterpart here: K1's 9-tap K-loop
    already sums all 9·Cin products of an output in one f32 accumulator,
    which is what JAX's ``triple=True`` head computes.

    ``img_stats`` is where v3 takes the convimg IN statistics from
    (fused_head.py:433, :588-631): "gram", the patch gram matrix, or
    "xla", img_y itself (f32 sums over img_y as given, as JAX's
    ``_img_branch`` reduces y_img), which then must be given. v1 always
    normalises img_y by its own statistics.
    """
    if mode not in ("v3", "v1"):
        raise ValueError(f"mode must be 'v3' or 'v1', got {mode!r}")
    if img_stats not in IMG_STATS:
        raise ValueError(f"img_stats must be one of {IMG_STATS}, got {img_stats!r}")
    if img_y is None and (ring or mode == "v1" or img_stats == "xla"):
        raise ValueError("img_y is read on the border ring, in v1 and for img_stats='xla'; only v3 without the "
                         "ring and with the gram statistics goes without it")
    return _fused_head_tail(
        conv_phase if mode == "v3" else conv_phase_img, head_tail, trunk, img_s, img_y,
        k1_img, b1_img, k2_trunk, k2_img, b2, w3, b3, prelu_a, act, k, eps,
        debug_intermediates, mode, ring, img_stats,
    )


def _v3_image_operands(img_s, k1_img, b1_img, k2_img, b2, h, w, k, eps, dt, img_y=None):
    """v3's composite image branch (fused_head.py:571-659): the stride-4
    patches P [B, h, w, 192], the per-image weights Wm [B, 192, kk·Cout]
    and bias b2b [B, kk·Cout] of K1, and (mu32, a32, K5, b_z) for the
    ring deltas. The convimg IN statistics come from the patch gram
    matrix, or from ``img_y`` where it is given (``img_stats="xla"``)."""
    B = img_s.shape[0]
    cy, cout = k2_img.shape[2], k2_img.shape[3]
    kk = k * k
    dev = img_s.device
    C1 = k1_img.float()
    C2 = k2_img.float()

    # stride-4 overlapping 8×8×3 patches of the 2-px zero pad of s, (c, oy, ox)
    P = _patches(img_s.to(dt), 2 * k, stride=k, pad=2)  # [B, h, w, 192]
    if img_y is not None:
        mu32, a32 = _in_stats(img_y, eps)
    else:
        # convimg IN statistics from the patch gram matrix (fused_head.py
        # :588-631): with Wy embedding the 3×3 convimg kernel per phase, y in
        # phase layout = P @ Wy + b, so
        #   s1 = (1ᵀP)Wy + N·b,  s2 = diag(WyᵀGWy) + 2b⊙(1ᵀP)Wy + N·b²
        Wy = torch.zeros((3, 8, 8, kk, cy), dtype=torch.float32, device=dev)
        for py in range(k):
            for px in range(k):
                for dy in range(3):
                    for dx in range(3):
                        Wy[:, py + dy + 1, px + dx + 1, py * k + px, :] = C1[dy, dx]
        Wy = Wy.reshape(192, kk * cy)
        # bf16 products are exact in f32; sums in f32, as the JAX MXU does
        Pf = P.reshape(B, h * w, 192).float()
        G = Pf.transpose(1, 2) @ Pf  # [B, 192, 192]
        lin = Pf.sum(dim=1) @ Wy
        quad = ((G @ Wy) * Wy).sum(dim=1)
        n_full = kk * h * w
        b1f = b1_img.float().repeat(kk)[None, :]
        s1 = (lin + (n_full / kk) * b1f).reshape(B, kk, cy).sum(dim=1)
        s2 = (quad + 2.0 * b1f * lin + (n_full / kk) * b1f * b1f).reshape(B, kk, cy).sum(dim=1)
        mu32 = s1 / n_full
        a32 = torch.rsqrt(torch.clamp(s2 / n_full - mu32 * mu32, min=0.0) + eps)

    # composite 5×5 image-branch kernel: C2 ∘ IN ∘ C1 = K5 * s + b_z
    A1 = C1[None] * a32[:, None, None, None, :]  # [B, 3, 3, 3, Cy]
    K5 = torch.zeros((B, 5, 5, 3, cout), dtype=torch.float32, device=dev)
    for ey in range(3):
        for ex in range(3):
            K5[:, ey : ey + 3, ex : ex + 3] += torch.einsum("bfgcm,mh->bfgch", A1, C2[ey, ex])
    b_z = ((b1_img.float()[None, :] - mu32) * a32) @ C2.sum(dim=(0, 1))  # [B, Cout]
    # Wm[(c, oy, ox), (ry, rx, f)] = K5[oy - ry, ox - rx, c, f] (zero outside)
    Wt = torch.zeros((B, 8, 8, 3, kk, cout), dtype=torch.float32, device=dev)
    for ry in range(k):
        for rx in range(k):
            Wt[:, ry : ry + 5, rx : rx + 5, :, ry * k + rx] = K5
    Wm = Wt.permute(0, 3, 1, 2, 4, 5).reshape(B, 192, kk * cout).to(dt)
    b2b = (b2.float().repeat(kk)[None, :] + b_z.repeat(1, kk)).contiguous()  # [B, kk·Cout]
    return P.contiguous(), Wm.contiguous(), b2b, mu32, a32, K5, b_z


def _v1_z_img(img_y, k2_img, eps, dt):
    """v1's image half of conv2 at full resolution (fused_head.py:661-674):
    z_img = conv3x3_zeropad((img_y − μ)·a, k2_img) in the compute dtype,
    with μ and a = rsqrt(var + eps) img_y's f32 IN statistics, through
    cuDNN on the card. Returns z_img [B, 4h, 4w, Cout], contiguous."""
    y = img_y.float()
    mu, a = _in_stats(y, eps)
    img_feat = ((y - mu[:, None, None, :]) * a[:, None, None, :]).to(dt)
    z_img = F.conv2d(img_feat.permute(0, 3, 1, 2), k2_img.to(dt).permute(3, 2, 0, 1), padding=1)
    return z_img.permute(0, 2, 3, 1).to(dt).contiguous()


def _fused_head_tail(
    conv_fn, tail_fn, trunk, img_s, img_y, k1_img, b1_img, k2_trunk, k2_img, b2, w3, b3,
    prelu_a, act: str = "Softplus", k: int = 4, eps: float = 1e-5,
    debug_intermediates: bool = False, mode: str = "v3", ring: bool = True, img_stats: str = "gram",
):
    """``fused_head_tail`` with its kernels given as ``conv_fn`` and
    ``tail_fn``: the wrappers, or their plain versions to hold a card's
    score map against. ``conv_fn`` has K1's signature in mode "v3"
    (``conv_phase``) and K3's in mode "v1" (``conv_phase_img``)."""
    assert k == 4, "phase-layout head derived for the x4 upsample"
    B, h, w, cin = trunk.shape
    cout = k2_trunk.shape[3]
    out_ch = w3.shape[-1]
    kk = k * k
    dt = trunk.dtype
    Hf, Wf = k * h, k * w

    # the trunk operands of K1/K3: channels padded to a multiple of 32
    # (zeros add nothing); the halo is the upsample's clamp (edge pad), or
    # zeros in the ring-skip dataflow (fused_head.py:698-712)
    cin_p = -(-cin // 32) * 32
    kph = F.pad(_phase_kernel(k2_trunk, k), (0, 0, 0, cin_p - cin)).to(dt)
    kph = kph.reshape(9, cin_p, kk * cout).contiguous()
    if ring:
        tp = F.pad(_edge_pad1(trunk), (0, cin_p - cin)).contiguous()
    else:
        tp = F.pad(trunk, (0, cin_p - cin, 1, 1, 1, 1)).contiguous()

    if mode == "v3":
        P, Wm, b2b, mu32, a32, K5, b_z = _v3_image_operands(
            img_s, k1_img, b1_img, k2_img, b2, h, w, k, eps, dt, img_y if img_stats == "xla" else None
        )
        z, ssum, ssq = conv_fn(tp, kph, P, Wm, b2b)
    elif mode == "v1":
        z_img = _v1_z_img(img_y, k2_img, eps, dt)
        b2ph = b2.float().repeat(kk).contiguous()  # [kk·Cout]
        z, ssum, ssq = conv_fn(tp, kph, z_img, b2ph, "full")
    else:
        raise ValueError(f"mode must be 'v3' or 'v1', got {mode!r}")

    # ---- thin-strip border corrections (O(perimeter) work) ----
    # z carries the clamped-composite trunk values (ring width 1: strips
    # T/Bo/L/R) and, in v3, the composite image-branch values (ring width
    # 2: strips G_*); v1's z_img is exact. Compute the exact ring values,
    # correct the IN1 statistics, and later rewrite u's ring: conv3 is
    # 1×1, so interior pixels never see ring errors. The ring-skip
    # dataflow keeps z's values there, and the IN statistics with them.
    ids = []
    if ring:
        T, Bo, L, R = ring_correction_strips(trunk, k2_trunk, k)
        if mode == "v3":
            G_top, G_bot, G_left, G_right = _img_ring_deltas(img_s, img_y, mu32, a32, K5, k2_img, b_z)
            ids, margin = [0, 1, k - 2, k - 1], 2

            def G_row(ry):
                return G_top[:, ry] if ry < k // 2 else G_bot[:, ry - (k - 2)]

            def G_col(rx):
                return G_left[:, :, rx] if rx < k // 2 else G_right[:, :, rx - (k - 2)]

        else:
            ids, margin = [0, k - 1], 1
            G_row = G_col = lambda r: 0.0
    lo_ids = [i for i in ids if i < k // 2]  # ring phases at trunk row/column 0
    hi_ids = [i for i in ids if i >= k // 2]  # ... and at row h-1 / column w-1

    def z_row_raw(ry):
        hrow = 0 if ry < k // 2 else h - 1
        return z[:, hrow, :, ry * k * cout : (ry + 1) * k * cout].float().reshape(B, Wf, cout)

    def z_col_raw(rx):
        wcol = 0 if rx < k // 2 else w - 1
        zc = z[:, :, wcol, :].float().reshape(B, h, kk, cout)[:, :, rx::k, :]
        return zc.reshape(B, Hf, cout)

    def D_row(ry):
        # corner-inclusive row corrections (rows own the corners)
        base = T if ry == 0 else (Bo if ry == k - 1 else torch.zeros_like(T))
        fr = ry if ry < k // 2 else Hf - k + ry
        d = base.clone()
        d[:, 0] += L[:, fr]
        d[:, -1] += R[:, fr]
        return d

    def D_col(rx):
        return L if rx == 0 else (R if rx == k - 1 else 0.0)

    row_raw = {ry: z_row_raw(ry) for ry in ids}
    col_raw = {rx: z_col_raw(rx) for rx in ids}
    row_e = {ry: row_raw[ry] - D_row(ry) - G_row(ry) for ry in ids}
    col_e = {rx: col_raw[rx] - D_col(rx) - G_col(rx) for rx in ids}

    def ring_delta(e_rows, raw_rows, e_cols, raw_cols):
        # disjoint accounting: full rows + interior of the columns
        d1 = d2 = 0.0
        for i in ids:
            d1 = d1 + (e_rows[i] - raw_rows[i]).sum(dim=1)
            d2 = d2 + (e_rows[i] ** 2 - raw_rows[i] ** 2).sum(dim=1)
        for i in ids:
            e, r = e_cols[i][:, margin:-margin], raw_cols[i][:, margin:-margin]
            d1 = d1 + (e - r).sum(dim=1)
            d2 = d2 + (e * e - r * r).sum(dim=1)
        return d1, d2

    # IN1 statistics: pool the tile partials over tiles and phases, then
    # add the ring deltas
    n_px = h * w * kk
    s1 = ssum.sum(dim=1).reshape(B, kk, cout).sum(dim=1)
    s2 = ssq.sum(dim=1).reshape(B, kk, cout).sum(dim=1)
    d1 = d2 = torch.zeros_like(s1)
    if ring:
        d1, d2 = ring_delta(row_e, row_raw, col_e, col_raw)
    mu = (s1 + d1) / n_px
    sc = torch.rsqrt(torch.clamp((s2 + d2) / n_px - mu * mu, min=0.0) + eps)

    a_val = prelu_a.float().reshape(1)
    w3f = w3.reshape(cout, out_ch).float().contiguous()
    b3f = b3.float().contiguous()
    u, usum, usq = tail_fn(z, mu.contiguous(), sc.contiguous(), a_val, w3f, b3f)

    # ---- ring rewrite on u (conv3 is 1×1: ring errors never spread) ----
    def tail_plane(e):
        x1 = (e - mu[:, None, :]) * sc[:, None, :]
        x1 = torch.where(x1 >= 0, x1, a_val * x1)
        return x1 @ w3f + b3f

    ko = k * out_ch

    def u_row_raw(ry):
        hrow = 0 if ry < k // 2 else h - 1
        return u[:, hrow, :, ry * ko : (ry + 1) * ko].reshape(B, Wf, out_ch)

    def u_col_raw(rx):
        wcol = 0 if rx < k // 2 else w - 1
        uc = u[:, :, wcol, :].reshape(B, h, kk, out_ch)[:, :, rx::k, :]
        return uc.reshape(B, Hf, out_ch)

    u_row_e = {ry: tail_plane(row_e[ry]) for ry in ids}
    u_col_e = {rx: tail_plane(col_e[rx]) for rx in ids}

    # IN2 statistics with ring deltas (same disjoint accounting)
    us = usum.sum(dim=1)
    uq = usq.sum(dim=1)
    if ring:
        du1, du2 = ring_delta(
            u_row_e, {i: u_row_raw(i) for i in ids}, u_col_e, {i: u_col_raw(i) for i in ids}
        )
        us = us + du1
        uq = uq + du2
    mu2 = us / n_px
    sc2 = torch.rsqrt(torch.clamp(uq / n_px - mu2 * mu2, min=0.0) + eps)

    # overwrite the ring in place in K2's output (columns first; rows
    # then own the corners)
    if ring:
        for wcol, cols in ((0, lo_ids), (w - 1, hi_ids)):
            uw = u[:, :, wcol, :].reshape(B, h, kk, out_ch).clone()
            for rx in cols:
                uw[:, :, rx::k, :] = u_col_e[rx].reshape(B, h, k, out_ch)
            u[:, :, wcol, :] = uw.reshape(B, h, kk * out_ch)
        for ry in ids:
            hrow = 0 if ry < k // 2 else h - 1
            u[:, hrow, :, ry * ko : (ry + 1) * ko] = u_row_e[ry].reshape(B, w, ko)

    u = u.reshape(B, h, w, kk, out_ch)
    xn = (u - mu2[:, None, None, None, :]) * sc2[:, None, None, None, :]
    if act == "Softplus":
        s = F.softplus(xn)
    elif act == "Sigmoid":
        s = torch.sigmoid(xn)
    else:
        raise ValueError(act)
    # phase -> space on the 1-2 channel score map
    s = s.reshape(B, h, w, k, k, out_ch).permute(0, 1, 3, 2, 4, 5).reshape(B, Hf, Wf, out_ch)
    # the tail above is f32; a bf16 trunk keeps f32 score values
    # (fused_head.py:1139-1145: a bf16 score map collapses the top-k)
    out_dt = torch.float32 if dt == torch.bfloat16 else dt
    s = s.to(out_dt)
    if debug_intermediates:
        dbg = {"z": z, "s1": s1, "mu": mu, "sc": sc, "d1": d1, "u": u, "mu2": mu2, "sc2": sc2, "us": us}
        if ring:
            dbg.update(e_top=row_e[0], u_top_e=u_row_e[0])
        return s, dbg
    return s
