"""Fused KeypointDet tail: ×4 upsample + conv2 -> IN -> PReLU -> conv3 ->
IN -> act, without a full-resolution 128-channel tensor
(posfeat_tpu/ops/pallas/fused_head.py, mode v3 with the exact border
ring).

The conv runs in PHASE layout: z [B, h, w, 16·Cout], channel
(ry·4 + rx)·Cout + c holds full-res pixel (4y + ry, 4x + rx). The image
branch (convimg 3->64, its IN, conv2's image half 64->Cout) folds into
one per-image composite 5×5 kernel, applied as a matmul on stride-4
8×8×3 patches. Two kernels carry the work:

- K1 ``conv_phase``: z = phase conv of the edge-padded trunk + patches @
  Wm[b] + b2b[b], stored in the compute dtype, plus per-tile f32 column
  Σz and Σz² of the accumulator before rounding.
- K2 ``head_tail``: u = PReLU((z − μ)·s) @ w3 + b3 in f32, plus per-tile
  Σu and Σu².

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_head.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it. Everything else here is plain PyTorch: the
composite fold, the convimg IN statistics (patch gram form), the
border-ring corrections, IN statistics and the final activation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# K1 tile (trunk rows × columns per CUDA block); csrc/fused_head.cu
# rejects a launch whose tile differs from its compile-time constants
K1_TILE = (4, 16)
K1_BN = 128  # output channels per K1 block
K2_ROWS = 256  # phase rows per K2 block
K2_MAX_OUT = 4


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from ._build import load_kernels

        msg = load_kernels().posfeat_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({rc}): {msg}")


# ------------------------------------------------------------------- K1


def conv_phase_plain(tp, kph, pat, wm, b2b):
    """Plain version of K1, in f32. tp [B, h+2, w+2, C] edge-padded trunk;
    kph [9, C, N] phase kernel (tap = dy·3 + dx); pat [B, h, w, KP]
    patches; wm [B, KP, N]; b2b [B, N] f32 -> (z [B, h, w, N] in tp's
    dtype, Σz [B, 1, N], Σz² [B, 1, N]) with moments of the f32 values."""
    B, hp, wp, C = tp.shape
    h, w, N = hp - 2, wp - 2, kph.shape[-1]
    k4 = kph.float().reshape(3, 3, C, N).permute(3, 2, 0, 1)
    z = F.conv2d(tp.float().permute(0, 3, 1, 2), k4).permute(0, 2, 3, 1)
    z = z + (pat.float().reshape(B, h * w, -1) @ wm.float()).reshape(B, h, w, N)
    z = z + b2b.float()[:, None, None, :]
    return z.to(tp.dtype), z.sum(dim=(1, 2))[:, None], (z * z).sum(dim=(1, 2))[:, None]


def conv_phase(tp, kph, pat, wm, b2b):
    """K1 (replaces posfeat_tpu/ops/pallas/fused_head.py:148
    ``_conv_kernel_v3``). Same contract as ``conv_phase_plain``, except
    that the moments come per K1 tile: [B, T, N]."""
    if tp.device.type == "cpu":
        return conv_phase_plain(tp, kph, pat, wm, b2b)
    from ._build import load_kernels

    B, hp, wp, C = tp.shape
    h, w = hp - 2, wp - 2
    N, KP = kph.shape[-1], pat.shape[-1]
    dev, bf = tp.device, torch.bfloat16
    _check(tp, "tp", bf, (B, hp, wp, C), dev)
    _check(kph, "kph", bf, (9, C, N), dev)
    _check(pat, "pat", bf, (B, h, w, KP), dev)
    _check(wm, "wm", bf, (B, KP, N), dev)
    _check(b2b, "b2b", torch.float32, (B, N), dev)
    if C % 32 or KP % 32 or N % K1_BN:
        raise ValueError(f"K1 needs C, KP % 32 == 0 and N % {K1_BN} == 0; got {C}, {KP}, {N}")
    th, tw = K1_TILE
    T = -(-h // th) * -(-w // tw)
    z = torch.empty((B, h, w, N), dtype=bf, device=dev)
    psum = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    rc = load_kernels().posfeat_conv_phase(
        _ptr(tp), _ptr(kph), _ptr(pat), _ptr(wm), _ptr(b2b),
        _ptr(z), _ptr(psum), _ptr(psq), B, h, w, C, KP, N, th, tw, _stream(),
    )
    conv_phase.launches += 1
    _raise_on(rc, "K1 conv_phase")
    return z, psum, psq


conv_phase.launches = 0


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


def head_tail(z, mu, sc, a, w3, b3):
    """K2 (replaces posfeat_tpu/ops/pallas/fused_head.py:284
    ``_tail_kernel``). Same contract as ``head_tail_plain``, except that
    the moments come per K2 block: [B, T2, out]."""
    if z.device.type == "cpu":
        return head_tail_plain(z, mu, sc, a, w3, b3)
    from ._build import load_kernels

    B, h, w, n = z.shape
    cout, out_ch = w3.shape
    dev, f32 = z.device, torch.float32
    _check(z, "z", torch.bfloat16, (B, h, w, n), dev)
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
    T2 = -(-R // K2_ROWS)
    u = torch.empty((B, h, w, (n // cout) * out_ch), dtype=f32, device=dev)
    usum = torch.empty((B, T2, out_ch), dtype=f32, device=dev)
    usq = torch.empty_like(usum)
    rc = load_kernels().posfeat_head_tail(
        _ptr(z), _ptr(mu), _ptr(sc), _ptr(a), _ptr(w3), _ptr(b3),
        _ptr(u), _ptr(usum), _ptr(usq), B, R, cout, out_ch, K2_ROWS, _stream(),
    )
    head_tail.launches += 1
    _raise_on(rc, "K2 head_tail")
    return u, usum, usq


head_tail.launches = 0


# ------------------------------------------------------- the head tail


def _phase_kernel(k2_trunk: torch.Tensor, k: int = 4) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [3, 3, Cin, k·k·Cout] phase kernel (f32)."""
    from ..models.keypoint_det import _phase_mix_matrix

    M, D = _phase_mix_matrix(k)
    assert D == 3
    M = torch.from_numpy(M).to(k2_trunk.device)
    kph = torch.einsum("rda,sep,apcf->decrsf", M, M, k2_trunk.float())
    cin, cout = k2_trunk.shape[2], k2_trunk.shape[3]
    return kph.reshape(3, 3, cin, k * k * cout)


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


def fused_head_tail(
    trunk, img_s, img_y, k1_img, b1_img, k2_trunk, k2_img, b2, w3, b3, prelu_a,
    act: str = "Softplus", k: int = 4, eps: float = 1e-5,
    debug_intermediates: bool = False,
):
    """Reference-exact head tail -> full-res score [B, k·h, k·w, out]
    (posfeat_tpu/ops/pallas/fused_head.py:413-1155, mode v3, ring on).

    Equivalent to (DeteNet.py:108-113, identity prior):
        z = conv3x3_zeropad(upsample_x4(trunk))
            + conv3x3_zeropad(IN(conv3x3_zeropad(img_s) + b1)) + b2
        x = prelu(instance_norm(z)); u = conv1x1(x) + b3
        score = act(instance_norm(u))

    Layouts are the JAX ones: NHWC maps, conv kernels [kh, kw, in, out].
    trunk [B, h, w, Cin] (post conv1 + IN + PReLU); img_s [B, 4h, 4w, 3];
    img_y [B, 4h, 4w, Cy] unnormalized convimg output, read only on the
    border ring. The convimg IN statistics come from the patch gram
    matrix (JAX's default ``img_stats='gram'``), so unlike the JAX
    signature this one takes no img_mu / img_a. Under a bf16 trunk the
    score comes out f32.
    """
    return _fused_head_tail(
        conv_phase, head_tail, trunk, img_s, img_y, k1_img, b1_img, k2_trunk, k2_img,
        b2, w3, b3, prelu_a, act, k, eps, debug_intermediates,
    )


def _fused_head_tail(
    conv_fn, tail_fn, trunk, img_s, img_y, k1_img, b1_img, k2_trunk, k2_img, b2, w3, b3,
    prelu_a, act: str = "Softplus", k: int = 4, eps: float = 1e-5,
    debug_intermediates: bool = False,
):
    """``fused_head_tail`` with K1 and K2 given as ``conv_fn`` and
    ``tail_fn`` (the kernels' wrappers, or their plain versions to hold
    a card's score map against)."""
    assert k == 4, "composite image branch derived for the x4 head"
    B, h, w, cin = trunk.shape
    cout = k2_trunk.shape[3]
    cy = k2_img.shape[2]
    out_ch = w3.shape[-1]
    kk = k * k
    dt = trunk.dtype
    dev = trunk.device
    Hf, Wf = k * h, k * w

    C1 = k1_img.float()
    C2 = k2_img.float()

    # stride-4 overlapping 8×8×3 patches of the 2-px zero pad of s, (c, oy, ox)
    P = _patches(img_s.to(dt), 2 * k, stride=k, pad=2)  # [B, h, w, 192]
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
    n_full = Hf * Wf
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

    # K1 operands: channels padded to a multiple of 32 (zeros add nothing)
    cin_p = -(-cin // 32) * 32
    kph = F.pad(_phase_kernel(k2_trunk, k), (0, 0, 0, cin_p - cin)).to(dt)
    kph = kph.reshape(9, cin_p, kk * cout).contiguous()
    tp = torch.cat([trunk[:, :1], trunk, trunk[:, -1:]], dim=1)  # edge pad = upsample clamp
    tp = torch.cat([tp[:, :, :1], tp, tp[:, :, -1:]], dim=2)
    tp = F.pad(tp, (0, cin_p - cin)).contiguous()
    z, ssum, ssq = conv_fn(tp, kph, P.contiguous(), Wm.contiguous(), b2b)

    # ---- thin-strip border corrections (O(perimeter) work) ----
    # z carries the clamped-composite trunk values (ring width 1: strips
    # T/Bo/L/R) and the composite image-branch values (ring width 2:
    # strips G_*). Compute the exact ring values, correct the IN1
    # statistics, and later rewrite u's ring: conv3 is 1×1, so interior
    # pixels never see ring errors.
    from ..models.keypoint_det import ring_correction_strips

    T, Bo, L, R = ring_correction_strips(trunk, k2_trunk, k)
    G_top, G_bot, G_left, G_right = _img_ring_deltas(img_s, img_y, mu32, a32, K5, k2_img, b_z)
    ids = [0, 1, k - 2, k - 1]
    margin = 2

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

    def G_row(ry):
        return G_top[:, ry] if ry < k // 2 else G_bot[:, ry - (k - 2)]

    def D_col(rx):
        return L if rx == 0 else (R if rx == k - 1 else 0.0)

    def G_col(rx):
        return G_left[:, :, rx] if rx < k // 2 else G_right[:, :, rx - (k - 2)]

    row_raw = {ry: z_row_raw(ry) for ry in ids}
    col_raw = {rx: z_col_raw(rx) for rx in ids}
    row_e = {ry: row_raw[ry] - D_row(ry) - G_row(ry) for ry in ids}
    col_e = {rx: col_raw[rx] - D_col(rx) - G_col(rx) for rx in ids}

    def ring_delta(e_rows, raw_rows, e_cols, raw_cols):
        # disjoint accounting: full rows + interior of the columns
        d1 = sum((e_rows[i] - raw_rows[i]).sum(dim=1) for i in ids)
        d2 = sum((e_rows[i] ** 2 - raw_rows[i] ** 2).sum(dim=1) for i in ids)
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
    du1, du2 = ring_delta(
        u_row_e, {i: u_row_raw(i) for i in ids}, u_col_e, {i: u_col_raw(i) for i in ids}
    )
    us = us + du1
    uq = uq + du2
    mu2 = us / n_px
    sc2 = torch.rsqrt(torch.clamp(uq / n_px - mu2 * mu2, min=0.0) + eps)

    # overwrite the ring in place in K2's output (columns first; rows
    # then own the corners)
    for wcol, cols in ((0, ids[:2]), (w - 1, ids[2:])):
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
        return s, {
            "z": z, "s1": s1, "mu": mu, "sc": sc, "d1": d1, "u": u,
            "mu2": mu2, "sc2": sc2, "us": us, "e_top": row_e[0], "u_top_e": u_row_e[0],
        }
    return s
