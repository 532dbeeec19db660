"""Keypoint score head ("DeteNet"; posfeat_tpu/models/keypoint_det.py,
reference networks/DeteNet.py:5-120).

A handcrafted prior modulates [fine_map, image]; trunk convs run at
feature resolution and the score comes out at full image resolution.
InstanceNorm is non-affine; the PReLU slope is one shared parameter.

Dataflows, chosen by ``fused_upsample`` as in the JAX package
(keypoint_det.py:528-612); all compute the reference's function:

- ``False``: the reference dataflow, ×4 upsample + concat + conv2 at
  full resolution.
- ``"always"``, and ``True`` ("auto") at bf16/f16: conv2's trunk half as
  one input-dilated conv of the composite upsample∘conv kernel
  (``fused_upsample_conv3x3_dilated``), its 1-px border ring rewritten
  exactly. ``True`` at f32 is the reference dataflow.
- ``"phase"``: conv2's trunk half as a phase-layout conv
  (``fused_upsample_conv3x3_phase``) with additive ring strips; the tail
  stays in phase layout and only the score map goes back to space.
- ``"pallas"``: the fused head of ``ops/fused_head.py``, whose kernels
  run as CUDA on the card at bf16 or f32 (``check_head_dataflow``);
  ``fused_head_mode`` picks its dataflow, "v3"
  (K1) or "v1" (cuDNN's full-res image conv, then K3), as the JAX
  package's POSFEAT_HEAD_MODE does. The config string stays so that
  existing configs mean the same thing. ``head_ring=False`` takes its
  ring-skip dataflow (POSFEAT_HEAD_RING=0): then in v3 the full-resolution
  convimg output is not computed at all, since only the patch statistics
  of the prior-scaled image enter K1 (JAX gets this from XLA's dead-code
  elimination). ``head_im2col`` (POSFEAT_HEAD_IM2COL=1) runs K1 as it is
  (``fused_head_tail``).

The fused dataflows are derived for a trunk at a quarter of the image's
size (ResUNet's H/4 local map). At any other ratio (ResUNetHR's H/2) the
head takes the reference dataflow, as the JAX head does
(keypoint_det.py:537-539); where a fused dataflow was asked for, it says
so in a warning.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_head import KERNEL_DTYPES, fused_head_tail
from ..ops.moments import check_dims, moments, normalize, row_moments
from ..ops.phase import (
    _bilinear_taps_1d,
    _edge_pad1,
    _phase_kernel,
    phase_to_space,
    ring_correction_strips,
    space_to_phase,
)
from ..ops.resize import _upsample_axis_int, interpolate_bilinear


def instance_norm(x: torch.Tensor, eps: float = 1e-5, dims=(1, 2)) -> torch.Tensor:
    """Non-affine InstanceNorm over the spatial dims of NHWC (every axis
    between the batch and the channels: (1, 2), or (1, 2, 3, 4) in the
    phase layout), biased variance; statistics in f32 whatever the compute
    dtype, summed row by row (``ops/moments.py``: the row-moments kernel on
    the card), so that the banded program's norms are this one's bit for
    bit."""
    check_dims(x, dims)
    s1, s2 = row_moments(x)
    mean, rstd = moments(s1, s2, math.prod(x.shape[1:-1]), eps)
    return normalize(x, mean, rstd)


def fused_upsample_conv3x3_phase(trunk: torch.Tensor, kernel: torch.Tensor, k: int = 4):
    """conv3x3(bilinear_upsample_×k(trunk)) in PHASE layout
    (keypoint_det.py:95-143): each of the k² output phases is a 3×3 conv
    of the edge-padded trunk, so one VALID conv with the [3, 3, Cin,
    k²·Cout] phase kernel computes them all without the upsampled map.
    The conv's zero padding differs from this composite on the outermost
    output ring only: ``_fix_border_ring_phase`` makes it exact.
    trunk [B, h, w, Cin], kernel [3, 3, Cin, Cout] -> [B, h, w, k, k, Cout]
    in trunk's dtype."""
    B, h, w, _ = trunk.shape
    cout = kernel.shape[-1]
    kph = _phase_kernel(kernel, k).to(trunk.dtype)
    z = _conv(_edge_pad1(trunk), kph.permute(3, 2, 0, 1))
    return z.reshape(B, h, w, k, k, cout)


def fused_upsample_conv3x3_dilated(trunk: torch.Tensor, kernel: torch.Tensor, k: int = 4):
    """conv3x3(bilinear_upsample_×k(trunk)) as ONE input-dilated conv
    (keypoint_det.py:159-226): both ops are linear, so their composite
    is one kernel comp [n, n, Cin, Cout] (n = 2k + 2) applied to the
    edge-padded trunk dilated by k. Here that is a stride-k transposed
    conv: y[o] = Σ_j comp[o + n − 1 − pl − k·j]·tp[j], pl = hi + 1 − k.
    The outermost output ring is rewritten exactly (``_fix_border_ring``).
    trunk [B, h, w, Cin], kernel [3, 3, Cin, Cout] -> [B, k·h, k·w, Cout]
    in trunk's dtype."""
    ms, vals = _bilinear_taps_1d(k)
    lo, hi = ms[0], ms[-1]
    n_taps = hi - lo + 3  # composite support incl. the conv's ±1
    u_ext = np.zeros((n_taps + 2,), np.float32)
    for m, v in zip(ms, vals):
        u_ext[m - lo + 2] = v
    A = torch.from_numpy(np.stack([u_ext[d : d + n_taps] for d in range(3)], axis=1))
    A = A.to(kernel.device)
    comp = torch.einsum("yd,xe,decf->yxcf", A, A, kernel.float()).to(trunk.dtype)
    B, h, w, _ = trunk.shape
    pad = n_taps - 1 - (hi + 1 - k)
    out = F.conv_transpose2d(
        _edge_pad1(trunk).permute(0, 3, 1, 2), comp.permute(2, 3, 0, 1), stride=k, padding=pad
    ).permute(0, 2, 3, 1)
    assert out.shape[1] == k * h and out.shape[2] == k * w, out.shape
    return _fix_border_ring(out, trunk, kernel, k).to(trunk.dtype)


def _fix_border_ring(out, trunk, kernel, k):
    """Overwrite the dilated composite's outermost output ring with the
    reference-exact values (keypoint_det.py:231-283): there the reference
    conv zero-pads the upsampled map, and for k = 4 the two outer
    upsampled rows/columns both equal the trunk's edge, so the ring is
    four 1-D convs of upsampled edge strips."""
    assert k == 4, "exact border fix derived for the head's x4 case"
    h, w = trunk.shape[1:3]
    K = kernel.float()
    t32 = trunk.float()
    top_src = _upsample_axis_int(t32[:, 0:1], k, 2)[:, 0]
    bot_src = _upsample_axis_int(t32[:, h - 1 : h], k, 2)[:, 0]
    left_src = _upsample_axis_int(t32[:, :, 0:1], k, 1)[:, :, 0]
    right_src = _upsample_axis_int(t32[:, :, w - 1 : w], k, 1)[:, :, 0]

    def conv1d(strip, k1d):
        # strip [B, L, Cin], k1d [3, Cin, Cout]; zero 'same' padding
        L = strip.shape[1]
        sp = F.pad(strip, (0, 0, 1, 1))
        return sum(sp[:, t : t + L] @ k1d[t] for t in range(3))

    dt = out.dtype
    z_top = conv1d(top_src, K[1] + K[2]).to(dt)
    z_bot = conv1d(bot_src, K[0] + K[1]).to(dt)
    z_left = conv1d(left_src, K[:, 1] + K[:, 2]).to(dt)
    z_right = conv1d(right_src, K[:, 0] + K[:, 1]).to(dt)
    mid = torch.cat(
        [z_left[:, 1:-1, None], out[:, 1:-1, 1:-1], z_right[:, 1:-1, None]], dim=2
    )
    return torch.cat([z_top[:, None], mid, z_bot[:, None]], dim=1)


def _fix_border_ring_phase(z, trunk, kernel, k):
    """Subtract ``ring_correction_strips`` from a phase-layout
    [B, h, w, k, k, Cout] tensor (keypoint_det.py:353-396): the row
    strips on trunk rows 0 / h−1 at phase rows 0 / k−1, the column
    strips on trunk columns 0 / w−1 at phase columns 0 / k−1."""
    T, Bo, L, R = ring_correction_strips(trunk, kernel, k)
    B, h, w = trunk.shape[:3]
    C, dt = z.shape[-1], z.dtype
    z = z.clone()
    z[:, :, 0, :, 0] -= L.reshape(B, h, k, C).to(dt)
    z[:, :, w - 1, :, k - 1] -= R.reshape(B, h, k, C).to(dt)
    z[:, 0, :, 0] -= T.reshape(B, w, k, C).to(dt)
    z[:, h - 1, :, k - 1] -= Bo.reshape(B, w, k, C).to(dt)
    return z


def _conv(x: torch.Tensor, weight: torch.Tensor, bias=None, padding: int = 0):
    """NHWC conv with a torch [out, in, kh, kw] kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding)
    return y.permute(0, 2, 3, 1)


# elements of one conv's input: past the 32-bit index range cuDNN takes a
# 64-bit direct kernel, which ran the reference head's conv2 of a 12 Mpx
# frame (3.1e9 input elements) in 15.4 s on an H100
# (tools/profile_torch_frame.py); such a conv runs in row blocks of at
# most half of it
CONV_MAX_ELEMENTS = 2**31 - 1


def _conv_cat(parts, weight: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """``_conv(torch.cat(parts, -1), weight, None, padding)``; past
    ``CONV_MAX_ELEMENTS`` input elements in blocks of output rows, each
    concat taking ``padding`` rows of its neighbours above and below (zero
    rows only beyond the map's edges)."""
    B, H, W = parts[0].shape[:3]
    C = sum(p.shape[-1] for p in parts)
    if B * H * W * C <= CONV_MAX_ELEMENTS:
        return _conv(torch.cat(parts, dim=-1), weight, None, padding)
    rows = max(1, CONV_MAX_ELEMENTS // (2 * B * W * C) - 2 * padding)
    out = []
    for a in range(0, H, rows):
        b = min(a + rows, H)
        lo, hi = max(a - padding, 0), min(b + padding, H)
        x = torch.cat([p[:, lo:hi] for p in parts], dim=-1).permute(0, 3, 1, 2)
        x = F.pad(x, (padding, padding, padding - (a - lo), padding - (hi - b)))
        out.append(F.conv2d(x, weight).permute(0, 2, 3, 1))
    return torch.cat(out, dim=1)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "Sigmoid":
        return torch.sigmoid(x)
    if act == "Softplus":
        return F.softplus(x)
    raise ValueError(f"unknown act {act}")


def check_head_dataflow(fused_upsample, dtype: torch.dtype, device_type: str) -> None:
    """Refuses the fused head (``fused_upsample="pallas"``) on the card at
    a dtype its CUDA kernels K1/K2 (and K3 in mode v1) have no instance
    for: they take bfloat16 and float32, the dtypes the JAX head runs its
    kernels at. On the CPU the kernels' plain versions run every dtype.
    Raises ValueError; nothing switches dataflow silently."""
    if fused_upsample == "pallas" and dtype not in KERNEL_DTYPES and device_type == "cuda":
        raise ValueError(
            f"fused_upsample='pallas' at {dtype} on the card: the fused head's kernels K1/K2 (and K3 "
            "with fused_head_mode 'v1') take bfloat16 and float32 only. Run it at one of those, or pick "
            "a dataflow that runs at any dtype: False, True, 'phase' or 'always'")


class KeypointDet(nn.Module):
    """Keypoint score head. Parameter names are the reference's
    (conv1, conv2, conv3, convimg, relu), so reference
    ``localheader.pth`` files load as they are. Parameters stay f32;
    the forward casts to ``dtype`` where the JAX head does."""

    def __init__(self, in_channels: int, out_channels: int = 1, prior: str = "SSIM",
                 act: str = "Sigmoid", fused_upsample=True, fused_head_mode: str = "v3",
                 head_ring: bool = True, head_im2col: bool = False, dtype=torch.float32):
        super().__init__()
        if fused_upsample not in (True, False, "always", "phase", "pallas"):
            raise ValueError(f"unknown fused_upsample {fused_upsample!r}")
        if fused_head_mode not in ("v3", "v1"):
            raise ValueError(f"fused_head_mode must be 'v3' or 'v1', got {fused_head_mode!r}")
        if prior not in ("SSIM", "D2", "ASL_Peak", "identity"):
            raise ValueError(f"unknown prior {prior}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.prior = prior
        self.act = act
        self.fused_upsample = fused_upsample
        self.fused_head_mode = fused_head_mode
        self.head_ring = bool(head_ring)
        self.head_im2col = bool(head_im2col)
        self.dtype = dtype
        self._warned_ratio = False
        self.conv1 = nn.Conv2d(in_channels, in_channels, 3, 1, 1)
        self.conv2 = nn.Conv2d(in_channels + 64, 128, 3, 1, 1)
        self.conv3 = nn.Conv2d(128, out_channels, 1, 1, 0)
        self.relu = nn.PReLU()
        self.convimg = nn.Conv2d(3, 64, 3, 1, 1)

    def _prior(self, x):
        from ..ops import priors as P

        if self.prior == "SSIM":
            return P.ssim_prior(x)  # per channel, DeteNet:24-45
        if self.prior == "D2":
            return P.d2_prior(x)
        if self.prior == "ASL_Peak":
            return P.asl_peak_prior(x)
        return torch.ones_like(x).mean(dim=-1, keepdim=True)

    def warn_off_ratio(self, h: int, w: int, H: int, W: int) -> None:
        """Warns once where a fused dataflow was asked for and the trunk
        (h, w) is not at 1/4 of the image (H, W): the head then takes the
        reference dataflow."""
        fu = self.fused_upsample
        if fu in ("pallas", "phase", "always") and (H, W) != (4 * h, 4 * w) and not self._warned_ratio:
            self._warned_ratio = True
            warnings.warn(f"KeypointDet: fused_upsample={fu!r} is derived for a trunk at 1/4 of the image; "
                          f"this trunk is {h}x{w} for a {H}x{W} image, so the head takes the reference "
                          "dataflow (upsample, concat, conv2), as the JAX head does", stacklevel=3)

    def forward(self, fine_map: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """fine_map [B, h, w, C_in], img [B, H, W, 3] -> score [B, H, W, out]."""
        dt = self.dtype
        check_head_dataflow(self.fused_upsample, dt, fine_map.device.type)
        a = self.relu.weight

        def prelu(x):
            return torch.where(x >= 0, x, a.to(x.dtype) * x)

        fine_map = fine_map.to(dt)
        img = img.to(dt)
        x_pf = self._prior(fine_map)
        x_pi = self._prior(img)
        trunk = prelu(instance_norm(_conv(
            x_pf * fine_map, self.conv1.weight.to(dt), self.conv1.bias.to(dt), 1
        )))
        s_img = (x_pi * img).to(dt)
        B, H, W = img.shape[:3]
        h, w = trunk.shape[1:3]
        fu = self.fused_upsample
        size_ok = H == 4 * h and W == 4 * w
        fused = fu == "pallas" and size_ok
        y_img = None
        if not (fused and self.fused_head_mode == "v3" and not self.head_ring):
            y_img = _conv(s_img, self.convimg.weight.to(dt), None, 1) + self.convimg.bias.to(dt)

        cin = self.in_channels
        k2 = self.conv2.weight  # [128, C_in + 64, 3, 3]
        hwio = lambda t: t.permute(2, 3, 1, 0)
        self.warn_off_ratio(h, w, H, W)
        if fused:
            score = fused_head_tail(
                trunk, s_img, y_img, hwio(self.convimg.weight), self.convimg.bias,
                hwio(k2[:, :cin]), hwio(k2[:, cin:]), self.conv2.bias,
                hwio(self.conv3.weight), self.conv3.bias, a, act=self.act,
                mode=self.fused_head_mode, ring=self.head_ring, im2col=self.head_im2col,
            )
        else:
            img_feat = instance_norm(y_img.float()).to(dt)
            b2 = self.conv2.bias.to(dt)

            def conv2_img_part():
                # image half of conv2, shared by the phase and dilated dataflows
                return _conv(img_feat, k2[:, cin:].to(dt), None, 1).to(dt)

            fuse_ok = fu in ("always", "phase") or (
                fu is True and dt in (torch.bfloat16, torch.float16)
            )
            phase = fu == "phase" and size_ok
            if phase:
                kt = hwio(k2[:, :cin])
                z = fused_upsample_conv3x3_phase(trunk, kt, 4)
                z = _fix_border_ring_phase(z, trunk, kt, 4)
                z = z + space_to_phase(conv2_img_part(), 4) + b2
                x = prelu(instance_norm(z, dims=(1, 2, 3, 4)))
                x = x.reshape(B, h, w * 16, x.shape[-1])
            elif fuse_ok and size_ok:
                z = fused_upsample_conv3x3_dilated(trunk, hwio(k2[:, :cin]), 4)
                x = prelu(instance_norm(z + conv2_img_part() + b2))
            else:
                xu = interpolate_bilinear(trunk, (H, W), align_corners=False)
                x = _conv_cat([xu, img_feat], k2.to(dt), 1) + b2
                x = prelu(instance_norm(x))
            if dt in (torch.bfloat16, torch.float16):
                # score values in f32 under a low-precision trunk: a bf16
                # score map collapses to ~133 distinct values in a
                # 76k-candidate top-8192 (keypoint_det.py:613-649)
                z3 = _conv(x.float(), self.conv3.weight, self.conv3.bias)
            else:
                z3 = _conv(x, self.conv3.weight.to(dt), self.conv3.bias.to(dt))
            score = _act(instance_norm(z3), self.act)
            if phase:
                score = phase_to_space(score.reshape(B, h, w, 4, 4, self.out_channels))

        return (
            interpolate_bilinear(x_pf, (H, W), align_corners=False).mean(dim=-1, keepdim=True)
            * x_pi.mean(dim=-1, keepdim=True)
            * score
        )
