"""Keypoint score head ("DeteNet"; posfeat_tpu/models/keypoint_det.py,
reference networks/DeteNet.py:5-120).

A handcrafted prior modulates [fine_map, image]; trunk convs run at
feature resolution and the score comes out at full image resolution.
InstanceNorm is non-affine; the PReLU slope is one shared parameter.

Two dataflows, chosen by ``fused_upsample`` as in the JAX package:

- ``False`` (and the default ``True``, "auto"): the reference dataflow,
  ×4 upsample + concat + conv2 at full resolution
  (keypoint_det.py:601-612). The JAX "auto" picks a composite dilated
  conv at bf16 that equals it up to rounding; that formulation is not
  ported.
- ``"pallas"``: the fused head of ``ops/fused_head.py``, whose two
  kernels run as CUDA on the card (keypoint_det.py:552-581). The config
  string stays so that existing configs mean the same thing.

``"always"`` and ``"phase"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import _upsample_axis_int, interpolate_bilinear


def instance_norm(x: torch.Tensor, eps: float = 1e-5, dims=(1, 2)) -> torch.Tensor:
    """Non-affine InstanceNorm over the spatial dims of NHWC, biased
    variance; statistics in f32 whatever the compute dtype."""
    xf = x.float()
    n = 1
    for d in dims:
        n *= x.shape[d]
    s1 = xf.sum(dim=dims, keepdim=True)
    s2 = (xf * xf).sum(dim=dims, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _bilinear_taps_1d(k: int):
    """1-D bilinear ×k kernel in transposed-conv form: returns (offsets,
    values) with u[m] = weight of x[j] in output o = k*j + m."""
    taps = {}
    for r in range(k):
        off = (r + 0.5) / k - 0.5
        i0 = int(np.floor(off))
        w1 = off - i0
        taps[r - k * i0] = taps.get(r - k * i0, 0.0) + (1.0 - w1)
        taps[r - k * (i0 + 1)] = taps.get(r - k * (i0 + 1), 0.0) + w1
    ms = sorted(taps)
    return ms, [taps[m] for m in ms]


def _phase_mix_matrix(k: int):
    """Constant M[r, d, d'] of the phase decomposition of
    conv3x3 ∘ bilinear_upsample_×k: output phase r at trunk cell q is
    Σ_{d,d'} M[r,d,d']·K[d']·tp[q + d] per axis, tp = edge-padded trunk.
    Returns (M [k, D, 3], D)."""
    ms, vals = _bilinear_taps_1d(k)
    lo, hi = ms[0], ms[-1]
    n_taps = hi - lo + 3  # composite support incl. the conv's ±1
    u_ext = np.zeros((n_taps + 2,), np.float32)
    for m, v in zip(ms, vals):
        u_ext[m - lo + 2] = v
    A = np.stack([u_ext[d : d + n_taps] for d in range(3)], axis=1)  # [t, d']
    pl = hi + 1 - k
    D = (n_taps + k - 1) // k
    M = np.zeros((k, D, 3), np.float32)
    for r in range(k):
        for d in range(D):
            t = n_taps - 1 - (k * d + pl - r)
            if 0 <= t < n_taps:
                M[r, d] = A[t]
    return M, D


def ring_correction_strips(trunk: torch.Tensor, kernel: torch.Tensor, k: int = 4):
    """Additive border-correction strips for the phase-conv composite
    (keypoint_det.py:299-350).

    The composite conv sees clamped upsample values where the reference
    conv2 zero-pads the upsampled map, so it differs from the reference
    exactly by the padded-tap contributions: on the top output row the
    excess is conv1d(edge strip, K[0]), and likewise for the other
    edges; each corner term is counted by both adjacent edges, so it is
    removed once from the row strips. trunk [B, h, w, Cin], kernel
    [3, 3, Cin, Cout] -> f32 (T, Bo) [B, k·w, Cout] and (L, R)
    [B, k·h, Cout]."""
    assert k == 4, "exact border fix derived for the head's x4 case"
    B, h, w, Cin = trunk.shape
    K = kernel.float()
    t32 = trunk.float()
    top_src = _upsample_axis_int(t32[:, 0:1], k, 2)[:, 0]
    bot_src = _upsample_axis_int(t32[:, h - 1 : h], k, 2)[:, 0]
    left_src = _upsample_axis_int(t32[:, :, 0:1], k, 1)[:, :, 0]
    right_src = _upsample_axis_int(t32[:, :, w - 1 : w], k, 1)[:, :, 0]

    def conv1d_edge(strip, k1d):
        # strip [B, L, Cin], k1d [3, Cin, Cout]; edge 'same' padding: the
        # out-of-range taps of the virtual upsampled map clamp to corners
        L = strip.shape[1]
        sp = torch.cat([strip[:, :1], strip, strip[:, -1:]], dim=1)
        return sum(sp[:, t : t + L] @ k1d[t] for t in range(3))

    T = conv1d_edge(top_src, K[0])
    Bo = conv1d_edge(bot_src, K[2])
    L = conv1d_edge(left_src, K[:, 0])
    R = conv1d_edge(right_src, K[:, 2])
    # corner double-counts (row and column strips both include them)
    T[:, 0] -= t32[:, 0, 0] @ K[0, 0]
    T[:, -1] -= t32[:, 0, w - 1] @ K[0, 2]
    Bo[:, 0] -= t32[:, h - 1, 0] @ K[2, 0]
    Bo[:, -1] -= t32[:, h - 1, w - 1] @ K[2, 2]
    return T, Bo, L, R


def _conv(x: torch.Tensor, weight: torch.Tensor, bias=None, padding: int = 0):
    """NHWC conv with a torch [out, in, kh, kw] kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding)
    return y.permute(0, 2, 3, 1)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "Sigmoid":
        return torch.sigmoid(x)
    if act == "Softplus":
        return F.softplus(x)
    raise ValueError(f"unknown act {act}")


class KeypointDet(nn.Module):
    """Keypoint score head. Parameter names are the reference's
    (conv1, conv2, conv3, convimg, relu), so reference
    ``localheader.pth`` files load as they are. Parameters stay f32;
    the forward casts to ``dtype`` where the JAX head does."""

    def __init__(self, in_channels: int, out_channels: int = 1, prior: str = "SSIM",
                 act: str = "Sigmoid", fused_upsample=True, dtype=torch.float32):
        super().__init__()
        if fused_upsample in ("always", "phase"):
            raise NotImplementedError(
                f"fused_upsample={fused_upsample!r} is not ported; see ROADMAP.md "
                "queue 1, item 4 (the 'pallas' head and the reference dataflow are)"
            )
        if prior not in ("SSIM", "D2", "ASL_Peak", "identity"):
            raise ValueError(f"unknown prior {prior}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.prior = prior
        self.act = act
        self.fused_upsample = fused_upsample
        self.dtype = dtype
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

    def forward(self, fine_map: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """fine_map [B, h, w, C_in], img [B, H, W, 3] -> score [B, H, W, out]."""
        dt = self.dtype
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
        y_img = _conv(s_img, self.convimg.weight.to(dt), None, 1) + self.convimg.bias.to(dt)

        H, W = img.shape[1:3]
        h, w = trunk.shape[1:3]
        k2 = self.conv2.weight  # [128, C_in + 64, 3, 3]
        if self.fused_upsample == "pallas" and H == 4 * h and W == 4 * w:
            from ..ops.fused_head import fused_head_tail

            hwio = lambda t: t.permute(2, 3, 1, 0)
            score = fused_head_tail(
                trunk, s_img, y_img, hwio(self.convimg.weight), self.convimg.bias,
                hwio(k2[:, : self.in_channels]), hwio(k2[:, self.in_channels :]),
                self.conv2.bias, hwio(self.conv3.weight), self.conv3.bias, a,
                act=self.act,
            )
        else:
            img_feat = instance_norm(y_img.float()).to(dt)
            xu = interpolate_bilinear(trunk, (H, W), align_corners=False)
            xcat = torch.cat([xu, img_feat], dim=-1)
            x = _conv(xcat, k2.to(dt), None, 1) + self.conv2.bias.to(dt)
            x = prelu(instance_norm(x))
            if dt in (torch.bfloat16, torch.float16):
                # score values in f32 under a low-precision trunk: a bf16
                # score map collapses to ~133 distinct values in a
                # 76k-candidate top-8192 (keypoint_det.py:613-649)
                z3 = _conv(x.float(), self.conv3.weight, self.conv3.bias)
            else:
                z3 = _conv(x, self.conv3.weight.to(dt), self.conv3.bias.to(dt))
            score = _act(instance_norm(z3), self.act)

        return (
            interpolate_bilinear(x_pf, (H, W), align_corners=False).mean(dim=-1, keepdim=True)
            * x_pi.mean(dim=-1, keepdim=True)
            * score
        )
