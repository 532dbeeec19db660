"""Handcrafted saliency priors on NHWC maps (posfeat_tpu/ops/priors.py;
reference preprocess_utils.py:522-596, networks/DeteNet.py:24-99)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pooling import avg_pool2d, pad2d


def ssim_prior(x: torch.Tensor, channel_mean: bool = False) -> torch.Tensor:
    """Self-dissimilarity via SSIM against the 1px-diagonal shift.
    [B, H, W, C] -> [B, H, W, C] (or [B, H, W, 1] with channel_mean)."""
    C1 = 0.01**2
    C2 = 0.03**2
    x_pad = pad2d(x.abs(), (0, 1, 0, 1), mode="reflect")
    x_lu = pad2d(x_pad[:, :-1, :-1, :], (1, 1, 1, 1), mode="reflect")
    x_rb = pad2d(x_pad[:, 1:, 1:, :], (1, 1, 1, 1), mode="reflect")

    m_lu = avg_pool2d(x_lu, 3, 1)
    m_rb = avg_pool2d(x_rb, 3, 1)
    sig_lu = avg_pool2d(x_lu**2, 3, 1) - m_lu**2
    sig_rb = avg_pool2d(x_rb**2, 3, 1) - m_rb**2
    sig_lu_rb = avg_pool2d(x_lu * x_rb, 3, 1) - m_lu * m_rb

    n = (2 * m_lu * m_rb + C1) * (2 * sig_lu_rb + C2)
    d = (m_lu**2 + m_rb**2 + C1) * (sig_lu + sig_rb + C2)
    out = torch.clamp((1 - n / d) / 2, 0, 1)
    if channel_mean:
        out = out.mean(dim=-1, keepdim=True)
    return out


def d2_prior(x: torch.Tensor) -> torch.Tensor:
    """D2-Net local-softmax × channel-ratio score. [B,H,W,C] -> [B,H,W,1]."""
    B = x.shape[0]
    x = F.relu(x)
    max_per_sample = x.reshape(B, -1).amax(dim=1).reshape(B, 1, 1, 1)
    e = torch.exp(x / max_per_sample)
    sum_exp = 9 * avg_pool2d(pad2d(e, (1,) * 4, mode="constant", value=1.0), 3, 1)
    local_max_score = e / sum_exp
    depth_score = x / x.amax(dim=-1, keepdim=True)
    return (local_max_score * depth_score).amax(dim=-1, keepdim=True)


def asl_peak_prior(x: torch.Tensor) -> torch.Tensor:
    """ASLFeat softplus peakiness. [B,H,W,C] -> [B,H,W,1]."""
    B = x.shape[0]
    max_per_sample = x.reshape(B, -1).amax(dim=1).reshape(B, 1, 1, 1)
    x = x / max_per_sample
    alpha = F.softplus(x - avg_pool2d(pad2d(x, (1,) * 4, mode="reflect"), 3, 1))
    beta = F.softplus(x - x.mean(dim=-1, keepdim=True))
    return (alpha * beta).amax(dim=-1, keepdim=True)


def identity_prior(x: torch.Tensor) -> torch.Tensor:
    """Constant-1 prior. [B,H,W,C] -> [B,H,W,1]."""
    return torch.ones_like(x[..., :1])


PRIORS = {
    "SSIM": ssim_prior,
    "D2": d2_prior,
    "ASL_Peak": asl_peak_prior,
    "identity": identity_prior,
}
