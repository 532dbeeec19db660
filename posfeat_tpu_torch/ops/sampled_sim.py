"""Sample-and-dot similarity without materializing the samples
(posfeat_tpu/ops/sampled_sim.py:57):

    sim[b, n, s] = ⟨bilinear_sample(featmap[b], pos[b, n, s]), feat1[b, n]⟩.

Bilinear interpolation is linear, so it commutes with the channel
contraction: the map featmap·f1 is one matmul per chunk of points, and
the samples are scalars instead of D-vectors. The per-chunk map is
[B, chunk, H, W] f32.
"""

from __future__ import annotations

import torch


def _sample_scalar_maps(pf: torch.Tensor, pos: torch.Tensor, padding: str) -> torch.Tensor:
    """pf [M, H, W], pos [M, S, 2] normalized -> [M, S] bilinear values."""
    M, H, W = pf.shape
    x = ((pos[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((pos[..., 1] + 1.0) * H - 1.0) / 2.0
    if padding == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    pf_flat = pf.reshape(M, H * W)

    def corner(xc, yc, w):
        xi, yi = xc.long(), yc.long()
        if padding == "zeros":
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = torch.where(inb, w, torch.zeros_like(w))
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return torch.gather(pf_flat, 1, idx) * w

    return (
        corner(x0, y0, (1 - wx1) * (1 - wy1))
        + corner(x0 + 1, y0, wx1 * (1 - wy1))
        + corner(x0, y0 + 1, (1 - wx1) * wy1)
        + corner(x0 + 1, y0 + 1, wx1 * wy1)
    )


def sampled_similarity(featmap: torch.Tensor, feat1: torch.Tensor, pos: torch.Tensor,
                       padding: str = "zeros", chunk: int = 256) -> torch.Tensor:
    """featmap [B, H, W, D], feat1 [B, N, D], pos [B, N, S, 2] normalized
    (x, y), align_corners=False -> sim [B, N, S] f32; bf16 operands are
    widened before the product (sampled_sim.py:84-90)."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"unsupported padding {padding!r}")
    B, H, W, D = featmap.shape
    S = pos.shape[2]
    fm_t = featmap.reshape(B, H * W, D).transpose(1, 2).float()
    feat1 = feat1.float()
    sims = []
    for s in range(0, feat1.shape[1], chunk):
        pf = torch.bmm(feat1[:, s:s + chunk], fm_t)  # [B, c, H·W]
        c = pf.shape[1]
        sims.append(_sample_scalar_maps(pf.reshape(B * c, H, W),
                                        pos[:, s:s + chunk].reshape(B * c, S, 2).float(),
                                        padding).reshape(B, c, S))
    return torch.cat(sims, 1)
