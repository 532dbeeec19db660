"""The one generator of every traffic mix: what a mix's file
(``traffic/<name>.json``) asks for, made on the device from the seed.
Every seed gets the same sizes; only the values differ."""

from __future__ import annotations


import torch
import torch.nn.functional as F

from .reference.extraction import normalize_image


def textures(gen: torch.Generator, n: int, H: int, W: int, device) -> torch.Tensor:
    """n uint8 NHWC images [n, H, W, 3]: four octaves of smooth noise
    (periods of about 32, 8, 2 and 1 pixels) with correlated colour
    channels, mapped to 0..255."""
    out = torch.zeros((n, 3, H, W), device=device)
    for step, weight in ((32, 0.55), (8, 0.3), (2, 0.12), (1, 0.05)):
        h, w = max(1, H // step), max(1, W // step)
        base = torch.randn((n, 1, h, w), generator=gen, device=device)
        colour = torch.randn((n, 3, h, w), generator=gen, device=device)
        layer = 0.8 * base + 0.45 * colour
        if (h, w) != (H, W):
            layer = F.interpolate(layer, size=(H, W), mode="bilinear", align_corners=False)
        out += weight * layer
    return (128.0 + 70.0 * out).clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _skew(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    x, y, zz = t[..., 0], t[..., 1], t[..., 2]
    return torch.stack([torch.stack([z, -zz, y], -1), torch.stack([zz, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def fundamental(gen: torch.Generator, n: int, H: int, W: int, max_angle: float, device):
    """(F1, F2) [n, 3, 3] f32 of random relative poses: a rotation of up
    to ``max_angle`` radians about a random axis, a random unit
    translation, intrinsics of focal length 0.8·W at the image centre.
    F1 maps image-1 points to image-2 lines, F2 = F1ᵀ; each of unit
    Frobenius norm."""
    d = torch.float64
    axis = torch.randn((n, 3), generator=gen, device=device).to(d)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    angle = max_angle * torch.rand((n, 1, 1), generator=gen, device=device).to(d)
    k = _skew(axis)
    eye = torch.eye(3, dtype=d, device=device).expand(n, 3, 3)
    R = eye + torch.sin(angle) * k + (1 - torch.cos(angle)) * (k @ k)
    t = torch.randn((n, 3), generator=gen, device=device).to(d)
    t = t / t.norm(dim=-1, keepdim=True)
    f = 0.8 * W
    K = torch.tensor([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], dtype=d, device=device)
    Kinv = torch.linalg.inv(K)
    F1 = Kinv.T @ _skew(t) @ R @ Kinv
    F1 = F1 / F1.flatten(1).norm(dim=-1)[:, None, None]
    return F1.float(), F1.transpose(1, 2).contiguous().float()


def pair_batches(gen, n_batches: int, batch: int, H: int, W: int, max_angle: float, device) -> list:
    """Training batches of image pairs: dicts of im1, im2 [B, H, W, 3]
    normalized, F1, F2 [B, 3, 3]; every pair distinct."""
    out = []
    for _ in range(n_batches):
        ims = textures(gen, 2 * batch, H, W, device)
        F1, F2 = fundamental(gen, batch, H, W, max_angle, device)
        out.append({"im1": normalize_image(ims[:batch]), "im2": normalize_image(ims[batch:]), "F1": F1, "F2": F2})
    return out


def cell_draws(gen, batch: int, H: int, W: int, grid: int, accept_p: float, device):
    """One Categorical pixel per grid cell (uniform over its grid² pixels,
    int64) and its Bernoulli accept (probability ``accept_p``), for both
    images of each pair: ((proposals1, accept1), (proposals2, accept2)),
    each [B, H/grid, W/grid]."""
    hg, wg = H // grid, W // grid
    out = []
    for _ in range(2):
        prop = torch.randint(0, grid * grid, (batch, hg, wg), generator=gen, device=device)
        acc = torch.rand((batch, hg, wg), generator=gen, device=device) < accept_p
        out.append((prop, acc))
    return tuple(out)


def priority(seed: int, index: int) -> int:
    """A fixed pseudo-random rank of item ``index`` under ``seed``
    (splitmix64): the check's sample is the items of least rank."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


