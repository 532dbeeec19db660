"""Bilinear resize with torch ``F.interpolate`` semantics on NHWC maps
(posfeat_tpu/ops/resize.py). The reference mixes align_corners=True
(decoder, DescNet.py:189) and False (head, DeteNet.py:109)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _phase_taps(k: int):
    """Fixed 2-tap filter phases for integer ×k align_corners=False
    upsampling: output i = k*j + r samples source j + (r+0.5)/k - 0.5."""
    taps = []
    for r in range(k):
        off = (r + 0.5) / k - 0.5
        i0 = int(np.floor(off))
        w1 = off - i0
        taps.append((i0, float(np.float32(1.0 - w1)), float(np.float32(w1))))
    return taps


def _upsample_axis_int(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Exact bilinear ×k along one spatial axis by phase decomposition:
    per output phase, a 2-tap weighted sum of edge-clamped shifted
    inputs (both taps clamp to the edge pixel at the borders, as torch's
    source-index clamping does)."""
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)
    phases = []
    for i0, w0, w1 in _phase_taps(k):
        a = xp.narrow(axis, 1 + i0, n)
        b = xp.narrow(axis, 2 + i0, n)
        phases.append(a * w0 + b * w1)
    y = torch.stack(phases, dim=axis + 1)  # [..., n, k, ...]
    new_shape = list(x.shape)
    new_shape[axis] = n * k
    return y.reshape(new_shape)


# output elements of one F.interpolate call: the card's channels-last
# bilinear kernel refuses 2^31 (the reference head's x4 resize of a
# 192-channel trunk reaches that near 11 Mpx); larger resizes by a
# power-of-two row factor run in row blocks below it
BLOCK_ELEMENTS = 2**30


def _row_blocks(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate`` (bilinear, align_corners=False) of NCHW ``x`` to
    (out_h, out_w) = (f·h, out_w), f a power of two, in blocks of source
    rows, each with one source row of halo above and below (none beyond
    the map's edges, where the kernel's own clamp acts). Output row o
    reads source (o + 0.5)/f − 0.5, exact in f32 and the same in the
    block's coordinates shifted by its first row, so every block is bit
    for bit the whole call's rows."""
    B, C, h, _ = x.shape
    f = out_h // h
    rows = max(1, BLOCK_ELEMENTS // (B * C * f * out_w) - 2)
    parts = []
    for a in range(0, h, rows):
        b = min(a + rows, h)
        top, bottom = int(a > 0), int(b < h)
        e = x[:, :, a - top : b + bottom]
        y = F.interpolate(e, size=(f * e.shape[2], out_w), mode="bilinear", align_corners=False)
        parts.append(y[:, :, f * top : f * (top + b - a)])
    return torch.cat(parts, dim=2)


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, size[0], size[1], C]. A resize above
    ``BLOCK_ELEMENTS`` output elements by a power-of-two row factor with
    align_corners=False runs in row blocks, bit for bit the one call."""
    out_h, out_w = int(size[0]), int(size[1])
    if (out_h, out_w) == tuple(x.shape[1:3]):
        return x
    B, h, _, C = x.shape
    f, rem = divmod(out_h, h)
    if not align_corners and not rem and f & (f - 1) == 0 and B * out_h * out_w * C > BLOCK_ELEMENTS:
        y = _row_blocks(x.permute(0, 3, 1, 2), out_h, out_w)
    else:
        y = F.interpolate(
            x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
            align_corners=align_corners,
        )
    return y.permute(0, 2, 3, 1)
