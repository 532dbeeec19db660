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


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, size[0], size[1], C]."""
    out_h, out_w = int(size[0]), int(size[1])
    if (out_h, out_w) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)
