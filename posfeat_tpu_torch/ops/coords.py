"""Coordinate transforms between pixel indices and normalized [-1, 1] space.

Same convention as posfeat_tpu/ops/coords.py (reference
preprocess_utils.py:9-38,84-87): normalization is centered at
(size-1)/2, so pixel 0 maps to -1 and pixel (size-1) to +1, although
feature sampling uses align_corners=False. Coordinates are (x, y) pairs
in the trailing dimension.
"""

from __future__ import annotations

import torch


def homogenize(coord: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the trailing coordinate dim: [..., 2] -> [..., 3]."""
    return torch.cat([coord, torch.ones_like(coord[..., :1])], dim=-1)


def _center(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(
        [(w - 1) / 2.0, (h - 1) / 2.0], dtype=like.dtype, device=like.device
    )


def normalize_coords(coord: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel indices -> [-1, 1]. coord: [..., 2] (x, y)."""
    c = _center(h, w, coord)
    return (coord - c) / c


def denormalize_coords(coord_n: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[-1, 1] -> pixel indices. coord_n: [..., 2] (x, y)."""
    c = _center(h, w, coord_n)
    return coord_n * c + c


def gen_grid(
    h_min: float,
    h_max: float,
    w_min: float,
    w_max: float,
    len_h: int,
    len_w: int,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Row-major (x, y) coordinate grid, shape [len_h*len_w, 2]; entry
    r*len_w + c is (linspace_w[c], linspace_h[r])."""
    ys = torch.linspace(h_min, h_max, len_h, dtype=dtype, device=device)
    xs = torch.linspace(w_min, w_max, len_w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)
