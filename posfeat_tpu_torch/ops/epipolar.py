"""Epipolar distances of the stage-2 reward (posfeat_tpu/ops/epipolar.py:35-57;
reference kploss.py:58-61). Pixel coordinates are (x, y); fundamental
matrices [B, 3, 3] map image-1 points to image-2 epipolar lines. f32 on
the card stays out of TF32 (``core/device.py``)."""

from __future__ import annotations

import torch

from .coords import homogenize


def epipolar_lines(fmatrix: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Epipolar lines of coord [B, k, 2] under fmatrix [B, 3, 3], scaled to
    unit normal: [B, k, 3]."""
    line = torch.matmul(fmatrix, homogenize(coord).transpose(1, 2))  # [B, 3, k]
    line = line / torch.linalg.vector_norm(line[:, :2], dim=1, keepdim=True).clamp_min(1e-8)
    return line.transpose(1, 2)


def epipolar_pairwise_dist(coord1: torch.Tensor, coord2: torch.Tensor,
                           fmatrix: torch.Tensor) -> torch.Tensor:
    """All-pairs point-to-epipolar-line distance: coord1 [B, m, 2], coord2
    [B, n, 2] -> [B, m, n], the distance of each coord2 point to the
    epipolar line of each coord1 point."""
    line = epipolar_lines(fmatrix, coord1)
    return torch.bmm(line, homogenize(coord2).transpose(1, 2)).abs()
