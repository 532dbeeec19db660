"""Bilinear feature sampling at normalized coordinates (NHWC)
(posfeat_tpu/ops/grid_sample.py; reference preprocess_utils.py:40-53,
673, 737).

torch's own ``F.grid_sample`` (align_corners=False) is the reference
semantics; this is no Pallas kernel, so it is used as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) parity: denominator clamped at eps."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """Sample image [B, H, W, C] at grid [B, ..., 2] -> [B, ..., C]: grid
    holds normalized (x, y), align_corners=False, padding ``zeros`` or
    ``border`` (posfeat_tpu/ops/grid_sample.py:218, its corner impl)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    B, C = image.shape[0], image.shape[-1]
    lead = grid.shape[1:-1]
    out = F.grid_sample(
        image.permute(0, 3, 1, 2), grid.reshape(B, 1, -1, 2), mode="bilinear",
        padding_mode=padding_mode, align_corners=False,
    )  # [B, C, 1, M]
    return out[:, :, 0].transpose(1, 2).reshape((B,) + tuple(lead) + (C,))


def sample_feat_by_coord(x: torch.Tensor, coord_n: torch.Tensor,
                         norm: bool = False) -> torch.Tensor:
    """Descriptors at normalized points: x [B, H, W, C], coord_n
    [B, N, 2] -> [B, N, C], L2-normalized over channels when ``norm``.

    A low-precision map is sampled in f32 (corner values widened, lerp
    and normalization in f32), as the JAX default POSFEAT_SAMPLE_F32=1
    does; the slate then leaves here f32."""
    feat = grid_sample(x.float(), coord_n.float())
    return l2_normalize(feat) if norm else feat
