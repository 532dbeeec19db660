"""Bilinear feature sampling at normalized coordinates (NHWC)
(posfeat_tpu/ops/grid_sample.py; reference preprocess_utils.py:40-53).

torch's own ``F.grid_sample`` (align_corners=False) is the reference
semantics; this is no Pallas kernel, so it is used as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) parity: denominator clamped at eps."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def sample_feat_by_coord(x: torch.Tensor, coord_n: torch.Tensor,
                         norm: bool = False) -> torch.Tensor:
    """Descriptors at normalized points: x [B, H, W, C], coord_n
    [B, N, 2] -> [B, N, C], L2-normalized over channels when ``norm``.

    A low-precision map is sampled in f32 (corner values widened, lerp
    and normalization in f32), as the JAX default POSFEAT_SAMPLE_F32=1
    does; the slate then leaves here f32."""
    out = F.grid_sample(
        x.float().permute(0, 3, 1, 2), coord_n.float()[:, None], mode="bilinear",
        padding_mode="zeros", align_corners=False,
    )  # [B, C, 1, N]
    feat = out[:, :, 0].transpose(1, 2)
    return l2_normalize(feat) if norm else feat
