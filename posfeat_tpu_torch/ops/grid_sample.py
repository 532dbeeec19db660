"""Bilinear feature sampling at normalized coordinates (NHWC)
(posfeat_tpu/ops/grid_sample.py; reference preprocess_utils.py:40-53,
673, 737).

torch's own ``F.grid_sample`` (align_corners=False) is the reference
semantics; this is no Pallas kernel, so it is used as it is.

``impl`` is the JAX package's POSFEAT_SAMPLE_IMPL (grid_sample.py:74-217,
253-284): "pair" and "quad" gather a bilinear footprint's corners in
fewer rows on the TPU. "quad" sums the same four weighted corners in the
same order as the corner formula, so it runs ``F.grid_sample`` here;
"pair" lerps in x first, then in y, which rounds differently, so it runs
that factored lerp (``_pair_lerp``). On the card neither has a per-row
gather cost to save.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) parity: denominator clamped at eps."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


SAMPLE_IMPLS = ("corner", "pair", "quad")


def _pair_lerp(image: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """JAX ``_sample_one_pair``'s arithmetic, zeros padding: image
    [B, H, W, C], pts [B, N, 2] normalized -> [B, N, C] at the image's
    dtype. Per row of the footprint, v(x0)·wx0 + v(x0+1)·wx1, then
    top·wy0 + bottom·wy1; a corner outside the map weighs 0."""
    B, H, W, C = image.shape
    ix = ((pts[..., 0].float() + 1.0) * W - 1.0) / 2.0
    iy = ((pts[..., 1].float() + 1.0) * H - 1.0) / 2.0
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    xi, yi = x0.long(), y0.long()
    flat = image.reshape(B, H * W, C)
    dt = image.dtype

    def tap(y, x):
        i = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
        return torch.gather(flat, 1, i[..., None].expand(-1, -1, C))

    def row(y):
        vy = (y >= 0) & (y < H)
        w0 = torch.where(vy & (xi >= 0) & (xi < W), wx0, 0.0).to(dt)[..., None]
        w1 = torch.where(vy & (xi + 1 >= 0) & (xi + 1 < W), wx1, 0.0).to(dt)[..., None]
        return tap(y, xi) * w0 + tap(y, xi + 1) * w1

    return row(yi) * wy0.to(dt)[..., None] + row(yi + 1) * wy1.to(dt)[..., None]


def grid_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                impl: str = "corner") -> torch.Tensor:
    """Sample image [B, H, W, C] at grid [B, ..., 2] -> [B, ..., C]: grid
    holds normalized (x, y), align_corners=False, padding ``zeros`` or
    ``border`` (posfeat_tpu/ops/grid_sample.py:218); ``impl`` "corner",
    or "pair" / "quad" with zeros padding (module docstring)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    if impl not in SAMPLE_IMPLS:
        raise ValueError(f"unknown sample_impl {impl!r}; expected one of {SAMPLE_IMPLS}")
    if impl != "corner" and padding_mode != "zeros":
        raise ValueError(f"sample_impl {impl!r} implements zeros padding only")
    B, C = image.shape[0], image.shape[-1]
    lead = grid.shape[1:-1]
    if impl == "pair":
        out = _pair_lerp(image, grid.reshape(B, -1, 2))
        return out.reshape((B,) + tuple(lead) + (C,))
    out = F.grid_sample(
        image.permute(0, 3, 1, 2), grid.reshape(B, 1, -1, 2), mode="bilinear",
        padding_mode=padding_mode, align_corners=False,
    )  # [B, C, 1, M]
    return out[:, :, 0].transpose(1, 2).reshape((B,) + tuple(lead) + (C,))


def sample_feat_by_coord(x: torch.Tensor, coord_n: torch.Tensor,
                         norm: bool = False, impl: str = "corner") -> torch.Tensor:
    """Descriptors at normalized points: x [B, H, W, C], coord_n
    [B, N, 2] -> [B, N, C], L2-normalized over channels when ``norm``;
    ``impl`` as ``grid_sample``'s.

    A low-precision map is sampled in f32 (corner values widened, lerp
    and normalization in f32), as the JAX default POSFEAT_SAMPLE_F32=1
    does; the slate then leaves here f32."""
    feat = grid_sample(x.float(), coord_n.float(), impl=impl)
    return l2_normalize(feat) if norm else feat
