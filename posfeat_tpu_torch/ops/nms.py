"""Exact and soft non-maximum suppression on NHWC score maps
(posfeat_tpu/ops/nms.py; reference preprocess_utils.py:431-464).

``nms`` keeps the reference's index tie-break: the map is reflect-padded
by the radius, and a pixel survives iff it is the argmax of its own
window, ties going to the first maximal element in row-major order of
the padded image. A plain ``score == window_max`` test differs exactly
on ties.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pooling import avg_pool2d, pad2d


def nms(score: torch.Tensor, patch_radius: int) -> torch.Tensor:
    """score: [B, H, W, 1] -> bool mask [B, H, W, 1]."""
    r = patch_radius
    B, H, W, C = score.shape
    assert C == 1
    sp = F.pad(score[..., 0][:, None], (r, r, r, r), mode="reflect")[:, 0]
    Hp, Wp = H + 2 * r, W + 2 * r
    # linear index of every padded position
    lin = torch.arange(Hp * Wp, dtype=torch.int32, device=score.device)
    return nms_window(sp, lin.reshape(1, Hp, Wp), r)[..., None]


def nms_window(sp: torch.Tensor, lin: torch.Tensor, r: int) -> torch.Tensor:
    """The NMS mask [B, h, w] of the padded window sp [B, h + 2r, w + 2r]
    whose positions carry the padded image's linear indices lin
    [1, h + 2r, w + 2r] (the tie-break)."""
    B = sp.shape[0]
    H, W = sp.shape[1] - 2 * r, sp.shape[2] - 2 * r
    best_val = torch.full((B, H, W), float("-inf"), dtype=sp.dtype, device=sp.device)
    best_idx = torch.full((B, H, W), torch.iinfo(torch.int32).max, dtype=torch.int32, device=sp.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            v = sp[:, dy : dy + H, dx : dx + W]
            li = lin[:, dy : dy + H, dx : dx + W]
            better = (v > best_val) | ((v == best_val) & (li < best_idx))
            best_val = torch.where(better, v, best_val)
            best_idx = torch.where(better, li, best_idx)
    return best_idx == lin[:, r : r + H, r : r + W]


def soft_nms(score: torch.Tensor, patch_radius: int) -> torch.Tensor:
    """softplus(score - local mean), gradient stopped. [B,H,W,1]."""
    window = 2 * patch_radius + 1
    s = score.detach()
    local_mean = avg_pool2d(pad2d(s, (patch_radius,) * 4, mode="reflect"), window, 1)
    return F.softplus(s - local_mean)
