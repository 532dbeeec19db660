"""Inference keypoint detector: NMS + threshold + 3×3 coordinate
refinement + exact top-k (posfeat_tpu/ops/detect.py:217-429; reference
preprocess_utils.py:215-278).

Like the JAX package, the detector returns a fixed ``num_pts`` slate plus
a per-image ``valid_count``; the extractor trims on the host to the
reference's dynamic count max(min(num_pts, valid_count), 128). Selection
order is exact: top-k of the masked score map, ties to the lower flat
index (a stable descending sort, which ``torch.topk`` does not promise).

This slice ports the reference-parity path: stable selection, 'avg3'
refinement. The other refiners ('quad', 'quad5', 'soft', 'soft5'),
Gumbel sampling and the other detectors are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from .coords import gen_grid
from .nms import nms, soft_nms
from .pooling import avg_pool2d, max_pool2d


def top_k(x: torch.Tensor, k: int):
    """Row-wise exact top-k of [B, n]; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _thr_mask(interior: torch.Tensor, thr, thr_mod: str) -> torch.Tensor:
    """interior: [B, h', w', 1] -> bool mask (putils:232-240)."""
    B = interior.shape[0]
    flat = interior.reshape(B, -1)
    if thr_mod == "max":
        kp_thr = flat.amax(dim=1)
    elif thr_mod == "mean":
        kp_thr = flat.mean(dim=1)
    elif thr_mod == "abs":
        kp_thr = torch.ones((B,), dtype=interior.dtype, device=interior.device)
    else:
        raise ValueError(f"unknown thr_mod {thr_mod}")
    return interior > thr * kp_thr.reshape(B, 1, 1, 1)


def generate_kpts_single(
    kp_map: torch.Tensor,
    *,
    num_pts: int,
    nms_radius: int,
    use_nms=True,
    thr=False,
    thr_mod: str = "mean",
    stable: bool = True,
    refine: str = "avg3",
):
    """kp_map: [B, H, W, 1] full-res score map -> (kps_n [B, num_pts, 2]
    normalized, scores [B, num_pts, 1], valid_count [B] int32)."""
    if not stable:
        raise NotImplementedError(
            "Gumbel sampling (stable=False) is a training path; see ROADMAP.md: "
            "sub-pixel refiners"
        )
    if refine != "avg3":
        raise NotImplementedError(
            f"refine={refine!r} is not ported yet; see ROADMAP.md: sub-pixel refiners"
        )
    B, H, W, _ = kp_map.shape
    interior = kp_map[:, 1:-1, 1:-1, :]  # [B, H-2, W-2, 1]

    if use_nms == "softnms":
        nms_mask = soft_nms(interior, nms_radius)
        count_src = None  # counted from the threshold mask below
    elif use_nms:
        nms_mask = nms(interior, nms_radius).to(kp_map.dtype)
        count_src = nms_mask
    else:
        nms_mask = torch.ones_like(interior)
        count_src = nms_mask

    if thr:
        tmask = _thr_mask(interior, thr, thr_mod).to(kp_map.dtype)
        nms_mask = tmask * nms_mask
        count_src = tmask if use_nms == "softnms" else nms_mask
    if count_src is None:
        raise ValueError("use_nms='softnms' needs a threshold to count valid points")

    # 3×3 score-weighted coordinate refinement (putils:242-247)
    grids_org = gen_grid(-1, 1, -1, 1, H, W, dtype=kp_map.dtype,
                         device=kp_map.device).reshape(1, H, W, 2)
    grids = avg_pool2d(kp_map * grids_org, 3) / avg_pool2d(kp_map, 3)
    kp_score_map = max_pool2d(kp_map, 3)

    valid_count = count_src.reshape(B, -1).sum(dim=1).to(torch.int32)

    masked = (nms_mask * interior).reshape(B, -1)
    h2, w2 = H - 2, W - 2
    fold = min(nms_radius + 1, 4) if (use_nms is True and nms_radius >= 1) else 0
    if fold > 1:
        # NMS winners are pairwise > nms_radius apart (Chebyshev), so a
        # fold×fold block holds at most one: reducing each block to its
        # max before the top-k is exact and shrinks the sort fold²×
        hp = -(-h2 // fold) * fold
        wp = -(-w2 // fold) * fold
        mm = torch.nn.functional.pad(masked.reshape(B, h2, w2), (0, wp - w2, 0, hp - h2))
        blocks = mm.reshape(B, hp // fold, fold, wp // fold, fold)
        blocks = blocks.permute(0, 1, 3, 2, 4).reshape(
            B, (hp // fold) * (wp // fold), fold * fold
        )
        bmax, barg = blocks.max(dim=-1)  # first maximal element on ties
        k = min(num_pts, bmax.shape[1])
        _, bidx = top_k(bmax, k)
        inner = torch.gather(barg, 1, bidx)
        by = bidx // (wp // fold)
        bx = bidx % (wp // fold)
        yy = by * fold + inner // fold
        xx = bx * fold + inner % fold
        # zero-score pad blocks may decode past the interior; their slots
        # lie beyond valid_count and are trimmed on the host
        idx = torch.clamp(yy * w2 + xx, 0, h2 * w2 - 1)
    else:
        k = min(num_pts, masked.shape[1])
        _, idx = top_k(masked, k)
    kps = torch.gather(grids.reshape(B, -1, 2), 1, idx[..., None].expand(-1, -1, 2))
    kp_score = torch.gather(kp_score_map.reshape(B, -1, 1), 1, idx[..., None])
    if k < num_pts:
        pad = num_pts - k
        kps = torch.nn.functional.pad(kps, (0, 0, 0, pad))
        kp_score = torch.nn.functional.pad(kp_score, (0, 0, 0, pad))
    return kps, kp_score, valid_count


DETECTORS = {"generate_kpts_single": generate_kpts_single}
