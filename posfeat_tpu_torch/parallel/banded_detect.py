"""The extraction detectors and ``sample_feat_by_coord`` on row bands of
the score map and the local map (posfeat_tpu/ops/detect.py:217-547 and
ops/grid_sample.py:253 under the JAX spatial program).

``generate_kpts_single`` with stable top-k at stride 1, the shipped
configs' detector, runs on the bands. Its slate is the unsharded slate:
the same points in the same order wherever the scores are bitwise equal.
Band i owns the interior rows (image rows 1 .. H−2) of its own image
rows. Its NMS window reads the neighbours' rows, reflect-padded at the
interior's edges, with the padded map's global linear indices as the
tie-break. The fold blocks start at interior row 0, so a block can
straddle a band edge: each band reduces the blocks whose first row it
owns, reading up to fold − 1 rows below. Each band's top-k (ties to the
lower index) then merges on the first device by a stable sort of the
scores in band order, which breaks ties by the global block index as the
unsharded sort does. The slate's coordinates and scores are read on the
band that owns each point's row.

``topk="approx"`` (the JAX package's POSFEAT_TOPK=approx) with NMS at a
radius of 1 or more takes the unsharded packed top-k: each band packs
its blocks' argmax into the 4 low bits of their f32 maxima and ranks the
packed words; the merge sorts the words; the selected words give the
inner offset and, with those bits cleared, the score. The owning band
then gathers the refined grids only. Elsewhere "approx" selects as
"exact", as the unsharded detector does.

The other configurations (``generate_kpts_single_noavg``,
``generate_kpts_regular_grid_single``, a stride above 1, Gumbel
selection) run the unsharded port detector on the score map gathered on
the first device: one channel, 1/128 of the 128-channel local map that
banding spreads, so their slate is the unsharded one by construction;
they take ``topk`` as their unsharded forms do.

``sample_feat_by_coord`` runs the unsharded sampler, with its ``impl``,
on the local map gathered on the first device (128 channels at H/4: on
a 3024x4032 frame 9.75e7 elements, where the head's phase-layout maps
that stay banded hold 16 times as many).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.detect import (
    DETECTORS,
    REFINERS,
    _check_topk,
    _offset_grids,
    _pad_slate,
    _quad5_offsets,
    quad_refine_offsets,
    softargmax3_offsets,
    top_k,
)
from ..ops import grid_sample
from ..ops.nms import nms_window
from ..ops.pooling import avg_pool2d, max_pool2d
from .banded_ops import Bands, global_max, global_sum

# the detectors that read ``stable`` (generate_kpts_single_noavg takes it
# for the configs' sake and always selects by top-k)
_DRAWING = ("generate_kpts_single", "generate_kpts_regular_grid_single")


def check_detector(name: str, cfg: Dict, draws: bool = False) -> None:
    """Raises, before any work, for a detector configuration that cannot
    run: an unknown detector or refiner, soft-NMS without a threshold,
    and random selection (``stable: False``) without ``draws`` (a
    generator or the noise): the Extractor has none, as JAX's extractor
    has no PRNG key."""
    if name not in DETECTORS:
        raise ValueError(f"unknown detector {name!r}; expected one of {sorted(DETECTORS)}")
    if name in _DRAWING and not cfg.get("stable", True) and not draws:
        raise ValueError(f"{name} with stable: False selects at random and needs a generator or the noise; "
                         "the Extractor has none, as JAX's extractor has no PRNG key")
    refine = cfg.get("refine", "avg3")
    if refine not in REFINERS:
        raise ValueError(f"unknown refine {refine!r}; expected one of {REFINERS}")
    if (name != "generate_kpts_regular_grid_single" and cfg.get("use_nms", True) == "softnms"
            and not cfg.get("thr", False)):
        raise ValueError("use_nms='softnms' needs a threshold to count valid points")


def _interior_rows(kp: Bands, i: int, lo: int, hi: int):
    """Interior rows lo .. hi (image rows + 1) on band i, reflect-padded
    at the interior's edges, columns 1 .. W − 2: [B, hi − lo, W − 2]."""
    h2 = kp.total - 2
    rows = [(-q if q < 0 else 2 * (h2 - 1) - q if q >= h2 else q) + 1 for q in range(lo, hi)]
    return kp.gather(i, rows)[:, :, 1:-1, 0]


def _grids(kp: Bands, i: int, q0: int, q1: int, refine: str, temperature: float) -> torch.Tensor:
    """``refined_grids`` at stride 1 for interior rows q0 .. q1 of band i:
    [B, q1 − q0, W − 2, 2]."""
    H, W = kp.total, kp.parts[0].shape[2]
    n = q1 - q0
    dt, dev = kp.parts[i].dtype, kp.parts[i].device
    clamp = lambda lo, hi: [min(max(r, 0), H - 1) for r in range(lo, hi)]
    if refine == "avg3":
        win = kp.gather(i, range(q0, q1 + 2))
        ys = torch.linspace(-1, 1, H, dtype=dt, device=dev)[q0 : q1 + 2]
        xs = torch.linspace(-1, 1, W, dtype=dt, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grids_org = torch.stack([gx, gy], dim=-1)[None]
        return avg_pool2d(win * grids_org, 3, 1) / avg_pool2d(win, 3, 1)
    if refine == "quad":
        off = quad_refine_offsets(kp.gather(i, range(q0, q1 + 2)))[:, 1:-1, 1:-1]
    elif refine == "quad5":
        off = _quad5_offsets(kp.gather(i, clamp(q0 - 1, q1 + 3)))[:, 2 : 2 + n, 1:-1]
    else:
        r = 2 if refine == "soft5" else 1
        win = kp.gather(i, clamp(q0 + 1 - r, q1 + 1 + r))
        off = softargmax3_offsets(win, temperature, 2 * r + 1)[:, r : r + n, 1:-1]
    return _offset_grids(off, H, W, dt, row0=q0)


def detect(kp_map: Bands, detector: str = "generate_kpts_single", *, generator: torch.Generator = None,
           noise: torch.Tensor = None, topk: str = "exact", **cfg):
    """``DETECTORS[detector]`` on bands of the score map [B, rows, W, 1]
    -> (kps_n [B, num_pts, 2], scores [B, num_pts, 1], valid_count [B]
    int32) on the first band's device. ``generator`` (or, for
    ``generate_kpts_single``, ``noise``) feeds ``stable: False`` as the
    unsharded detector takes them; ``topk`` is "exact" or "approx", as
    the unsharded detectors take it."""
    _check_topk(topk)
    check_detector(detector, cfg, generator is not None or noise is not None)
    if detector == "generate_kpts_single" and cfg.get("stable", True) and cfg.get("stride", 1) == 1:
        return _single(kp_map, topk=topk, **cfg)
    extra = {"generator": generator} if generator is not None else {}
    if noise is not None:
        extra["noise"] = noise
    return DETECTORS[detector](kp_map.concat(), topk=topk, **cfg, **extra)


def _single(kp_map: Bands, *, num_pts: int, nms_radius: int, use_nms=True, thr=False, thr_mod: str = "mean",
            stable: bool = True, temperature: float = 1.0, stride: int = 1, refine: str = "avg3",
            refine_temperature: float = 20.0, topk: str = "exact"):
    """``generate_kpts_single`` with stable top-k at stride 1 on the bands
    (``temperature`` belongs to the Gumbel selection and is not read)."""
    H, W = kp_map.total, kp_map.parts[0].shape[2]
    B = kp_map.parts[0].shape[0]
    h2, w2 = H - 2, W - 2
    dev0, dt = kp_map.parts[0].device, kp_map.parts[0].dtype
    r = nms_radius
    own = [(max(a - 1, 0), min(b - 1, h2)) for a, b in zip(kp_map.starts, kp_map.stops)]

    # the threshold's reference value (putils:232-240), global
    if thr and thr_mod == "max":
        kp_thr = global_max([_interior_rows(kp_map, i, q0, q1).reshape(B, -1).amax(dim=1)
                             for i, (q0, q1) in enumerate(own)])
    elif thr and thr_mod == "mean":
        kp_thr = global_sum([_interior_rows(kp_map, i, q0, q1).reshape(B, -1).sum(dim=1)
                             for i, (q0, q1) in enumerate(own)]) / (h2 * w2)
    elif thr and thr_mod != "abs":
        raise ValueError(f"unknown thr_mod {thr_mod}")
    else:
        kp_thr = torch.ones((B,), dtype=dt, device=dev0)

    fold = min(r + 1, 4) if (use_nms is True and r >= 1) else 0
    wb = -(-w2 // fold) if fold > 1 else 0  # blocks per block row
    # the packed top-k: the block's argmax (< 16) in the 4 low bits of its
    # f32 maximum, so the selected words carry the offset and the score
    packed = fold > 1 and topk == "approx"
    cand, counts = [], []
    for i, (q0, q1) in enumerate(own):
        if fold > 1:
            bs0 = -(-q0 // fold) * fold  # the first block whose first row the band owns
            be = (q1 - 1) // fold * fold + fold
            e = min(be, h2)
        else:
            e = q1
        interior = _interior_rows(kp_map, i, q0, e)  # [B, e − q0, w2]
        if use_nms == "softnms" or use_nms is True:
            win = _interior_rows(kp_map, i, q0 - r, e + r)
            sp = F.pad(win[:, None], (r, r, 0, 0), mode="reflect")[:, 0]
        if use_nms == "softnms":
            s = interior
            local_mean = avg_pool2d(sp[..., None], 2 * r + 1, 1)[..., 0]
            nms_mask = F.softplus(s - local_mean)
            count_src = None
        elif use_nms:
            Wp = w2 + 2 * r
            lin = (torch.arange(q0, e + 2 * r, dtype=torch.int32, device=sp.device)[:, None] * Wp
                   + torch.arange(Wp, dtype=torch.int32, device=sp.device)[None, :])[None]
            nms_mask = nms_window(sp, lin, r).to(dt)
            count_src = nms_mask
        else:
            nms_mask = torch.ones_like(interior)
            count_src = nms_mask
        if thr:
            tmask = (interior > thr * kp_thr.to(interior.device).reshape(B, 1, 1)).to(dt)
            nms_mask = tmask * nms_mask
            count_src = tmask if use_nms == "softnms" else nms_mask
        counts.append(count_src[:, : q1 - q0].reshape(B, -1).sum(dim=1).to(torch.int32))
        masked = nms_mask * interior
        if fold > 1:
            mm = F.pad(masked[:, bs0 - q0 :], (0, wb * fold - w2, 0, be - e))
            nbr = (be - bs0) // fold
            blocks = mm.reshape(B, nbr, fold, wb, fold).permute(0, 1, 3, 2, 4).reshape(B, nbr * wb, fold * fold)
            bmax, barg = blocks.max(dim=-1)
            if packed:
                words = ((bmax.float().view(torch.int32) & ~0xF) | barg.to(torch.int32)).view(torch.float32)
                vals, li = top_k(words, min(num_pts, words.shape[1]))
                cand.append((vals, li + (bs0 // fold) * wb, None))
            else:
                vals, li = top_k(bmax, min(num_pts, bmax.shape[1]))
                cand.append((vals, li + (bs0 // fold) * wb, torch.gather(barg, 1, li)))
        else:
            flat = masked[:, : q1 - q0].reshape(B, -1)
            vals, li = top_k(flat, min(num_pts, flat.shape[1]))
            cand.append((vals, li + q0 * w2, None))
    valid_count = global_sum(counts)

    # merge: a stable sort of the scores (or packed words) in band order
    # puts ties in global index order
    vals = torch.cat([c[0].to(dev0) for c in cand], dim=1)
    gidx = torch.cat([c[1].to(dev0) for c in cand], dim=1)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    if fold > 1:
        k = min(num_pts, (-(-h2 // fold)) * wb)
        order = order[:, :k]
        bidx = torch.gather(gidx, 1, order)
        if packed:
            words = vals[:, :k].view(torch.int32)
            inner = words & 0xF
        else:
            inner = torch.gather(torch.cat([c[2].to(dev0) for c in cand], dim=1), 1, order)
        yy = (bidx // wb) * fold + inner // fold
        xx = (bidx % wb) * fold + inner % fold
        # zero-score pad blocks may decode past the interior; their slots
        # lie beyond valid_count and are trimmed on the host
        idx = torch.clamp(yy * w2 + xx, 0, h2 * w2 - 1)
    else:
        k = min(num_pts, h2 * w2)
        idx = torch.gather(gidx, 1, order[:, :k])

    kps = torch.zeros((B, k, 2), dtype=dt, device=dev0)
    # the packed words' scores: their 4 low bits cleared (an NMS winner is
    # the strict maximum of its 3x3 window, so this is its max-pooled score
    # except on the interior's edge ring), else the max-pooled map's
    kp_score = ((words & ~0xF).view(torch.float32).to(dt)[..., None] if packed
                else torch.zeros((B, k, 1), dtype=dt, device=dev0))
    for i, (q0, q1) in enumerate(own):
        dev = kp_map.parts[i].device
        grids = _grids(kp_map, i, q0, q1, refine, refine_temperature).reshape(B, -1, 2)
        li = idx.to(dev) - q0 * w2
        sel = ((li >= 0) & (li < (q1 - q0) * w2))[..., None]
        li = li.clamp(0, (q1 - q0) * w2 - 1)[..., None]
        g = torch.gather(grids, 1, li.expand(-1, -1, 2))
        kps = torch.where(sel.to(dev0), g.to(dev0), kps)
        if not packed:
            score_map = max_pool2d(kp_map.gather(i, range(q0, q1 + 2)), 3, 1).reshape(B, -1, 1)
            s = torch.gather(score_map, 1, li)
            kp_score = torch.where(sel.to(dev0), s.to(dev0), kp_score)
    kps, kp_score = _pad_slate(num_pts, k, kps, kp_score)
    return kps, kp_score, valid_count


def sample_feat_by_coord(x: Bands, coord_n: torch.Tensor, norm: bool = False, impl: str = "corner") -> torch.Tensor:
    """``sample_feat_by_coord`` (``impl`` "corner", "quad" or "pair") on
    bands of the map [B, h, w, C]: the unsharded sampler on the map
    gathered on coord_n's device, so its descriptors are the unsharded
    ones by construction; [B, N, C] in f32, L2-normalized where ``norm``."""
    return grid_sample.sample_feat_by_coord(x.concat(coord_n.device), coord_n, norm, impl)
