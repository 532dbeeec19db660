"""Inference keypoint detectors: NMS + threshold + coordinate refinement +
top-k (posfeat_tpu/ops/detect.py; reference preprocess_utils.py:196-429).

Like the JAX package, every detector returns a fixed ``num_pts`` slate
plus a per-image ``valid_count``; the extractor trims on the host to the
reference's dynamic count max(min(num_pts, valid_count), 128). Selection
order is exact: top-k of the masked score map, ties to the lower flat
index (a stable descending sort, which ``torch.topk`` does not promise).

``topk="approx"`` is the JAX package's POSFEAT_TOPK=approx
(detect.py:26-39, 285-296, 354-407). Its top-k (``approx_max_k`` at
recall 0.99) stays exact here, recall 1.0, as approx_max_k is on the
CPU. What it changes is kept exactly: before the top-k of the NMS
detector's block maxima, each block's argmax is packed into the 4 low
mantissa bits of its f32 maximum and decoded from the selected values
(so maxima within 16 ulps rank by their argmax), and the reported score
is that selected value with the 4 bits cleared (``score_from_topk``), in
place of the 3×3 max-pooled map's value.

Sub-pixel refiners of ``generate_kpts_single`` (``refine``): 'avg3', the
reference's 3×3 score-weighted centre of mass; 'quad' and 'quad5', a
quadratic peak fit over 3×3 (Taylor) or 5×5 (least squares), in f32
whatever the map's dtype; 'soft' and 'soft5', the soft-argmax over 3×3
or 5×5 at the map's dtype, DiskLoss's ``loc_weight`` statistic. They are
dense stencils on a one-channel map, plain XLA in the JAX package and
plain PyTorch here. ``quad_offsets_at`` and ``softargmax_offsets_at``
compute the same offsets at given integer pixels only, from each pixel's
window, for the loss.

Gumbel sampling (``stable=False``) and the grid detectors' categorical
draws take a ``torch.Generator``, or the noise or draws themselves, so a
test can feed them the JAX package's draws.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .coords import gen_grid
from .nms import nms, soft_nms
from .pooling import avg_pool2d, max_pool2d
from .samplers import draw_categorical, gumbel_noise, gumbel_topk_select, unfold

REFINERS = ("avg3", "quad", "quad5", "soft", "soft5")
TOPK = ("exact", "approx")


def _check_topk(topk: str) -> None:
    if topk not in TOPK:
        raise ValueError(f"unknown topk {topk!r}; expected one of {TOPK}")


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


# ------------------------------------------------------------ refiners


def _quad_solve(c, px, mx, py, my, pp, pm, mp, mm):
    """The 3×3 Taylor peak fit from the centre, its four neighbours and
    four diagonals (pp = (+y, +x), pm = (+y, −x), ...): offsets (ox, oy)
    in pixels, clamped to ±0.5, zero where the Hessian is not a
    well-posed strict local maximum (detect.py:57-90)."""
    dx = 0.5 * (px - mx)
    dy = 0.5 * (py - my)
    dxx = px - 2.0 * c + mx
    dyy = py - 2.0 * c + my
    dxy = 0.25 * (pp - pm - mp + mm)
    det = dxx * dyy - dxy * dxy
    ok = (det > 1e-12) & (dxx < 0.0)
    safe_det = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    ox = torch.where(ok, -(dyy * dx - dxy * dy) / safe_det, zero).clamp(-0.5, 0.5)
    oy = torch.where(ok, -(dxx * dy - dxy * dx) / safe_det, zero).clamp(-0.5, 0.5)
    return ox, oy


def quad_refine_offsets(kp_map: torch.Tensor) -> torch.Tensor:
    """Dense quadratic-fit sub-pixel offset map [B, H, W, 2] in pixels,
    f32; the 1-px border ring is zero (no full 3×3 support)."""
    s = kp_map[..., 0].float()
    ox, oy = _quad_solve(
        s[:, 1:-1, 1:-1], s[:, 1:-1, 2:], s[:, 1:-1, :-2], s[:, 2:, 1:-1], s[:, :-2, 1:-1],
        s[:, 2:, 2:], s[:, 2:, :-2], s[:, :-2, 2:], s[:, :-2, :-2],
    )
    return F.pad(torch.stack([ox, oy], dim=-1), (0, 0, 1, 1, 1, 1))


def _softargmax(patches: torch.Tensor, temperature: float, window: int):
    """Expected (dx, dy) of softmax(temperature · patches) over the last
    axis, the window's taps in row-major (dy, dx) order."""
    r = window // 2
    w = torch.softmax(temperature * patches, dim=-1)
    offs = range(-r, r + 1)
    dxs = torch.tensor([dx for _ in offs for dx in offs], dtype=patches.dtype, device=patches.device)
    dys = torch.tensor([dy for dy in offs for _ in offs], dtype=patches.dtype, device=patches.device)
    return torch.stack([(w * dxs).sum(-1), (w * dys).sum(-1)], dim=-1)


def _check_window(window: int) -> int:
    if window % 2 != 1 or window < 3:
        raise ValueError(f"soft-argmax window must be odd and >= 3, got {window}")
    return window // 2


def softargmax3_offsets(kp_map: torch.Tensor, temperature: float, window: int = 3) -> torch.Tensor:
    """Differentiable soft-argmax offset map [B, H, W, 2] in pixels at the
    map's dtype (detect.py:93-129): per pixel, the expected offset of
    softmax(temperature · score) over its window × window neighbourhood,
    edge-replicated at the border."""
    r = _check_window(window)
    B, H, W, _ = kp_map.shape
    sp = F.pad(kp_map[..., 0][:, None], (r, r, r, r), mode="replicate")[:, 0]
    offs = range(-r, r + 1)
    patches = torch.stack(
        [sp[:, r + dy : H + r + dy, r + dx : W + r + dx] for dy in offs for dx in offs], dim=-1
    )
    return _softargmax(patches, temperature, window)


def _window_at(s: torch.Tensor, coord: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """The (2r+1)² window of the [B, H, W] map s around each integer pixel
    coord [B, k, 2] (x, y), taps in row-major (dy, dx) order: [B, k, taps].
    ``mode`` pads the map as F.pad does ('replicate' or 'constant')."""
    B, H, W = s.shape
    sp = F.pad(s[:, None], (r, r, r, r), mode=mode)[:, 0]
    Wp = W + 2 * r
    xi = coord[..., 0].long() + r
    yi = coord[..., 1].long() + r
    offs = range(-r, r + 1)
    idx = torch.stack([(yi + dy) * Wp + (xi + dx) for dy in offs for dx in offs], dim=-1)
    k = coord.shape[1]
    return torch.gather(sp.reshape(B, -1), 1, idx.reshape(B, -1)).reshape(B, k, -1)


def quad_offsets_at(kp_map: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """``quad_refine_offsets`` read at integer pixels coord [B, k, 2] (x,
    y), computed from each pixel's 3×3 window only: [B, k, 2] f32, zero on
    the 1-px border ring, without a graph."""
    B, H, W, _ = kp_map.shape
    t = _window_at(kp_map[..., 0].detach().float(), coord, 1, "constant")
    # taps (dy, dx) row-major: 0 (-1,-1) 1 (-1,0) 2 (-1,1) 3 (0,-1) 4 (0,0) 5 (0,1) 6 (1,-1) 7 (1,0) 8 (1,1)
    ox, oy = _quad_solve(t[..., 4], t[..., 5], t[..., 3], t[..., 7], t[..., 1],
                         t[..., 8], t[..., 6], t[..., 2], t[..., 0])
    x, y = coord[..., 0], coord[..., 1]
    inner = (x >= 1) & (x <= W - 2) & (y >= 1) & (y <= H - 2)
    return torch.where(inner[..., None], torch.stack([ox, oy], dim=-1), torch.zeros_like(ox)[..., None])


def softargmax_offsets_at(kp_map: torch.Tensor, coord: torch.Tensor, temperature: float,
                          window: int = 3) -> torch.Tensor:
    """``softargmax3_offsets`` read at integer pixels coord [B, k, 2] (x,
    y), computed from each pixel's window only: [B, k, 2] at the map's
    dtype, differentiable with respect to the map."""
    r = _check_window(window)
    return _softargmax(_window_at(kp_map[..., 0], coord, r, "replicate"), temperature, window)


def _offset_grids(off: torch.Tensor, H: int, W: int, dtype, row0: int = 0) -> torch.Tensor:
    """Interior pixel centres plus offsets [B, H-2, W-2, 2] in pixels ->
    normalized coordinates at ``dtype``; ``off`` may hold the interior
    rows from ``row0`` on only."""
    dev = off.device
    jj = torch.arange(1, W - 1, dtype=torch.float32, device=dev)
    ii = torch.arange(1 + row0, 1 + row0 + off.shape[1], dtype=torch.float32, device=dev)
    kx = -1.0 + 2.0 * (jj[None, None, :] + off[..., 0]) / (W - 1)
    ky = -1.0 + 2.0 * (ii[None, :, None] + off[..., 1]) / (H - 1)
    return torch.stack([kx, ky], dim=-1).to(dtype)


def _quad_refine_grids(kp_map: torch.Tensor) -> torch.Tensor:
    """3×3 quadratic (Taylor) peak fit of every interior pixel
    (detect.py:132-157): refined normalized coordinates [B, H-2, W-2, 2],
    aligned with the interior crop; math in f32."""
    B, H, W, _ = kp_map.shape
    off = quad_refine_offsets(kp_map)[:, 1:-1, 1:-1, :]
    return _offset_grids(off, H, W, kp_map.dtype)


def _quad5_filters(device=None) -> torch.Tensor:
    """The 6 least-squares filters [6, 5, 5] of s ≈ a·x² + b·y² + c·xy +
    d·x + e·y + f over a 5×5 window: the pseudo-inverse of the 25×6
    design, in float64, cast to f32 (detect.py:160-171)."""
    xs, ys = np.meshgrid(np.arange(-2, 3), np.arange(-2, 3))
    X = np.stack([xs ** 2, ys ** 2, xs * ys, xs, ys, np.ones_like(xs)], axis=-1)
    F_ = np.linalg.pinv(X.reshape(25, 6).astype(np.float64))
    return torch.from_numpy(F_.reshape(6, 5, 5).astype(np.float32)).to(device)


def _quad5_offsets(kp_map: torch.Tensor) -> torch.Tensor:
    """The 5×5 least-squares quadratic peak fit's offsets [B, H, W, 2] of
    every pixel (detect.py:174-214): edge pad 2, one conv with the 6
    filters, offsets clamped to ±1 px, zero where the fitted Hessian is
    not a well-posed local maximum; math in f32."""
    s = kp_map[..., 0].float()
    sp = F.pad(s[:, None], (2, 2, 2, 2), mode="replicate")
    coeffs = F.conv2d(sp, _quad5_filters(s.device)[:, None])  # [B, 6, H, W]
    a, b, c, d, e = (coeffs[:, i] for i in range(5))
    det = 4.0 * a * b - c * c
    ok = (det > 1e-12) & (a < 0.0)
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    ox = torch.where(ok, -(2.0 * b * d - c * e) / safe, zero).clamp(-1.0, 1.0)
    oy = torch.where(ok, -(2.0 * a * e - c * d) / safe, zero).clamp(-1.0, 1.0)
    return torch.stack([ox, oy], dim=-1)


def _quad5_refine_grids(kp_map: torch.Tensor) -> torch.Tensor:
    """The 5×5 fit's refined coordinates of every interior pixel:
    [B, H-2, W-2, 2], the pixel centre where the fit is not a local
    maximum."""
    B, H, W, _ = kp_map.shape
    return _offset_grids(_quad5_offsets(kp_map)[:, 1:-1, 1:-1], H, W, kp_map.dtype)


def refined_grids(kp_map: torch.Tensor, refine: str = "avg3", stride: int = 1,
                  refine_temperature: float = 20.0) -> torch.Tensor:
    """The refined normalized coordinates of every candidate position:
    [B, H-2, W-2, 2] at stride 1 (aligned with the interior crop); 'avg3'
    at stride s pools with that stride (detect.py:333-364)."""
    if refine not in REFINERS:
        raise ValueError(f"unknown refine {refine!r}; expected one of {REFINERS}")
    if refine != "avg3" and stride != 1:
        raise ValueError(f"refine={refine!r} runs at stride 1 only, got stride {stride}")
    B, H, W, _ = kp_map.shape
    if refine in ("soft", "soft5"):
        off = softargmax3_offsets(kp_map, refine_temperature, 5 if refine == "soft5" else 3)
        return _offset_grids(off[:, 1:-1, 1:-1, :], H, W, kp_map.dtype)
    if refine == "quad":
        return _quad_refine_grids(kp_map)
    if refine == "quad5":
        return _quad5_refine_grids(kp_map)
    # 3×3 score-weighted coordinate refinement (putils:242-247)
    grids_org = gen_grid(-1, 1, -1, 1, H, W, dtype=kp_map.dtype, device=kp_map.device).reshape(1, H, W, 2)
    return avg_pool2d(kp_map * grids_org, 3, stride) / avg_pool2d(kp_map, 3, stride)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, C] at idx [B, k] -> [B, k, C]. An index past n (the
    strided 'avg3' grids are smaller than the interior the top-k ranks)
    reads NaN, as the JAX gather fills it (detect.py:420)."""
    n, C = x.shape[1], x.shape[2]
    out = torch.gather(x, 1, idx.clamp(max=n - 1)[..., None].expand(-1, -1, C))
    if idx.numel() and int(idx.max()) >= n:
        out = torch.where((idx >= n)[..., None], torch.full_like(out, float("nan")), out)
    return out


# ----------------------------------------------------------- detectors


def _masks(kp_map, nms_radius, use_nms, thr, thr_mod):
    """(selection mask, count source) at the map's dtype, as the
    detectors build them (putils:226-240)."""
    if use_nms == "softnms":
        nms_mask = soft_nms(kp_map, nms_radius)
        count_src = None  # counted from the threshold mask below
    elif use_nms:
        nms_mask = nms(kp_map, nms_radius).to(kp_map.dtype)
        count_src = nms_mask
    else:
        nms_mask = torch.ones_like(kp_map)
        count_src = nms_mask
    if thr:
        tmask = _thr_mask(kp_map, thr, thr_mod).to(kp_map.dtype)
        nms_mask = tmask * nms_mask
        count_src = tmask if use_nms == "softnms" else nms_mask
    if count_src is None:
        raise ValueError("use_nms='softnms' needs a threshold to count valid points")
    return nms_mask, count_src


def _pad_slate(num_pts, k, *ts):
    if k >= num_pts:
        return ts
    return tuple(F.pad(t, (0, 0, 0, num_pts - k)) for t in ts)


def generate_kpts_single(
    kp_map: torch.Tensor,
    *,
    num_pts: int,
    nms_radius: int,
    use_nms=True,
    thr=False,
    thr_mod: str = "mean",
    stable: bool = True,
    temperature: float = 1.0,
    generator: torch.Generator = None,
    noise: torch.Tensor = None,
    stride: int = 1,
    refine: str = "avg3",
    refine_temperature: float = 20.0,
    topk: str = "exact",
):
    """Full-image detector with sub-pixel refinement (detect.py:217-429).
    kp_map: [B, H, W, 1] full-res score map -> (kps_n [B, num_pts, 2]
    normalized, scores [B, num_pts, 1], valid_count [B] int32).

    ``stable=False`` selects by Gumbel soft top-k at ``temperature``:
    kps = select @ grids, scores = select @ interior, with the noise
    [B, num_pts, (H-2)(W-2)] given or drawn from ``generator``. ``topk``:
    "exact", or "approx" (module docstring; the packing needs the stable
    NMS path, where scores are nonnegative, so that the f32 words order
    as integers as their values do)."""
    _check_topk(topk)
    B, H, W, _ = kp_map.shape
    grids = refined_grids(kp_map, refine, stride, refine_temperature)
    interior = kp_map[:, 1:-1, 1:-1, :]  # [B, H-2, W-2, 1]
    nms_mask, count_src = _masks(interior, nms_radius, use_nms, thr, thr_mod)
    valid_count = count_src.reshape(B, -1).sum(dim=1).to(torch.int32)
    h2, w2 = H - 2, W - 2

    if not stable:
        if noise is None:
            if generator is None:
                raise ValueError("Gumbel sampling (stable=False) needs a generator or the noise")
            noise = gumbel_noise((B, num_pts, h2 * w2), generator, kp_map.dtype, kp_map.device)
        select = gumbel_topk_select(nms_mask * interior, num_pts, noise, temperature)
        kps = select @ grids.reshape(B, h2 * w2, 2)
        kp_score = select @ interior.reshape(B, h2 * w2, 1)
        return kps, kp_score, valid_count

    # an NMS winner is the strict maximum of its 3x3 interior window, so
    # the max-pooled score is its own except on the interior's edge ring
    score_from_topk = use_nms is True and nms_radius >= 1 and topk == "approx"
    kp_score_map = None if score_from_topk else max_pool2d(kp_map, 3, stride)
    masked = (nms_mask * interior).reshape(B, -1)
    fold = min(nms_radius + 1, 4) if (use_nms is True and nms_radius >= 1) else 0
    if fold > 1:
        # NMS winners are pairwise > nms_radius apart (Chebyshev), so a
        # fold×fold block holds at most one: reducing each block to its
        # max before the top-k is exact and shrinks the sort fold²×
        hp = -(-h2 // fold) * fold
        wp = -(-w2 // fold) * fold
        mm = F.pad(masked.reshape(B, h2, w2), (0, wp - w2, 0, hp - h2))
        blocks = mm.reshape(B, hp // fold, fold, wp // fold, fold)
        blocks = blocks.permute(0, 1, 3, 2, 4).reshape(B, (hp // fold) * (wp // fold), fold * fold)
        bmax, barg = blocks.max(dim=-1)  # first maximal element on ties
        k = min(num_pts, bmax.shape[1])
        if topk == "approx":
            # the argmax (< 16) in the 4 low bits of the f32 word
            packed = (bmax.float().view(torch.int32) & ~0xF) | barg.to(torch.int32)
            scores_sel, bidx = top_k(packed.view(torch.float32), k)
            inner = scores_sel.view(torch.int32) & 0xF
        else:
            _, bidx = top_k(bmax, k)
            inner = torch.gather(barg, 1, bidx)
        yy = (bidx // (wp // fold)) * fold + inner // fold
        xx = (bidx % (wp // fold)) * fold + inner % fold
        # zero-score pad blocks may decode past the interior; their slots
        # lie beyond valid_count and are trimmed on the host
        idx = torch.clamp(yy * w2 + xx, 0, h2 * w2 - 1)
    else:
        k = min(num_pts, masked.shape[1])
        _, idx = top_k(masked, k)
    kps = _gather_rows(grids.reshape(B, -1, 2), idx)
    if score_from_topk:
        kp_score = (scores_sel.view(torch.int32) & ~0xF).view(torch.float32).to(kp_map.dtype)[..., None]
    else:
        kp_score = _gather_rows(kp_score_map.reshape(B, -1, 1), idx)
    kps, kp_score = _pad_slate(num_pts, k, kps, kp_score)
    return kps, kp_score, valid_count


def generate_kpts_single_noavg(
    kp_map: torch.Tensor,
    *,
    num_pts: int,
    nms_radius: int,
    use_nms=True,
    thr=False,
    thr_mod: str = "mean",
    stable: bool = True,
    temperature: float = 1.0,
    generator: torch.Generator = None,
    stride: int = 1,
    topk: str = "exact",
):
    """Detector without coordinate refinement (detect.py:432-482;
    putils:280-336): the full map, no interior crop, pixel-centre
    coordinates and raw scores of the exact top-k. Like the JAX version it
    always selects by top-k; ``stable``, ``temperature``, ``generator``
    and ``stride`` are taken for the configs' sake and not read, and
    ``topk="approx"`` selects as "exact" (recall 1.0)."""
    _check_topk(topk)
    B, H, W, _ = kp_map.shape
    nms_mask, count_src = _masks(kp_map, nms_radius, use_nms, thr, thr_mod)
    grids = gen_grid(-1, 1, -1, 1, H, W, dtype=kp_map.dtype, device=kp_map.device)
    valid_count = count_src.reshape(B, -1).sum(dim=1).to(torch.int32)
    masked = (nms_mask * kp_map).reshape(B, -1)
    k = min(num_pts, masked.shape[1])
    _, idx = top_k(masked, k)
    kps = grids[idx]
    kp_score = torch.gather(kp_map.reshape(B, -1, 1), 1, idx[..., None])
    kps, kp_score = _pad_slate(num_pts, k, kps, kp_score)
    return kps, kp_score, valid_count


def generate_kpts_regular_grid_single(
    kp_map: torch.Tensor,
    *,
    grid_size: int,
    num_pts: int = 0,
    stable: bool = True,
    use_nms=True,
    nms_radius: int = None,
    thr=None,
    thr_mod: str = "mean",
    generator: torch.Generator = None,
    draw: torch.Tensor = None,
    topk: str = "exact",
):
    """Grid-cell detector (detect.py:485-547; putils:375-429): per g×g
    cell the argmax of the cell softmax, or with ``stable=False`` a
    Categorical draw ([B, H/g, W/g] indices, given as ``draw`` or drawn
    from ``generator``). Returns (kps_n [B, num_pts, 2], scores
    [B, num_pts, 1], valid_count [B]); ``num_pts=0`` returns the whole
    cell slate, row-major. ``topk="approx"`` selects as "exact" (recall
    1.0)."""
    _check_topk(topk)
    B, H, W, _ = kp_map.shape
    if use_nms == "softnms":
        kp_map = soft_nms(kp_map, nms_radius) * kp_map
        nms_mask = torch.ones_like(kp_map, dtype=torch.bool)
    elif use_nms:
        nms_mask = nms(kp_map, nms_radius)
    else:
        nms_mask = torch.ones_like(kp_map, dtype=torch.bool)
    if thr is not None:
        nms_mask = _thr_mask(kp_map, thr, thr_mod) & nms_mask

    g = grid_size
    grids = gen_grid(-1, 1, -1, 1, H, W, dtype=kp_map.dtype, device=kp_map.device).reshape(1, H, W, 2)
    grids_cells = unfold(grids.expand(B, H, W, 2), g)  # [B, hg, wg, 2, g·g]
    map_cells = unfold(kp_map, g)[:, :, :, 0, :]
    nms_cells = unfold(nms_mask.to(kp_map.dtype), g)[:, :, :, 0, :]
    if stable:
        idx = torch.softmax(map_cells, dim=-1).argmax(dim=-1)
    elif draw is not None:
        idx = draw.long()
    elif generator is not None:
        idx = draw_categorical(map_cells, generator)
    else:
        raise ValueError("the grid detector's Categorical draw (stable=False) needs a generator or the draw")

    kps = torch.gather(grids_cells, -1, idx[:, :, :, None, None].expand(-1, -1, -1, 2, 1))[..., 0]
    score = torch.gather(map_cells, -1, idx[..., None])
    mask = torch.gather(nms_cells, -1, idx[..., None])
    kps, score, mask = kps.reshape(B, -1, 2), score.reshape(B, -1, 1), mask.reshape(B, -1, 1)
    valid_count = mask[..., 0].sum(dim=1).to(torch.int32)
    if num_pts:
        k = min(num_pts, kps.shape[1])
        top_score, top_idx = top_k((mask * score)[..., 0], k)
        kps = torch.gather(kps, 1, top_idx[..., None].expand(-1, -1, 2))
        kps, score = _pad_slate(num_pts, k, kps, top_score[..., None])
    return kps, score, valid_count


def _stable_choice(stable_prob: float, generator, device, draws):
    """The batched detectors' Bernoulli(stable_prob) pick: stable iff a
    uniform draw is below stable_prob (detect.py:580-585); ``draws[0]``
    gives the uniform."""
    if draws is not None:
        u = float(draws[0])
    elif generator is not None:
        u = torch.rand((), generator=generator, device=device).item()
    else:
        raise ValueError("the batched detectors need a generator or their draws")
    return u < stable_prob


def generate_kpts(outputs, generator: torch.Generator = None, *, nms_radius: int, num_pts: int,
                  stable_prob: float = 0.9, use_nms=True, stride: int = 1, epoch: int = 0, draws=None):
    """Two-image whole-map detector (detect.py:550-585; putils:196-213):
    stable top-k with probability ``stable_prob``, else Gumbel sampling at
    temperature 0.01 / (epoch + 1). ``draws`` = (uniform, noise1, noise2)
    replaces the generator's draws. Returns (kps1, kps2, s1, s2)."""
    kp_map1 = outputs["preds1"]["local_point"]
    kp_map2 = outputs["preds2"]["local_point"]
    stable = _stable_choice(stable_prob, generator, kp_map1.device, draws)
    kw = dict(num_pts=num_pts, nms_radius=nms_radius, use_nms=use_nms, stride=stride,
              temperature=0.01 / (epoch + 1), stable=stable, generator=generator)
    noise = (None, None) if draws is None else draws[1:]
    kps1, s1, _ = generate_kpts_single(kp_map1, noise=noise[0], **kw)
    kps2, s2, _ = generate_kpts_single(kp_map2, noise=noise[1], **kw)
    return kps1, kps2, s1, s2


def generate_kpts_regular_grid(outputs, generator: torch.Generator = None, *, grid_size: int,
                               num_pts: int = 0, stable_prob: float = 0.9, use_nms=True,
                               nms_radius: int = None, draws=None):
    """Two-image grid-cell detector (detect.py:588-621; putils:358-373),
    the stable/Categorical pick as ``generate_kpts``'s; ``draws`` =
    (uniform, cell draw 1, cell draw 2). Returns (kps1, kps2, s1, s2)."""
    kp_map1 = outputs["preds1"]["local_point"]
    kp_map2 = outputs["preds2"]["local_point"]
    stable = _stable_choice(stable_prob, generator, kp_map1.device, draws)
    kw = dict(grid_size=grid_size, num_pts=num_pts, use_nms=use_nms, nms_radius=nms_radius,
              stable=stable, generator=generator)
    cell_draws = (None, None) if draws is None else draws[1:]
    kps1, s1, _ = generate_kpts_regular_grid_single(kp_map1, draw=cell_draws[0], **kw)
    kps2, s2, _ = generate_kpts_regular_grid_single(kp_map2, draw=cell_draws[1], **kw)
    return kps1, kps2, s1, s2


DETECTORS = {
    "generate_kpts_single": generate_kpts_single,
    "generate_kpts_single_noavg": generate_kpts_single_noavg,
    "generate_kpts_regular_grid_single": generate_kpts_regular_grid_single,
}
