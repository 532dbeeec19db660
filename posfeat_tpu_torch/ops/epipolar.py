"""Epipolar geometry: point-to-line costs, line/image-border
intersections, the reference line-probe search and the windowed
soft-argmax (posfeat_tpu/ops/epipolar.py; reference
losses/epipolarloss.py:16-22, kploss.py:58-61, preprocess_utils.py:490-520,
661-758). Pixel coordinates are (x, y); fundamental matrices [B, 3, 3]
map image-1 points to image-2 epipolar lines. f32 on the card stays out
of TF32 (``core/device.py``)."""

from __future__ import annotations

import torch

from .coords import gen_grid, homogenize, normalize_coords
from .correlation import compute_prob
from .grid_sample import grid_sample


def _lines(fmatrix: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Unscaled epipolar lines of coord [B, k, 2]: [B, 3, k]."""
    return torch.matmul(fmatrix, homogenize(coord).transpose(1, 2))


def epipolar_lines(fmatrix: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Epipolar lines of coord [B, k, 2] under fmatrix [B, 3, 3], scaled to
    unit normal: [B, k, 3]."""
    line = _lines(fmatrix, coord)
    line = line / torch.linalg.vector_norm(line[:, :2], dim=1, keepdim=True).clamp_min(1e-8)
    return line.transpose(1, 2)


def epipolar_cost(coord1: torch.Tensor, coord2: torch.Tensor, fmatrix: torch.Tensor) -> torch.Tensor:
    """|distance of coord2 to the epipolar line of coord1|
    (epipolarloss.py:16): coord1, coord2 [B, n, 2] -> [B, n]."""
    return (homogenize(coord2) * epipolar_lines(fmatrix, coord1)).sum(-1).abs()


def epipolar_pairwise_dist(coord1: torch.Tensor, coord2: torch.Tensor,
                           fmatrix: torch.Tensor) -> torch.Tensor:
    """All-pairs point-to-epipolar-line distance: coord1 [B, m, 2], coord2
    [B, n, 2] -> [B, m, n], the distance of each coord2 point to the
    epipolar line of each coord1 point."""
    line = epipolar_lines(fmatrix, coord1)
    return torch.bmm(line, homogenize(coord2).transpose(1, 2)).abs()


def _line_border_candidates(epipolar_line: torch.Tensor, h: int, w: int):
    """Intersections of [B, 3, n] lines with the image's four borders (left,
    right, up, bottom): points [B, n, 4, 2], the in-image mask [B, n, 4]
    with the reference's fix-up for lines that do not cross the image
    twice, and valid [B, n] (exactly two crossings)."""
    a, b, c = epipolar_line[:, 0], epipolar_line[:, 1], epipolar_line[:, 2]
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    points = torch.stack([
        torch.stack([zeros, -c / b], -1),
        torch.stack([(w - 1) * ones, -(a * (w - 1) + c) / b], -1),
        torch.stack([-(b * (h - 1) + c) / a, (h - 1) * ones], -1),
        torch.stack([-c / a, zeros], -1),
    ], dim=2)
    mask = (
        (points[..., 0] >= 0) & (points[..., 0] <= w - 1)
        & (points[..., 1] >= 0) & (points[..., 1] <= h - 1)
    )
    valid = mask.sum(-1) == 2
    fallback = torch.tensor([True, True, False, False], device=mask.device)
    mask = torch.where(valid[..., None], mask, fallback)
    return points, mask, valid


def _first_two(points: torch.Tensor, mask: torch.Tensor):
    """The first two candidates the mask keeps, in the order l, r, u, b."""
    order = torch.cumsum(mask.int(), dim=-1)
    first = (mask & (order == 1)).to(points.dtype)[..., None]
    second = (mask & (order == 2)).to(points.dtype)[..., None]
    # the non-finite coordinates of dropped candidates must not poison the sums
    safe = torch.where(torch.isfinite(points), points, torch.zeros_like(points))
    return (first * safe).sum(2), (second * safe).sum(2)


def get_endpoints(coords: torch.Tensor, fmat: torch.Tensor, h: int, w: int):
    """Epipolar line ∩ image border (putils:696-719): coords [B, n, 2] in
    image 1, (h, w) image 2's size -> normalized endpoints [B, n, 2]
    twice and valid [B, n]."""
    points, mask, valid = _line_border_candidates(_lines(fmat, coords), h, w)
    p1, p2 = _first_two(points, mask)
    return normalize_coords(p1, h, w), normalize_coords(p2, h, w), valid


def valid_points(epipolar_line: torch.Tensor, im_size, linelen_thr: float) -> torch.Tensor:
    """Validity of precomputed [B, 3, n] epipolar lines (putils:490-520):
    two border crossings and a normalized length above ``linelen_thr``."""
    h, w = im_size
    points, mask, valid = _line_border_candidates(epipolar_line, h, w)
    p1, p2 = _first_two(points, mask)
    line_len = normalize_coords(p2, h, w) - normalize_coords(p1, h, w)
    return valid & (torch.linalg.vector_norm(line_len, dim=-1) > linelen_thr)


def jitter(u: torch.Tensor, window_size: float) -> torch.Tensor:
    """A window centre's random shift from uniform [0, 1) draws:
    0.707·ws·(2u − 1) (putils:685-687)."""
    return 0.707 * window_size * (2 * u - 1)


def _in_image(center_n: torch.Tensor) -> torch.Tensor:
    return (
        (center_n[..., 0] >= -1) & (center_n[..., 0] <= 1)
        & (center_n[..., 1] >= -1) & (center_n[..., 1] <= 1)
    )


@torch.no_grad()
def epipolar_line_search(coord: torch.Tensor, fmat: torch.Tensor, feat1: torch.Tensor,
                         featmap2: torch.Tensor, h: int, w: int, *, jitter_u: torch.Tensor = None,
                         line_step: int = 100, use_nn: bool = True, loc_rand: bool = True,
                         window_size: float = 0.125):
    """Probe descriptors along each query's epipolar line (putils:661-694),
    without a graph (reference @torch.no_grad).

    coord [B, n, 2] pixel coords in image 1; feat1 [B, n, d] the queries;
    featmap2 [B, H2, W2, d], already temperature-scaled and normalized
    by the caller; (h, w) image 2's pixel size; ``jitter_u`` [B, n, 2]
    uniform [0, 1) draws, read when ``loc_rand``. Returns (expected
    [B, n, 2] after the jitter, expected before it, valid [B, n], std
    [B, n]). With ``use_nn`` the expectation sums the grid points of
    every probe that ties for the maximum, as the reference's mask does.
    """
    B, n, d = feat1.shape
    e1, e2, valid = get_endpoints(coord, fmat, h, w)
    ts = torch.linspace(0.0, 1.0, line_step, dtype=coord.dtype, device=coord.device)
    sg = torch.stack([ts, ts], -1)  # [step, 2]
    grids = (e2 - e1)[:, :, None, :] * sg + e1[:, :, None, :]  # [B, n, step, 2]
    samples = grid_sample(featmap2, grids, padding_mode="border")  # [B, n, step, d]
    prob = compute_prob(feat1.reshape(B * n, 1, d),
                        samples.reshape(B * n, line_step, d)).reshape(B, n, line_step)
    if use_nn:
        m = (prob == prob.amax(-1, keepdim=True)).to(grids.dtype)
        expected = (m[..., None] * grids).sum(2)
    else:
        expected = (prob[..., None] * grids).sum(2)
    expected_org = expected
    if loc_rand:
        if jitter_u is None:
            raise ValueError("loc_rand needs jitter_u draws")
        expected = expected + jitter(jitter_u, window_size)
    valid = valid & _in_image(expected)
    var = (grids ** 2 * prob[..., None]).sum(2) - expected ** 2
    std = var.clamp_min(1e-10).sqrt().sum(-1)
    return expected, expected_org, valid, std


def get_expected_correspondence_within_window(feat1: torch.Tensor, featmap2: torch.Tensor,
                                              coord2_n: torch.Tensor, window_size: float,
                                              with_std: bool = False, with_sim: bool = False):
    """Windowed soft-argmax around a centre estimate (putils:721-758):
    feat1 [B, n, d], featmap2 [B, H2, W2, d] (temperature-scaled and
    normalized by the caller), coord2_n [B, n, 2] normalized centres ->
    (expected [B, n, 2], window grid [B, n, K, 2][, std [B, n], prob
    [B, n, K]][, sim [B, n, wh, ww]])."""
    B, h2, w2, d = featmap2.shape
    n = coord2_n.shape[1]
    wh, ww = int(window_size * h2), int(window_size * w2)
    grid_n = gen_grid(-window_size, window_size, -window_size, window_size, wh, ww,
                      dtype=coord2_n.dtype, device=coord2_n.device)  # [K, 2]
    coord_grid = coord2_n[:, :, None, :] + grid_n  # [B, n, K, 2]
    feat2_win = grid_sample(featmap2, coord_grid, padding_mode="zeros")
    K = wh * ww
    prob, sim = compute_prob(feat1.reshape(B * n, 1, d), feat2_win.reshape(B * n, K, d),
                             return_sim=True)
    prob = prob.reshape(B, n, K)
    expected = (coord_grid * prob[..., None]).sum(2)
    out = [expected, coord_grid]
    if with_std:
        var = (coord_grid ** 2 * prob[..., None]).sum(2) - expected ** 2
        std = var.clamp_min(1e-10).sqrt().sum(-1)
        out += [std, prob]
    if with_sim:
        out.append(sim.reshape(B, n, wh, ww))
    return tuple(out)
