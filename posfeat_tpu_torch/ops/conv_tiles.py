"""Convolutions in row tiles that the unsharded and the H-banded program
share.

The library picks a conv's algorithm by its input's shape (on the card
cuDNN's TF32 convs by the map's height, and on a 12 Mpx frame some bf16
ones; oneDNN's by any), so the two programs run the convs where that
shows over the same row tiles, one call a tile with its halo rows, and
get the same elements. ``ROW_TILE`` is a tile's height in image rows:
256 rows at H/2, 128 at H/4, 64 at H/8, 32 at H/16. 480x640 maps (the
batched extraction and training sizes) are one tile at every level, so
their convs stay one call. models/resunet.py tiles every decoder conv
and every 3x3 stride-1 encoder conv; parallel/spatial.py lays band
boundaries on the tiles' boundaries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROW_TILE = 512


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def row_tiled_conv(x, weight, bias, stride, padding, dilation, tile=None, row0=0, total=None, rows=None):
    """Output rows ``rows`` (all by default) of F.conv2d(X, weight, bias,
    stride, padding, dilation) with zero padding, where the NCHW ``x`` holds
    rows ``row0`` .. row0 + x.shape[2] of the input X of ``total`` rows (x
    itself by default): one call a tile of ``tile`` output rows (tiles from
    row 0, one call in all without ``tile``), on a view of the rows it reads.
    Where a tile reaches beyond X's edge, the call pads those rows itself
    (at stride 1 a symmetric pad whose extra rows are cut off), so that a
    call depends only on the tile's place in X, not on which rows x holds:
    the banded program (``row0`` > 0) issues the unsharded program's calls.
    The whole map in one tile is exactly ``F.conv2d``'s one call."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    kh = weight.shape[2]
    total = x.shape[2] if total is None else total
    o0, o1 = (0, (total + 2 * ph - dh * (kh - 1) - 1) // sh + 1) if rows is None else rows
    edges = [o0, o1] if tile is None else [o0, *range((o0 // tile + 1) * tile, o1, tile), o1]
    out = []
    for p0, p1 in zip(edges[:-1], edges[1:]):
        lo, hi = p0 * sh - ph, (p1 - 1) * sh - ph + (kh - 1) * dh + 1
        rlo, rhi = max(lo, 0), min(hi, total)
        v = x[:, :, rlo - row0 : rhi - row0]
        top, bot = rlo - lo, hi - rhi
        if top == bot:
            y = F.conv2d(v, weight, bias, (sh, sw), (top, pw), (dh, dw))
        elif sh == 1:
            pad = max(top, bot)
            y = F.conv2d(v, weight, bias, 1, (pad, pw), (dh, dw))[:, :, pad - top : pad - top + p1 - p0]
        else:
            y = F.conv2d(F.pad(v, (0, 0, top, bot)), weight, bias, (sh, sw), (0, pw), (dh, dw))
        out.append(y)
    return out[0] if len(out) == 1 else torch.cat(out, dim=2)
