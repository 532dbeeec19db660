"""Convolutions in row tiles that the unsharded and the H-banded program
share.

The library picks a conv's algorithm by its input's shape (on the card
cuDNN's TF32 convs by the map's height, and on a 12 Mpx frame some bf16
ones; oneDNN's by any), so the two programs run the convs where that
shows over the same row tiles, one call a tile with its halo rows, and
get the same elements. ``tile_rows(height, width)`` is a tile's height in
image rows: ``ROW_TILE`` (256 rows at H/2, 128 at H/4, 64 at H/8, 32 at
H/16) for an image of at most ``WIDE`` columns. A wider image's rows
split evenly into the fewest tiles of at most ROW_TILE x WIDE pixels, so
that every image above that many pixels (the default
``spatial_threshold_px``), a panorama of at most ROW_TILE rows too, has
two or more tiles, and its bands (one a tile) are alike: the head's convs
run one call a band, and on the card a 32-row band beside a 480-row one
moved one bf16 element of a 512x8704 score map. A map
derives its tile from its own shape (``map_tile``). 480x640 maps (the
batched extraction and training sizes) are one tile at every level, so
their convs stay one call. models/resunet.py tiles every decoder conv
and every 3x3 stride-1 encoder conv; parallel/spatial.py lays band
boundaries on the tiles' boundaries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROW_TILE = 512
WIDE = 8192  # the widest image whose tiles hold ROW_TILE rows
BLOCK = 16  # ResUNet's stride to its deepest map: a tile holds whole rows of every map


def tile_rows(height: int, width: int) -> int:
    """A row tile's height in image rows for an image of ``height`` x
    ``width``: ``ROW_TILE`` up to ``WIDE`` columns, else the image's rows
    split evenly, in whole ``BLOCK``s, into the fewest tiles of at most
    ROW_TILE x WIDE pixels: 256 rows for 512 x 8704 (a tile at most 480)."""
    if width <= WIDE:
        return ROW_TILE
    most = max(BLOCK, ROW_TILE * WIDE // width // BLOCK * BLOCK)
    tiles = -(-height // most)
    return -(-height // (tiles * BLOCK)) * BLOCK


def map_tile(height: int, width: int, stride: int) -> int:
    """The row tile, in map rows, of a ``height`` x ``width`` map at
    ``stride`` image rows a map row."""
    return tile_rows(height * stride, width * stride) // stride


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
