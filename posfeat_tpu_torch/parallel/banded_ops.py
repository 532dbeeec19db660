"""Row bands of NHWC maps and the banded primitives of the spatial program
(the counterpart of what XLA's SPMD partitioner inserts for
posfeat_tpu/parallel/spatial.py: halo exchanges for windowed ops,
collectives for global statistics).

A ``Bands`` holds one map split along its H axis: band i is rows
``starts[i] .. starts[i + 1]`` of the map, on its own device. Every
windowed op takes the rows it needs from its neighbours (``halo``,
``gather``): across cards they move with ``.to(device,
non_blocking=True)``, on one device they are a slice. Padding happens
only at the map's global top and bottom edges, in the mode the
unsharded op pads with; columns are whole in every band, so they pad as
the unsharded op does. Global sums and maxima are reduced on the first
band's device and sent back. Nothing here reads a value on the host, so
the bands' devices run without waiting for each other.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from ..ops.conv_tiles import map_tile, row_tiled_conv
from ..ops.moments import check_dims, moments, normalize, row_moments
from ..ops.pooling import avg_pool2d, pad2d
from ..ops.priors import ssim_from_shifts


@dataclass
class Bands:
    """One NHWC map as row bands. ``parts[i]`` holds global rows
    ``starts[i]`` to ``starts[i] + parts[i].shape[1]`` of ``total``."""

    parts: List[torch.Tensor]
    starts: List[int]
    total: int

    def __len__(self):
        return len(self.parts)

    @property
    def stops(self) -> List[int]:
        return [a + p.shape[1] for a, p in zip(self.starts, self.parts)]

    def map(self, fn: Callable, *others: "Bands") -> "Bands":
        """A pointwise op on each band (with the same bands of ``others``)."""
        return Bands([fn(p, *(o.parts[i] for o in others)) for i, p in enumerate(self.parts)],
                     list(self.starts), self.total)

    def with_parts(self, parts: Sequence[torch.Tensor], total: int = None) -> "Bands":
        """New parts on the same bands of a map of ``total`` rows (this
        map's by default): each band's first row scales with the height."""
        total = self.total if total is None else total
        starts = [a * total // self.total for a in self.starts]
        assert all(a * total % self.total == 0 for a in self.starts), (self.starts, total)
        return Bands(list(parts), starts, total)

    def owner(self, row: int) -> int:
        return bisect.bisect_right(self.starts, row) - 1

    def gather(self, i: int, rows: Sequence, value: float = 0.0) -> torch.Tensor:
        """Global rows ``rows`` (``None`` for a row of ``value``) as one
        tensor on band i's device, runs of consecutive rows of one band
        moved as one slice."""
        ref = self.parts[i]
        segs, run = [], None  # run: [band, first local row, count] or [None, count]
        for r in rows:
            if r is None:
                if run is not None and run[0] is None:
                    run[1] += 1
                    continue
                run = [None, 1]
            else:
                j = self.owner(r)
                loc = r - self.starts[j]
                if run is not None and run[0] == j and run[1] + run[2] == loc:
                    run[2] += 1
                    continue
                run = [j, loc, 1]
            segs.append(run)
        out = []
        for s in segs:
            if s[0] is None:
                shape = (ref.shape[0], s[1]) + tuple(ref.shape[2:])
                out.append(torch.full(shape, value, dtype=ref.dtype, device=ref.device))
            else:
                out.append(self.parts[s[0]].narrow(1, s[1], s[2]).to(ref.device, non_blocking=True))
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)

    def source_row(self, r: int, mode: str):
        """The map row that row ``r`` (maybe outside the map) reads under
        ``mode``: 'constant' (None outside), 'reflect', 'replicate'."""
        n = self.total
        if 0 <= r < n:
            return r
        if mode == "constant":
            return None
        if mode == "replicate":
            return min(max(r, 0), n - 1)
        if mode == "reflect":
            return -r if r < 0 else 2 * (n - 1) - r
        raise ValueError(f"unknown pad mode {mode!r}")

    def halo(self, top: int, bottom: int, mode: str = "constant", value: float = 0.0) -> List[torch.Tensor]:
        """Each band with ``top`` rows above and ``bottom`` below from its
        neighbours (a negative count drops rows), padded by ``mode`` at
        the map's edges only."""
        out = []
        for i, (a, b) in enumerate(zip(self.starts, self.stops)):
            lo, hi = a - top, b + bottom
            own_lo, own_hi = max(lo, a), min(hi, b)
            pieces = []
            if lo < a:
                pieces.append(self.gather(i, [self.source_row(r, mode) for r in range(lo, a)], value))
            pieces.append(self.parts[i].narrow(1, own_lo - a, own_hi - own_lo))
            if hi > b:
                pieces.append(self.gather(i, [self.source_row(r, mode) for r in range(b, hi)], value))
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1))
        return out

    def concat(self, device=None) -> torch.Tensor:
        """The whole map on ``device`` (the first band's by default)."""
        dev = self.parts[0].device if device is None else device
        return torch.cat([p.to(dev) for p in self.parts], dim=1)


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], starts: Sequence[int]) -> Bands:
    """[B, H, ...] -> Bands with band i from row ``starts[i]`` on
    ``devices[i]``."""
    stops = list(starts[1:]) + [x.shape[1]]
    parts = [x[:, a:b].to(d, non_blocking=True) for a, b, d in zip(starts, stops, devices)]
    return Bands(parts, list(starts), x.shape[1])


# ------------------------------------------------------------ reductions


def global_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ of per-band partial tensors, on the first band's device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev, non_blocking=True)
    return out


def global_max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise maximum of per-band partial tensors, on the first band's device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev, non_blocking=True))
    return out


def broadcast(t: torch.Tensor, x: Bands) -> List[torch.Tensor]:
    """``t`` on every band's device."""
    return [t.to(p.device, non_blocking=True) for p in x.parts]


# ----------------------------------------------------------- windowed ops


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x: Bands, weights: Sequence[torch.Tensor], biases=None, stride=1, padding=0,
           dilation=1, tile=None) -> Bands:
    """F.conv2d with zero padding on NHWC bands: band i's output rows are
    its own rows / stride (the last band's to the map's end), run by
    ``row_tiled_conv`` on the rows they read, gathered from the
    neighbouring bands, one call a band or, with ``tile``, one call a
    tile of the whole map: where the bands begin on tile boundaries,
    every call is then the unsharded program's. ``weights[i]`` [out, in,
    kh, kw] lives on band i's device."""
    kh = weights[0].shape[2]
    (sh, _), (ph, _), (dh, _) = _pair(stride), _pair(padding), _pair(dilation)
    out_total = (x.total + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    parts = []
    for i, (a, b) in enumerate(zip(x.starts, x.stops)):
        oa, ob = a // sh, (b // sh if b < x.total else out_total)
        lo, hi = max(oa * sh - ph, 0), min((ob - 1) * sh - ph + (kh - 1) * dh + 1, x.total)
        e = x.gather(i, range(lo, hi))
        bias = None if biases is None or biases[i] is None else biases[i].to(e.dtype)
        y = row_tiled_conv(_nchw(e), weights[i].to(e.dtype), bias, stride, padding, dilation, tile, lo, x.total,
                           (oa, ob))
        parts.append(_nhwc(y))
    return x.with_parts(parts, out_total)


def conv_module(x: Bands, convs) -> Bands:
    """Each band through its replica of one ``nn.Conv2d`` (weights cast
    to the input's dtype, as the port's ``Conv2d`` does), in its map's row
    tiles where it has them."""
    c = convs[0]
    stride = getattr(c, "row_stride", None)
    tile = None if stride is None else map_tile(x.total, x.parts[0].shape[2], stride)
    return conv2d(x, [m.weight for m in convs], [m.bias for m in convs], c.stride, c.padding, c.dilation, tile)


def module_nchw(x: Bands, mods) -> Bands:
    """A pointwise NCHW module (eval BatchNorm) on each band."""
    return Bands([_nhwc(m(_nchw(p))) for m, p in zip(mods, x.parts)], list(x.starts), x.total)


def max_pool2d(x: Bands, window: int, stride: int, padding: int) -> Bands:
    """F.max_pool2d(window, stride, padding) on NHWC bands: −inf rows only
    beyond the map's top and bottom edges."""
    ext = x.halo(padding, window - 1 - padding + 1 - stride, value=float("-inf"))
    parts = [_nhwc(F.max_pool2d(_nchw(e), window, stride, (0, padding))) for e in ext]
    return x.with_parts(parts, x.total // stride)


def resize(x: Bands, size, align_corners: bool) -> Bands:
    """F.interpolate's bilinear resize of NHWC bands to ``size`` = (H, W)
    by an integer row factor, bit for bit the unsharded call's rows.

    With ``align_corners=False`` and a power-of-two factor the source rows
    of output row o are o/f + const: each band goes through F.interpolate
    with one row of its neighbours above and below (none beyond the map's
    edges, where the kernel's own clamp acts). With ``align_corners=True``
    the source row o·(h−1)/(fh−1) depends on the whole height, so the band
    and its two halo rows sit at their place in a zero map of the whole
    height, F.interpolate runs on that, and the band keeps its rows."""
    out_h, out_w = int(size[0]), int(size[1])
    f, rem = divmod(out_h, x.total)
    if rem or f < 1:
        raise ValueError(f"banded resize takes an integer row factor, got {x.total} -> {out_h}")
    parts = []
    for i, (a, b) in enumerate(zip(x.starts, x.stops)):
        top, bottom = int(a > 0), int(b < x.total)
        e = x.gather(i, range(a - top, b + bottom))
        if align_corners or f & (f - 1):
            canvas = e.new_zeros((e.shape[0], x.total) + tuple(e.shape[2:]))
            canvas[:, a - top : b + bottom] = e
            y = _nhwc(F.interpolate(_nchw(canvas), size=(out_h, out_w), mode="bilinear", align_corners=align_corners))
            parts.append(y[:, f * a : f * b].clone())
        else:
            y = _nhwc(F.interpolate(_nchw(e), size=(f * e.shape[1], out_w), mode="bilinear", align_corners=False))
            parts.append(y[:, f * top : f * (top + b - a)])
    return x.with_parts(parts, out_h)


def instance_norm(x: Bands, eps: float = 1e-5, dims=(1, 2)) -> Bands:
    """Non-affine InstanceNorm over ``dims`` (every axis between the batch
    and the channels) of all bands, bit for bit ``instance_norm``: each
    band's f32 row partials (``ops/moments.py`` ``row_moments``, the
    kernel on the card) concatenated in row order on the first device,
    [B, H, C] as the unsharded map's, and the same sum over the rows."""
    for p in x.parts:
        check_dims(p, dims)
    rows = [row_moments(p) for p in x.parts]
    dev = x.parts[0].device
    s1 = torch.cat([r[0].to(dev, non_blocking=True) for r in rows], dim=1)
    s2 = torch.cat([r[1].to(dev, non_blocking=True) for r in rows], dim=1)
    n = x.total * math.prod(x.parts[0].shape[2:-1])
    mean, rstd = moments(s1, s2, n, eps)
    parts = [normalize(p, m, r) for p, m, r in zip(x.parts, broadcast(mean, x), broadcast(rstd, x))]
    return Bands(parts, list(x.starts), x.total)


def sample_max(x: Bands) -> List[torch.Tensor]:
    """Each sample's maximum over all bands, [B, 1, 1, 1] on each band."""
    B = x.parts[0].shape[0]
    m = global_max([p.reshape(B, -1).amax(dim=1) for p in x.parts]).reshape(B, 1, 1, 1)
    return broadcast(m, x)


# ---------------------------------------------------------------- priors


def ssim_prior(x: Bands) -> Bands:
    """``ssim_prior`` on bands. Its shifted maps read reflect-padded rows:
    x_lu row r is |x| at reflect(r); x_rb row r is |x|'s row-shifted pad
    (row r + 1, and row H − 2 for the last) at reflect(r)."""
    n = x.total

    def rb(r):
        r = x.source_row(r, "reflect")
        return r + 1 if r < n - 1 else n - 2

    parts = []
    for i, (a, b) in enumerate(zip(x.starts, x.stops)):
        lu = x.gather(i, [x.source_row(r, "reflect") for r in range(a - 1, b + 1)]).abs()
        rbt = x.gather(i, [rb(r) for r in range(a - 1, b + 1)]).abs()
        x_lu = pad2d(lu, (1, 1, 0, 0), mode="reflect")
        x_rb = pad2d(pad2d(rbt, (0, 1, 0, 0), mode="reflect")[:, :, 1:], (1, 1, 0, 0), mode="reflect")
        parts.append(ssim_from_shifts(x_lu, x_rb))
    return Bands(parts, list(x.starts), x.total)


def d2_prior(x: Bands) -> Bands:
    """``d2_prior`` on bands: the per-sample maximum over all bands, and
    the 3×3 window sum padded with ones at the map's edges."""
    x = x.map(F.relu)
    mx = sample_max(x)
    e = Bands([torch.exp(p / m) for p, m in zip(x.parts, mx)], list(x.starts), x.total)
    ext = e.halo(1, 1, value=1.0)
    parts = []
    for p, ep, q in zip(e.parts, ext, x.parts):
        sum_exp = 9 * avg_pool2d(pad2d(ep, (1, 1, 0, 0), mode="constant", value=1.0), 3, 1)
        depth = q / q.amax(dim=-1, keepdim=True)
        parts.append(((p / sum_exp) * depth).amax(dim=-1, keepdim=True))
    return Bands(parts, list(x.starts), x.total)


def asl_peak_prior(x: Bands) -> Bands:
    """``asl_peak_prior`` on bands: the per-sample maximum over all bands,
    the 3×3 mean reflect-padded at the map's edges."""
    mx = sample_max(x)
    y = Bands([p / m for p, m in zip(x.parts, mx)], list(x.starts), x.total)
    ext = y.halo(1, 1, "reflect")
    parts = []
    for p, ep in zip(y.parts, ext):
        alpha = F.softplus(p - avg_pool2d(pad2d(ep, (1, 1, 0, 0), mode="reflect"), 3, 1))
        beta = F.softplus(p - p.mean(dim=-1, keepdim=True))
        parts.append((alpha * beta).amax(dim=-1, keepdim=True))
    return Bands(parts, list(x.starts), x.total)


def identity_prior(x: Bands) -> Bands:
    """KeypointDet's identity prior: ones_like(x).mean(-1)."""
    return x.map(lambda p: torch.ones_like(p).mean(dim=-1, keepdim=True))


PRIORS = {"SSIM": ssim_prior, "D2": d2_prior, "ASL_Peak": asl_peak_prior, "identity": identity_prior}
