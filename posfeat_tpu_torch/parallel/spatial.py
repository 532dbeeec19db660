"""Spatial (image-height) sharding of extraction over several devices
(posfeat_tpu/parallel/spatial.py:31-75).

The JAX package shards the image's H axis over a 1-D mesh and lets
XLA's SPMD partitioner insert the halo exchanges and collectives.
PyTorch has no partitioner, so this module runs the banded program by
hand, in one process over an ordered device list:

- the image's rows split into bands, one per device, each a whole number
  of the conv tiles (``ops/conv_tiles.py`` ``tile_rows``: 512 rows up to
  8192 columns, even tiles of fewer beyond) where the image has two or
  more, else of 16-row blocks (ResUNet's deepest map is at H/16, so
  every stride-2 layer splits on even rows), bands differing by one unit
  at most; an image with fewer units than devices uses as many devices
  as it has units;
- each device holds a replica of the model, made once; where the list
  names one device twice, its bands share one replica;
- every windowed op reads its halo rows from the neighbouring bands,
  every global statistic (instance-norm moments, maxima, the top-k merge)
  is reduced on the first device (``banded_ops``, ``banded_models``,
  ``banded_detect``); nothing is read on the host, so the devices do not
  wait for each other.

Extraction runs the model in eval mode, so the banded program computes
the unsharded function, and on an image of two or more tiles it does so
bit for bit: the head's instance norms sum their moments row by row
(``ops/moments.py``, the same [B, H, C] partials in both programs), and
the convs whose algorithm the library picks by the map's height (on the
card cuDNN's TF32 convs of the bf16 decoder and, on a 12 Mpx frame, its
bf16 convs at H/8 and H/4; oneDNN's on the CPU) run in the same row
tiles in both programs: every decoder conv and every 3x3 stride-1 conv
of the encoder (``ops/conv_tiles.py`` ``row_tiled_conv``).
tools/spatial_rounding_torch.py walks every conv on shared inputs and
shows where the maps part. Every image above 4 Mpx (the default
``spatial_threshold_px``) has two or more tiles, a panorama of at most
512 rows too (two 256-row tiles at 8704 columns). A one-tile image, banded
only under a lower threshold, gets 16-row blocks, and its tiled convs
then round as its bands' calls do. The fused head
(``fused_upsample: "pallas"``) is a single-device kernel and is refused
here: the Extractor swaps it for the ``"phase"`` dataflow, as JAX does.
A configuration the banded program does not run raises before any work;
nothing falls back to the unsharded program.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from ..ops import conv_tiles
from .banded_models import posfeat_extract
from .banded_ops import split_rows

BLOCK = conv_tiles.BLOCK  # rows of one band block: ResUNet's stride to its deepest map


def _normalize(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class SpatialMesh:
    """An ordered list of devices for the ``spatial`` axis; a device may
    appear more than once (its bands then run one after another)."""

    devices: Tuple[torch.device, ...]

    def plan(self, height: int, width: int = conv_tiles.WIDE) -> List[int]:
        """First rows of the bands of an image of ``height`` x ``width``
        (at most 8192 columns where not given), one band per device or per
        unit, whichever is fewer, bands at most one unit apart. The unit
        is the row tile (``conv_tiles.tile_rows``; the last one may be
        shorter) where the image has two or more, so that each band's
        tiled convs are the unsharded program's calls; else a 16-row block
        (a one-tile image's banded convs then round as its bands' calls
        do). Tiles cost balance: a 3024-row frame over 4 devices gets
        bands of 512, 512, 1024 and 976 rows (16-row blocks would give
        752-768), and an image of T tiles uses at most T devices (2048
        rows: 4; a 512x8704 panorama: 2, of 256 rows)."""
        if height % BLOCK or height <= 0:
            raise ValueError(f"spatial bands take whole {BLOCK}-row blocks; the image has {height} rows")
        tile = conv_tiles.tile_rows(height, width)
        unit = tile if height > tile else BLOCK
        units = -(-height // unit)
        n = min(len(self.devices), units)
        base, extra = divmod(units, n)
        # a band more goes to the first bands, or to the last ones where the
        # last tile may be short, so that no band is more than a unit
        # shorter than another
        more = range(extra) if unit == BLOCK else range(n - extra, n)
        starts, r = [], 0
        for i in range(n):
            starts.append(r)
            r += unit * (base + (i in more))
        return starts


def spatial_mesh(devices: Sequence = None) -> SpatialMesh:
    """1-D mesh over ``devices`` (every visible card by default)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("spatial_mesh() with no devices given needs CUDA cards; "
                               "pass a device list, e.g. ['cpu'] * 2")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_normalize(d) for d in devices)
    if not devs:
        raise ValueError("spatial_mesh needs at least one device")
    return SpatialMesh(devs)


def check_model(model) -> None:
    """Raises, before any work, for a model the banded program does not
    run: the fused head, a single-device kernel. Both backbones run
    (ResUNetHR's H/2 trunk takes the head's reference dataflow)."""
    if model.localheader.fused_upsample == "pallas":
        raise ValueError("spatial_shard: the fused head (fused_upsample 'pallas') runs on one device; "
                         "give the banded program a model with the 'phase' dataflow")


def spatial_extract(model, mesh: SpatialMesh, postprocess: Callable = None) -> Callable:
    """``(im [B, H, W, 3]) -> outputs``: ``model.extract`` (a port
    ``PoSFeat``) as the banded program over ``mesh``, with H and W
    multiples of 16 (``_skipconnect`` would pad otherwise).

    Without ``postprocess`` the full-resolution maps come back as
    ``Bands`` (``Bands.concat`` joins one), ``global_feat`` on the first
    device. ``postprocess`` maps that dict to the small products (e.g.
    ``banded_detect.detect`` and ``banded_detect.sample_feat_by_coord``),
    which come back whole on the first device."""
    check_model(model)
    home = next(model.parameters()).device
    replicas = {}
    for d in mesh.devices:
        if d not in replicas:
            replicas[d] = model if d == home else copy.deepcopy(model).to(d)
            replicas[d].eval()

    @torch.inference_mode()
    def run(im: torch.Tensor):
        if im.ndim != 4 or im.shape[-1] != 3:
            raise ValueError(f"spatial_extract takes [B, H, W, 3] images, got {tuple(im.shape)}")
        H, W = im.shape[1:3]
        if H % BLOCK or W % BLOCK:
            raise ValueError(f"spatial_extract: a {H}x{W} image is not a multiple of {BLOCK}, so "
                             "ResUNet's _skipconnect would pad its maps; crop it to %16 as the "
                             "extraction datasets do")
        starts = mesh.plan(H, W)
        devs = mesh.devices[: len(starts)]
        outputs = posfeat_extract(split_rows(im, devs, starts), [replicas[d] for d in devs])
        return outputs if postprocess is None else postprocess(outputs)

    return run


__all__ = ["SpatialMesh", "check_model", "spatial_extract", "spatial_mesh"]
