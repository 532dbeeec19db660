"""Spatial (image-height) sharding of extraction over several devices
(posfeat_tpu/parallel/spatial.py:31-75).

The JAX package shards the image's H axis over a 1-D mesh and lets
XLA's SPMD partitioner insert the halo exchanges and collectives.
PyTorch has no partitioner, so this module runs the banded program by
hand, in one process over an ordered device list:

- the image's rows split into bands, one per device, each a whole number
  of 16-row blocks (ResUNet's deepest map is at H/16, so every stride-2
  layer splits on even rows), bands differing by one block at most; an
  image with fewer blocks than devices uses as many devices as it has
  blocks;
- each device holds a replica of the model, made once; where the list
  names one device twice, its bands share one replica;
- every windowed op reads its halo rows from the neighbouring bands,
  every global statistic (instance-norm moments, maxima, the top-k merge)
  is reduced on the first device (``banded_ops``, ``banded_models``,
  ``banded_detect``); nothing is read on the host, so the devices do not
  wait for each other.

Extraction runs the model in eval mode, so the banded program computes
the unsharded function, and differs from the unsharded run by rounding
only: the instance-norm sums add in another order, and so do the convs
where the library picks its algorithm by the map's height (oneDNN on the
CPU; on the card cuDNN's TF32 convs, which the bf16 decoder's
f32-accumulated convs take, while its other convs give the unsharded
elements; tools/spatial_rounding_torch.py shows each). The fused head
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

from .banded_models import posfeat_extract
from .banded_ops import split_rows

BLOCK = 16  # rows of one band block: ResUNet's stride to its deepest map


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

    def plan(self, height: int) -> List[int]:
        """First rows of the bands of an image of ``height`` rows: whole
        16-row blocks, at most one block apart, one band per device or per
        block, whichever is fewer."""
        if height % BLOCK or height <= 0:
            raise ValueError(f"spatial bands take whole {BLOCK}-row blocks; the image has {height} rows")
        blocks = height // BLOCK
        n = min(len(self.devices), blocks)
        base, extra = divmod(blocks, n)
        starts, r = [], 0
        for i in range(n):
            starts.append(r)
            r += BLOCK * (base + (i < extra))
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
        starts = mesh.plan(H)
        devs = mesh.devices[: len(starts)]
        outputs = posfeat_extract(split_rows(im, devs, starts), [replicas[d] for d in devs])
        return outputs if postprocess is None else postprocess(outputs)

    return run


__all__ = ["SpatialMesh", "check_model", "spatial_extract", "spatial_mesh"]
