"""Valid window pooling and padding on NHWC maps
(posfeat_tpu/ops/pooling.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int, stride: int = 1) -> torch.Tensor:
    """Valid (unpadded) average pooling. x: [B, H, W, C]."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride))


def max_pool2d(x: torch.Tensor, window: int, stride: int = 1) -> torch.Tensor:
    """Valid (unpadded) max pooling. x: [B, H, W, C]."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def pad2d(x: torch.Tensor, pad, mode: str = "constant", value: float = 0.0):
    """Pad H and W of [B, H, W, C]. pad = (left, right, top, bottom);
    mode 'constant' or 'reflect'."""
    y = F.pad(_nchw(x), tuple(pad), mode=mode, value=value if mode == "constant" else None)
    return _nhwc(y)
