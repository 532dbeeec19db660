"""Host-side image helpers (posfeat_tpu/data/utils.py subset; reference
datasets/data_utils.py)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop_mod16(im: np.ndarray) -> np.ndarray:
    """Crop H and W down to multiples of 16 (hpatches.py:36-38)."""
    h, w = im.shape[:2]
    return im[: h - h % 16, : w - w % 16]
