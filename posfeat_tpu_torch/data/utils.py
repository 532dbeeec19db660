"""Host-side image and geometry helpers (posfeat_tpu/data/utils.py subset; reference
datasets/data_utils.py)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop_mod16(im: np.ndarray) -> np.ndarray:
    """Crop H and W down to multiples of 16 (hpatches.py:36-38)."""
    h, w = im.shape[:2]
    return im[: h - h % 16, : w - w % 16]


def normalize_image(im: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 HWC ImageNet-normalized."""
    x = im.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def skew(x: np.ndarray) -> np.ndarray:
    """Skew-symmetric cross-product matrix (data_utils.py:8-11)."""
    return np.array(
        [[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0]], dtype=np.float64
    )
