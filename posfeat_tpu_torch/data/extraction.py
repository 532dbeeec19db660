"""Single-image extraction datasets: HPatches, Aachen Day-Night, ETH-LFB
(posfeat_tpu/data/extraction.py; reference datasets/hpatches.py,
aachen.py, ETH_local_feature.py).

Each item is {'im1': None, 'im1_ori': uint8 HWC, 'coord1': [0, 2],
'name1': str, 'pad1': (0, 0, 0, 0)} after the %16 crop: the extractor
normalizes on the device. Host SIFT keypoints (for the SIFT passthrough)
and multi-host sharding of the image list are not ported yet
(ROADMAP.md queue 1, item 7). ``cv2`` is imported where an image is read.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from .utils import crop_mod16


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if im is None:
        raise FileNotFoundError(path)
    if im.ndim == 2:
        return cv2.cvtColor(im, cv2.COLOR_GRAY2RGB)
    if im.shape[2] == 4:
        return cv2.cvtColor(im, cv2.COLOR_BGRA2RGB)
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


class _SingleImageDataset:
    """Common loader: glob, crop %16."""

    def __init__(self, configs: Dict):
        self.configs = configs
        self.imfs = self._glob_images(configs)

    def _glob_images(self, configs):  # pragma: no cover - overridden
        raise NotImplementedError

    def _name(self, imf: str) -> str:  # pragma: no cover - overridden
        raise NotImplementedError

    def __len__(self):
        return len(self.imfs)

    def __getitem__(self, item: int) -> Dict:
        imf = self.imfs[item]
        im = crop_mod16(_imread_rgb(imf))
        return {
            "im1": None,
            "im1_ori": im,
            "coord1": np.zeros((0, 2), np.float32),
            "name1": self._name(imf),
            "pad1": (0, 0, 0, 0),
        }


class HPatch_SIFT(_SingleImageDataset):
    """hpatches-sequences-release: */*.ppm (reference hpatches.py:10-47)."""

    def _glob_images(self, configs):
        return sorted(glob.glob(os.path.join(configs["data_path"], "*", "*.ppm")))

    def _name(self, imf):
        return "/".join(imf.split("/")[-2:])


class Aachen_Day_Night(_SingleImageDataset):
    """Aachen images_upright db/query/sequences (reference aachen.py:10-65)."""

    def _glob_images(self, configs):
        root = configs["data_path"]
        imfs = glob.glob(os.path.join(root, "db", "*.jpg"))
        imfs += glob.glob(os.path.join(root, "query", "*", "*", "*.jpg"))
        imfs += glob.glob(os.path.join(root, "sequences", "gopro3_undistorted", "*.png"))
        imfs += glob.glob(os.path.join(root, "sequences", "nexus4_sequences", "*", "*.png"))
        return sorted(imfs)

    def _name(self, imf):
        parts = imf.split("/")
        if "db" in parts:
            return "/".join(parts[-2:])
        if "query" in parts or "nexus4_sequences" in parts:
            return "/".join(parts[-4:])
        if "gopro3_undistorted" in parts:
            return "/".join(parts[-3:])
        return "/".join(parts[-2:])


class ETH_LFB(_SingleImageDataset):
    """ETH local-feature-benchmark scene (reference ETH_local_feature.py)."""

    def _glob_images(self, configs):
        return sorted(
            glob.glob(os.path.join(configs["data_path"], configs["subfolder"], "images", "*"))
        )

    def _name(self, imf):
        return "{}/{}".format(self.configs["subfolder"], os.path.basename(imf))
