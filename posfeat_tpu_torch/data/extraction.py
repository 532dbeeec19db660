"""Single-image extraction datasets: HPatches, Aachen Day-Night, ETH-LFB
(posfeat_tpu/data/extraction.py; reference datasets/hpatches.py,
aachen.py, ETH_local_feature.py).

Each item is {'im1': normalized f32 HWC or None, 'im1_ori': uint8 HWC,
'coord1': SIFT [N, 2] or [0, 2], 'name1': str, 'pad1': (0, 0, 0, 0)}
after the %16 crop. Only the SIFT passthrough (the extractor's
``use_sift``) needs host SIFT keypoints and the host-normalized image:
``compute_sift`` and ``compute_normalize`` in the config ask for them
(both default True, as in the JAX datasets; the learned path sets them
False and normalizes on the device); the host normalization runs the
native library (``data/native.py``). ``num_shards`` / ``shard_index``
take every ``num_shards``-th image from ``shard_index`` of the sorted
list, the shard of one extraction process of several.
Binary PPM (P6, maxval 255: the HPatches images) is read with numpy;
every other file goes to ``cv2``, imported where such an image is read.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict

import numpy as np

from .native import normalize_crop16
from .utils import crop_mod16, sift_keypoints


# "P6", width, height and maxval, separated by whitespace and "#" comments,
# then one whitespace byte before the pixels
_SEP = rb"(?:\s|#[^\n]*\n)+"
_P6_HEADER = re.compile(rb"P6" + _SEP + rb"(\d+)" + _SEP + rb"(\d+)" + _SEP + rb"(\d+)\s")


def read_ppm_p6(path: str):
    """uint8 [H, W, 3] RGB of a binary PPM with maxval 255, or None for any
    other file."""
    with open(path, "rb") as f:
        if f.read(2) != b"P6":
            return None
        data = b"P6" + f.read()
    m = _P6_HEADER.match(data)
    if m is None:
        raise ValueError(f"{path}: bad PPM header")
    w, h, maxval = (int(g) for g in m.groups())
    if maxval != 255:
        return None
    n = h * w * 3
    if len(data) - m.end() < n:
        raise ValueError(f"{path}: PPM holds {len(data) - m.end()} pixel bytes, not {n}")
    return np.frombuffer(data, np.uint8, count=n, offset=m.end()).reshape(h, w, 3).copy()


def _imread_rgb(path: str) -> np.ndarray:
    im = read_ppm_p6(path)
    if im is not None:
        return im
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
    """Common loader: glob, crop %16, and where asked, host SIFT keypoints
    and the ImageNet-normalized image."""

    def __init__(self, configs: Dict):
        self.configs = configs
        self.compute_sift = bool(configs.get("compute_sift", True))
        self.compute_normalize = bool(configs.get("compute_normalize", True))
        self.imfs = self._glob_images(configs)
        # host i of n extracts images i, i+n, i+2n, ... (posfeat_tpu/data/extraction.py:47-53)
        n_shards = int(configs.get("num_shards", 1))
        shard = int(configs.get("shard_index", 0))
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard_index {shard} is not in [0, num_shards = {n_shards})")
        if n_shards > 1:
            self.imfs = self.imfs[shard::n_shards]

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
            "im1": normalize_crop16(im) if self.compute_normalize else None,
            "im1_ori": im,
            "coord1": sift_keypoints(im) if self.compute_sift else np.zeros((0, 2), np.float32),
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
