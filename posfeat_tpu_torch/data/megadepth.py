"""MegaDepth (CAPS subset) training pairs with pose-derived fundamental
matrices (posfeat_tpu/data/megadepth.py; reference
datasets/megadepth.py:255-513, MegaDepth_SIFT, the variant both shipped
train configs name).

The scan reads ``<root>/<scene>/dense*/aligned/`` for ``img_cam.txt``
(name, w, h, fx, fy, cx, cy, the world-to-camera rotation row by row and
the translation), ``pairs.txt`` (two image names per line) and
``images/``. Scenes with more than 5000 pairs keep 5000, drawn with
``RandomState(234)``, and the pair list is shuffled with it.

All geometry is host-side numpy; images are ImageNet-normalized f32 HWC.
A pair that fails the rotation or keypoint filters returns None (the
loader skips it, as the reference's my_collate does, trainer.py:147-150).
The JAX dataset draws each sample's query points and jitter from a fresh
``np.random.RandomState()``; this one draws them from
``RandomState([seed, item, visit])``, where ``visit`` counts the earlier
reads of the item, so a run is reproducible from its seed and an item
read again in a later epoch gets new draws.
"""

from __future__ import annotations

import collections
import glob
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from . import utils as dutils
from .extraction import _imread_rgb

Image = collections.namedtuple("Image", ["name", "w", "h", "fx", "fy", "cx", "cy", "rvec", "tvec"])
PAIRS_PER_SCENE = 5000


class MegaDepth_SIFT:
    """``configs``: data_path, num_pts, random_percent, rot_thr and
    prune_kp (reference train_desc.yaml:38-45). ``seed``: the root of the
    per-sample generators."""

    def __init__(self, configs: Dict, is_train: bool = True, seed: int = 0):
        self.configs = configs
        self.is_train = is_train
        self.seed = int(seed)
        self.root = configs["data_path"]
        self.images = self._read_img_cam()
        self.imf1s, self.imf2s = self._read_pairs()
        print(f"total number of image pairs loaded: {len(self.imf1s)}")
        index = np.arange(len(self.imf1s))
        np.random.RandomState(234).shuffle(index)
        self.imf1s = [self.imf1s[i] for i in index]
        self.imf2s = [self.imf2s[i] for i in index]
        self._visits = collections.Counter()
        self._lock = threading.Lock()

    # --------------------------------------------------------- scanning

    def _scene_folders(self) -> List[str]:
        folders = []
        for scene in sorted(glob.glob(os.path.join(self.root, "*"))):
            if not os.path.isdir(scene):
                continue
            for densef in sorted(os.listdir(scene)):
                if "dense" in densef and os.path.isdir(os.path.join(scene, densef)):
                    folders.append(os.path.join(scene, densef, "aligned"))
        return folders

    def _read_img_cam(self) -> Dict[str, Image]:
        images = {}
        for folder in self._scene_folders():
            txt = os.path.join(folder, "img_cam.txt")
            if not os.path.exists(txt):
                continue
            with open(txt) as fid:
                for line in fid:
                    line = line.strip()
                    if not line or line[0] == "#":
                        continue
                    e = line.split()
                    images[os.path.join(folder, "images", e[0])] = Image(
                        name=e[0], w=int(e[1]), h=int(e[2]),
                        fx=float(e[3]), fy=float(e[4]), cx=float(e[5]), cy=float(e[6]),
                        rvec=np.array(e[7:16], np.float64), tvec=np.array(e[16:19], np.float64),
                    )
        return images

    def _read_pairs(self):
        imf1s, imf2s = [], []
        rand = np.random.RandomState(234)
        for folder in self._scene_folders():
            pairf = os.path.join(folder, "pairs.txt")
            if not os.path.exists(pairf):
                continue
            p1, p2 = [], []
            with open(pairf) as f:
                for line in f:
                    a, b = line.strip().split(" ")
                    p1.append(os.path.join(folder, "images", a))
                    p2.append(os.path.join(folder, "images", b))
            if len(p1) > PAIRS_PER_SCENE:  # balance pairs per scene (megadepth.py:340-344)
                index = np.arange(len(p1))
                rand.shuffle(index)
                p1 = [p1[i] for i in index[:PAIRS_PER_SCENE]]
                p2 = [p2[i] for i in index[:PAIRS_PER_SCENE]]
            imf1s.extend(p1)
            imf2s.extend(p2)
        return imf1s, imf2s

    # --------------------------------------------------------- geometry

    @staticmethod
    def _intrinsics(meta: Image) -> np.ndarray:
        return np.array([[meta.fx, 0, meta.cx], [0, meta.fy, meta.cy], [0, 0, 1]], np.float64)

    @staticmethod
    def _extrinsics(meta: Image) -> np.ndarray:
        e = np.eye(4)
        e[:3, :3] = meta.rvec.reshape(3, 3)
        e[:3, 3] = meta.tvec
        return e

    def _query_kpts(self, img, num_pts, h, w, rng) -> np.ndarray:
        """Mixed random + SIFT query candidates [N, 3] (x, y, is_sift)
        (megadepth.py:358-391)."""
        frac = self.configs["random_percent"]
        kx = rng.rand(int(frac * num_pts)) * (w - 1)
        ky = rng.rand(int(frac * num_pts)) * (h - 1)
        kp_rand = np.stack((kx, ky, np.zeros_like(kx))).T
        kp_sift = dutils.sift_keypoints(img, nfeatures=int((1 - frac) * num_pts))
        if len(kp_sift) == 0:
            return kp_rand
        kp_sift = np.concatenate([kp_sift, np.ones_like(kp_sift[:, :1])], axis=1)
        return np.concatenate((kp_rand, kp_sift), 0)

    # ------------------------------------------------------------ access

    def __len__(self):
        return len(self.imf1s)

    def __getitem__(self, item: int) -> Optional[Dict]:
        with self._lock:
            visit = self._visits[item]
            self._visits[item] += 1
        return self.sample(item, np.random.RandomState([self.seed, item, visit]))

    def sample(self, item: int, rng: np.random.RandomState) -> Optional[Dict]:
        """Pair ``item`` with its query points and jitter drawn from ``rng``;
        None when a filter rejects it."""
        imf1, imf2 = self.imf1s[item], self.imf2s[item]
        m1, m2 = self.images[imf1], self.images[imf2]
        im1 = _imread_rgb(imf1)
        im2 = _imread_rgb(imf2)
        h1, w1 = im1.shape[:2]
        h2, w2 = im2.shape[:2]

        K1, K2 = self._intrinsics(m1), self._intrinsics(m2)
        E1, E2 = self._extrinsics(m1), self._extrinsics(m2)
        rot_thr = self.configs["rot_thr"]
        F1, rel1 = dutils.relative_pose_to_fundamental(K1, K2, E1, E2)
        if self.is_train and dutils.rotation_angle_deg(rel1[:3, :3]) > rot_thr:
            return None
        F2, rel2 = dutils.relative_pose_to_fundamental(K2, K1, E2, E1)
        if self.is_train and dutils.rotation_angle_deg(rel2[:3, :3]) > rot_thr:
            return None

        num_pts = self.configs["num_pts"]
        coord1 = self._query_kpts(im1, 10 * num_pts, h1, w1, rng)
        coord2 = self._query_kpts(im2, 10 * num_pts, h2, w2, rng)
        if len(coord1) == 0 or len(coord2) == 0:
            return None

        if self.configs.get("prune_kp"):
            ind1 = dutils.prune_kpts(coord1[:, :2], F1, im2.shape[:2], K1, K2, rel1, d_min=4, d_max=400)
            if ind1.sum() == 0:
                return None
            coord1 = coord1[ind1]
            ind2 = dutils.prune_kpts(coord2[:, :2], F2, im1.shape[:2], K2, K1, rel2, d_min=4, d_max=400)
            if ind2.sum() == 0:
                return None
            coord2 = coord2[ind2]

        if len(coord1) < num_pts or len(coord2) < num_pts:
            return None
        coord1 = dutils.random_choice(coord1, num_pts).astype(np.float32)
        coord2 = dutils.random_choice(coord2, num_pts).astype(np.float32)

        F1 = (F1 / (F1[-1, -1] + 1e-10)).astype(np.float32)
        F2 = (F2 / (F2[-1, -1] + 1e-10)).astype(np.float32)

        if self.is_train:
            im1_aug = dutils.color_jitter(im1, rng)
            im2_aug = dutils.color_jitter(im2, rng)
        else:
            im1_aug, im2_aug = im1, im2

        return {
            "im1": dutils.normalize_image(im1_aug),
            "im2": dutils.normalize_image(im2_aug),
            "im1_ori": im1,
            "im2_ori": im2,
            "pose1": rel1[:3, :].astype(np.float32),
            "pose2": rel2[:3, :].astype(np.float32),
            "F1": F1,
            "F2": F2,
            "intrinsic1": K1.astype(np.float32),
            "intrinsic2": K2.astype(np.float32),
            "coord1": coord1,
            "coord2": coord2,
            "name1": m1.name,
            "name2": m2.name,
        }
