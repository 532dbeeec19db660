"""Synthetic geometric image pairs (posfeat_tpu/data/synthetic.py).

Textured images related by a random homography H, with geometrically
valid fundamental matrices: for a planar scene any F = [e']x H satisfies
x2ᵀ F x1 = 0 for every correspondence, so the epipolar losses have real
signal without MegaDepth on disk.

The JAX dataset draws from ``np.random.RandomState(1000 + item)`` in the
order texture, noise, angle, scale, shifts, perspective, photometric, e2,
e1, points; this one draws the same numbers in the same order, so F1, F2,
coord1 and coord2 equal the JAX dataset's. It needs no OpenCV: the
texture upsample is OpenCV's bicubic (a = -0.75, half-pixel centres,
replicated border) written in numpy, and the reflect-border perspective
warp is ``scipy.ndimage.map_coordinates``, so pixels differ from the JAX
dataset's only by interpolation rounding.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import utils as dutils


def _cubic_taps(n_src: int, n_dst: int):
    """Indices [n_dst, 4] and weights [n_dst, 4] of OpenCV's INTER_CUBIC
    along one axis."""
    a = -0.75
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    s = np.floor(f)
    t = (f - s)[:, None]
    x = np.concatenate([t + 1, t, 1 - t, 2 - t], axis=1)  # distances to the 4 taps
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    wts = np.where(x <= 1, near, far)
    idx = np.clip(s[:, None].astype(np.int64) + np.arange(-1, 3)[None], 0, n_src - 1)
    return idx, wts


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC) for a float
    HWC image."""
    iy, wy = _cubic_taps(img.shape[0], h)
    ix, wx = _cubic_taps(img.shape[1], w)
    x = img.astype(np.float64)
    rows = np.einsum("hk,hkwc->hwc", wy, x[iy])
    out = np.einsum("wk,hwkc->hwc", wx, rows[:, ix])
    return out.astype(np.float32)


def warp_perspective_reflect(img: np.ndarray, H: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.warpPerspective(img, H, (w, h), borderMode=cv2.BORDER_REFLECT)
    for a uint8 HWC image: bilinear, each output pixel read at H⁻¹ of its
    position, the border mirrored with the edge pixel repeated."""
    from scipy import ndimage

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.linalg.inv(H) @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    coords = np.stack([pts[1] / pts[2], pts[0] / pts[2]]).reshape(2, h, w)
    out = np.stack(
        [ndimage.map_coordinates(img[..., c].astype(np.float32), coords, order=1, mode="reflect")
         for c in range(img.shape[2])],
        axis=-1,
    )
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: [2, 3] rotation by ``angle`` degrees about
    ``center`` with ``scale``."""
    a = angle * (np.pi / 180.0)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ])


def _texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Smooth random RGB texture with local contrast."""
    base = rng.rand(h // 8, w // 8, 3).astype(np.float32)
    img = resize_cubic(base, h, w)
    noise = rng.rand(h, w, 3).astype(np.float32) * 0.15
    img = np.clip(img + noise, 0, 1)
    return (img * 255).astype(np.uint8)


class SyntheticPairs:
    """Drop-in replacement for MegaDepth_SIFT on synthetic data.

    configs: {num_pairs, height, width, num_pts, photometric?,
    photo_strength?, num_scenes?, rot_max?, scale_range?}, as the JAX
    dataset reads them: ``photometric`` jitters im2's gain, gamma and
    noise; ``num_scenes: K`` reuses K base textures across the pairs.
    """

    def __init__(self, configs: Dict, is_train: bool = True):
        self.configs = configs
        self.is_train = is_train
        self.n = int(configs.get("num_pairs", 64))
        self.h = int(configs.get("height", 240))
        self.w = int(configs.get("width", 320))
        self.photometric = bool(configs.get("photometric", False))
        self.num_scenes = int(configs.get("num_scenes", 0))  # 0: 1 per pair
        self.rot_max = float(configs.get("rot_max", 15.0))
        self.scale_lo, self.scale_hi = configs.get("scale_range", (0.9, 1.1))
        self.photo_strength = float(configs.get("photo_strength", 1.0))

    def __len__(self):
        return self.n

    def __getitem__(self, item: int) -> Dict:
        rng = np.random.RandomState(1000 + item)
        h, w = self.h, self.w
        if self.num_scenes:
            im1 = _texture(np.random.RandomState(2000 + item % self.num_scenes), h, w)
        else:
            im1 = _texture(rng, h, w)

        # random homography: mild perspective + rotation + translation
        angle = rng.uniform(-self.rot_max, self.rot_max)
        scale = rng.uniform(self.scale_lo, self.scale_hi)
        H = np.eye(3)
        H[:2, :] = rotation_matrix_2d((w / 2, h / 2), angle, scale)
        H[0, 2] += rng.uniform(-0.05, 0.05) * w
        H[1, 2] += rng.uniform(-0.05, 0.05) * h
        H[2, 0] = rng.uniform(-1e-4, 1e-4)
        H[2, 1] = rng.uniform(-1e-4, 1e-4)
        im2 = warp_perspective_reflect(im1, H, w, h)
        if self.photometric:
            s = self.photo_strength
            wf = im2.astype(np.float32) / 255.0
            gain = 1.0 + (rng.uniform(0.5, 1.6, size=3) - 1.0) * s
            gamma = 1.0 + (rng.uniform(0.6, 1.6) - 1.0) * s
            wf = np.clip(wf * gain, 0, 1) ** max(gamma, 0.05)
            wf = np.clip(wf + rng.randn(h, w, 3) * 0.08 * s, 0, 1)
            im2 = (wf * 255).astype(np.uint8)

        # valid F for the planar scene: F = [e2]x H  (and F2 = [e1]x H^-1)
        e2 = rng.randn(3)
        e2[2] = abs(e2[2]) + 0.5
        F1 = dutils.skew(e2) @ H
        e1 = rng.randn(3)
        e1[2] = abs(e1[2]) + 0.5
        F2 = dutils.skew(e1) @ np.linalg.inv(H)
        F1 = (F1 / (F1[-1, -1] + 1e-10)).astype(np.float32)
        F2 = (F2 / (F2[-1, -1] + 1e-10)).astype(np.float32)

        num_pts = int(self.configs.get("num_pts", 256))
        kx = rng.rand(num_pts) * (w - 1)
        ky = rng.rand(num_pts) * (h - 1)
        coord1 = np.stack((kx, ky, np.zeros_like(kx)), axis=-1).astype(np.float32)
        kx2 = rng.rand(num_pts) * (w - 1)
        ky2 = rng.rand(num_pts) * (h - 1)
        coord2 = np.stack((kx2, ky2, np.zeros_like(kx2)), axis=-1).astype(np.float32)

        K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
        return {
            "im1": dutils.normalize_image(im1),
            "im2": dutils.normalize_image(im2),
            "im1_ori": im1,
            "im2_ori": im2,
            "pose1": np.eye(3, 4, dtype=np.float32),
            "pose2": np.eye(3, 4, dtype=np.float32),
            "F1": F1,
            "F2": F2,
            "intrinsic1": K,
            "intrinsic2": K,
            "coord1": coord1,
            "coord2": coord2,
            "homography": H.astype(np.float32),  # im2 = im1 warped by H (not in the JAX sample)
            "name1": f"synthetic/{item}_1",
            "name2": f"synthetic/{item}_2",
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
