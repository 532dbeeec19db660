#!/usr/bin/env python3
"""Write a MegaDepth-layout fixture of pixel-consistent image pairs.

    python3 tools/make_megadepth_fixture.py ROOT [--scenes 2] [--images 4]
        [--height 96] [--width 128] [--seed 0]

The layout is the one ``MegaDepth_SIFT`` scans (reference
datasets/megadepth.py:255-513):

    ROOT/scene<k>/dense0/aligned/img_cam.txt   name w h fx fy cx cy R(9) t(3)
    ROOT/scene<k>/dense0/aligned/pairs.txt     every pair of the scene's images
    ROOT/scene<k>/dense0/aligned/images/<i>.png

Each scene is a textured plane ``Z = DEPTH`` in the world frame, seen by
cameras with small rotations and shifted centres. The texture is noise
under filled circles and boxes, so that SIFT finds keypoints at the
density of a photograph (about 2,300 at 480x640). Image i is the texture
(a wide virtual camera K0 at the world origin) warped by the
plane-induced homography K_i (R_i + t_i nᵀ / d) K0⁻¹, with (R_i, t_i) the
camera's world-to-camera pose, n = (0, 0, 1) and d = DEPTH, so the
fundamental matrix that the dataset derives from ``img_cam.txt`` agrees
with the pixels. Images are PNG (lossless), written with OpenCV.
"""

import argparse
import os

import numpy as np

DEPTH = 10.0


def _rotation(rng, max_deg):
    """A rotation by up to ``max_deg`` degrees about a random axis (Rodrigues)."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def _texture(rng, h, w):
    """uint8 RGB texture rich in SIFT keypoints: three octaves of cubic
    noise under one filled circle or box per 100 pixels."""
    import cv2

    img = np.zeros((h, w, 3), np.float32)
    for step, weight in ((4, 0.25), (16, 0.35), (64, 0.4)):
        base = rng.rand(h // step + 2, w // step + 2, 3).astype(np.float32)
        img += weight * cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    for _ in range(max(h * w // 100, 8)):
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        x, y = int(rng.randint(0, w)), int(rng.randint(0, h))
        r = int(rng.randint(1, max(2, min(h, w) // 48)))
        if rng.rand() < 0.5:
            cv2.circle(img, (x, y), r, color, -1, cv2.LINE_AA)
        else:
            cv2.rectangle(img, (x - r, y - r), (x + r, int(y + r * rng.uniform(0.5, 2))), color, -1,
                          cv2.LINE_AA)
    return img


def write_megadepth_fixture(root, n_scenes=2, n_images=4, height=96, width=128, seed=0,
                            max_rot_deg=8.0, max_shift=1.0):
    """Write the fixture under ``root``; returns ``root``."""
    import cv2

    rng = np.random.RandomState(seed)
    f = 0.8 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]])
    # the texture: a virtual camera at the origin with the same focal
    # length and twice the frame, so that every view falls inside it at
    # about one texture pixel per image pixel
    th, tw = 2 * height, 2 * width
    K0 = np.array([[f, 0, tw / 2.0], [0, f, th / 2.0], [0, 0, 1]])
    n = np.array([0.0, 0.0, 1.0])
    for si in range(n_scenes):
        folder = os.path.join(root, f"scene{si}", "dense0", "aligned")
        os.makedirs(os.path.join(folder, "images"), exist_ok=True)
        tex = _texture(rng, th, tw)
        lines, names = [], []
        for ii in range(n_images):
            R = _rotation(rng, max_rot_deg)
            c = np.array([rng.uniform(-max_shift, max_shift), rng.uniform(-max_shift, max_shift), 0.0])
            t = -R @ c
            Hm = K @ (R + np.outer(t, n) / DEPTH) @ np.linalg.inv(K0)
            im = cv2.warpPerspective(tex, Hm, (width, height), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_REFLECT)
            name = f"{ii}.png"
            cv2.imwrite(os.path.join(folder, "images", name), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
            names.append(name)
            vals = [width, height, K[0, 0], K[1, 1], K[0, 2], K[1, 2], *R.ravel(), *t]
            lines.append(name + " " + " ".join(repr(float(v)) if isinstance(v, float) else str(v)
                                               for v in vals))
        with open(os.path.join(folder, "img_cam.txt"), "w") as fh:
            fh.write("# name w h fx fy cx cy R t\n" + "\n".join(lines) + "\n")
        with open(os.path.join(folder, "pairs.txt"), "w") as fh:
            for a in range(n_images):
                for b in range(a + 1, n_images):
                    fh.write(f"{names[a]} {names[b]}\n")
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root")
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--images", type=int, default=4)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    write_megadepth_fixture(a.root, a.scenes, a.images, a.height, a.width, a.seed)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
