"""Host-side image and geometry helpers (posfeat_tpu/data/utils.py; reference
datasets/data_utils.py).

Every function that draws takes an explicit ``np.random.RandomState``,
except ``random_choice``, which keeps the reference's fixed
``RandomState(1234)``. OpenCV is imported where an image is warped,
converted or searched for SIFT keypoints. ``tensor2array`` colours a
2-D array with lookup tables of its own (``COLORMAPS``) in place of
matplotlib's.
"""

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


def relative_pose_to_fundamental(K1, K2, extrinsic1, extrinsic2):
    """Camera intrinsics + world-to-cam extrinsics -> (F 1→2, relative pose):
    relative = E2 @ inv(E1), E = [t]x R, F = inv(K2)^T E inv(K1)
    (reference megadepth.py:426-448)."""
    relative = extrinsic2 @ np.linalg.inv(extrinsic1)
    R = relative[:3, :3]
    T = relative[:3, 3]
    E = skew(T) @ R
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    return F, relative


def rotation_angle_deg(R: np.ndarray) -> float:
    """The angle of a rotation matrix, in degrees."""
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) * 180 / np.pi)


def prune_kpts(coord1, F_gt, im2_size, intrinsic1, intrinsic2, pose, d_min, d_max):
    """Epipolar + depth-range visibility pruning (data_utils.py:81-116):
    True where the query point's epipolar line meets image 2 and some
    depth in [d_min, d_max] projects into it."""
    coord1_h = np.concatenate([coord1, np.ones_like(coord1[:, [0]])], axis=1).T
    line = F_gt.dot(coord1_h)
    line = line / np.clip(np.linalg.norm(line[:2], axis=0), 1e-10, None)

    h2, w2 = im2_size
    corners = np.array([[0, 0, 1], [0, h2 - 1, 1], [w2 - 1, 0, 1], [w2 - 1, h2 - 1, 1]])
    dists = np.abs(corners.dot(line))
    non_intersect = (dists > np.sqrt(w2 ** 2 + h2 ** 2)).any(axis=0)

    K1_4 = np.eye(4)
    K1_4[:3, :3] = intrinsic1
    K2_4 = np.eye(4)
    K2_4[:3, :3] = intrinsic2
    pose4 = np.eye(4)
    pose4[:3, :] = pose[:3, :]

    def proj(depth):
        ones = np.ones_like(coord1[:, [0]])
        ch = np.concatenate([depth * coord1, depth * ones, ones], axis=1).T
        c2 = K2_4.dot(pose4).dot(np.linalg.inv(K1_4)).dot(ch)
        return c2[:2] / (ch[2] + 1e-10)

    c_min, c_max = proj(d_min), proj(d_max)
    out_range = (
        ((c_min[0] < 0) & (c_max[0] < 0))
        | ((c_min[1] < 0) & (c_max[1] < 0))
        | ((c_min[0] > w2 - 1) & (c_max[0] > w2 - 1))
        | ((c_min[1] > h2 - 1) & (c_max[1] > h2 - 1))
    )
    return ~(non_intersect | out_range)


def random_choice(array: np.ndarray, size: int, seed: int = 1234) -> np.ndarray:
    """Subsample with the reference's fixed seed (data_utils.py:118-125):
    every call with the same length draws the same indices."""
    rand = np.random.RandomState(seed)
    n = len(array)
    idx = rand.choice(n, size, replace=n <= size)
    return array[idx]


def sift_keypoints(im_rgb: np.ndarray, nfeatures: int = 0) -> np.ndarray:
    """OpenCV SIFT detector on an RGB uint8 image -> [N, 2] (x, y)."""
    import cv2

    gray = cv2.cvtColor(im_rgb, cv2.COLOR_RGB2GRAY)
    sift = cv2.SIFT_create(nfeatures=nfeatures) if nfeatures else cv2.SIFT_create()
    kpts = sift.detect(gray)
    if not kpts:
        return np.zeros((0, 2), np.float32)
    return np.array([[kp.pt[0], kp.pt[1]] for kp in kpts], np.float32)


def color_jitter(im: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """ColorJitter(brightness=1, contrast=1, saturation=1, hue=0.4) of the
    MegaDepth train transform (megadepth.py:259-265): the four in random
    order, factors ~ U[0, 2] and a hue shift ~ U[-0.4, 0.4] turns."""
    import cv2

    im = im.astype(np.float32) / 255.0
    for op in rng.permutation(4):
        if op == 0:  # brightness
            im = np.clip(im * rng.uniform(0, 2), 0, 1)
        elif op == 1:  # contrast
            mean = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY).mean()
            im = np.clip(mean + rng.uniform(0, 2) * (im - mean), 0, 1)
        elif op == 2:  # saturation
            gray = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)[..., None]
            im = np.clip(gray + rng.uniform(0, 2) * (im - gray), 0, 1)
        else:  # hue
            hsv = cv2.cvtColor(im, cv2.COLOR_RGB2HSV)
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-0.4, 0.4) * 360.0) % 360.0
            im = np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1)
    return (im * 255).astype(np.uint8)


def rotate_image(image: np.ndarray, angle: float):
    """Rotate and rescale so that the rotated content fills the frame
    (data_utils.py:14-29). Returns (rotated image, 4x4 matrix whose
    upper-left 2x2 is the applied affine rotation block). At 0° the
    reference formula divides by tan(0), and at 180° its scale
    degenerates: both take the exact rotation at scale 1."""
    import cv2

    center = tuple(np.array(image.shape[1::-1]) / 2.0)
    if abs(angle) % 360.0 < 1e-9:
        return image.copy(), np.eye(4)
    if abs(abs(angle) % 360.0 - 180.0) < 1e-9:
        angle, scale = 180.0, 1.0
    else:
        h, w = image.shape[:2]
        rad = np.abs(angle / 180.0 * np.pi)
        cos, sin, tan = np.cos(rad), np.sin(rad), np.tan(rad)
        scale = max((h / cos + (w - h * tan) * sin) / h, (h / sin + (w - h / tan) * cos) / w)
    rot_mat = cv2.getRotationMatrix2D(center, angle, scale)
    result = cv2.warpAffine(image, rot_mat, image.shape[1::-1], flags=cv2.INTER_LINEAR)
    rotation = np.eye(4)
    rotation[:2, :2] = rot_mat[:2, :2]
    return result, rotation


def perspective_transform(img: np.ndarray, param: float, rng: np.random.RandomState):
    """Random small perspective warp (data_utils.py:31-45): (warped, M)."""
    import cv2

    h, w = img.shape[:2]
    M = np.eye(3) + param * (2.0 * rng.rand(3, 3) - 1.0)
    return cv2.warpPerspective(img, M, (w, h)), M


def generate_query_kpts(img: np.ndarray, mode: str, num_pts: int, h: int, w: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Query-keypoint candidates: 'random' | 'sift' | 'mixed'
    (data_utils.py:48-78); 'mixed' is 10% uniform-random + 90% SIFT."""
    if mode == "random":
        return np.stack([rng.rand(num_pts) * (w - 1), rng.rand(num_pts) * (h - 1)]).T
    if mode == "sift":
        return sift_keypoints(img, nfeatures=num_pts)
    if mode == "mixed":
        n_rand = int(0.1 * num_pts)
        kp_rand = np.stack([rng.rand(n_rand) * (w - 1), rng.rand(n_rand) * (h - 1)]).T
        kp_sift = sift_keypoints(img, nfeatures=int(0.9 * num_pts))
        if len(kp_sift) == 0:
            return kp_rand
        return np.concatenate([kp_rand, kp_sift], 0)
    raise ValueError(f"unknown type of keypoints {mode!r}")


# ColorBrewer's 11-class RdYlGn, red to green, as 8-bit RGB
_RDYLGN = np.array([
    (165, 0, 38), (215, 48, 39), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (217, 239, 139), (166, 217, 106), (102, 189, 99), (26, 152, 80),
    (0, 104, 55),
], np.float64) / 255.0

# Moreland's diverging cool-warm map, 33 points at steps of 1/32 (his
# "Diverging Color Maps for Scientific Visualization", float table)
_COOLWARM = np.array([
    (0.2298057, 0.298717966, 0.753683153), (0.26623388, 0.353094838, 0.801466763),
    (0.30386891, 0.406535296, 0.84495867), (0.342804478, 0.458757618, 0.883725899),
    (0.38301334, 0.50941904, 0.917387822), (0.424369608, 0.558148092, 0.945619588),
    (0.46666708, 0.604562568, 0.968154911), (0.509635204, 0.648280772, 0.98478814),
    (0.552953156, 0.688929332, 0.995375608), (0.596262162, 0.726149107, 0.999836203),
    (0.639176211, 0.759599947, 0.998151185), (0.681291281, 0.788964712, 0.990363227),
    (0.722193294, 0.813952739, 0.976574709), (0.761464949, 0.834302879, 0.956945269),
    (0.798691636, 0.849786142, 0.931688648), (0.833466556, 0.860207984, 0.901068838),
    (0.865395197, 0.86541021, 0.865395561), (0.897787179, 0.848937047, 0.820880546),
    (0.924127593, 0.827384882, 0.774508472), (0.944468518, 0.800927443, 0.726736146),
    (0.958852946, 0.769767752, 0.678007945), (0.96732803, 0.734132809, 0.628751763),
    (0.969954137, 0.694266682, 0.579375448), (0.966811177, 0.650421156, 0.530263762),
    (0.958003065, 0.602842431, 0.481775914), (0.943660866, 0.551750968, 0.434243684),
    (0.923944917, 0.49730856, 0.387970225), (0.89904617, 0.439559467, 0.343229596),
    (0.869186849, 0.378313092, 0.300267182), (0.834620542, 0.312874446, 0.259301199),
    (0.795631745, 0.24128379, 0.220525627), (0.752534934, 0.157246067, 0.184115123),
    (0.705673158, 0.01555616, 0.150232812),
], np.float64)


def _lookup_table(points: np.ndarray, n: int = 256) -> np.ndarray:
    """[n, 4] RGBA table of equally spaced control points, linearly
    interpolated at n equally spaced positions, as matplotlib's
    ``LinearSegmentedColormap.from_list`` builds it."""
    x = np.linspace(0.0, 1.0, len(points))
    t = np.linspace(0.0, 1.0, n)
    rgb = np.stack([np.interp(t, x, points[:, c]) for c in range(3)], axis=1)
    return np.concatenate([rgb, np.ones((n, 1))], axis=1)


COLORMAPS = {"RdYlGn": _lookup_table(_RDYLGN), "coolwarm": _lookup_table(_COOLWARM)}


def apply_colormap(x: np.ndarray, name: str) -> np.ndarray:
    """RGBA [..., 4] float64 of ``x`` in [0, 1] through the named table:
    bin ``int(x * 256)``, with 1.0 in the last bin, as a matplotlib
    ``Colormap.__call__`` indexes its 256 entries."""
    lut = COLORMAPS[name]
    n = len(lut)
    idx = np.minimum((np.clip(x, 0.0, 1.0) * n).astype(np.int64), n - 1)
    return lut[idx]


def tensor2array(arr: np.ndarray, max_value=None, colormap: str = "coolwarm"):
    """Render a 2-D array (or a CHW/HWC image) to a float CHW RGB array
    (data_utils.py:127-148): a 2-D array divided by ``max_value`` (its
    maximum by default), clipped to [0, 1] and coloured by ``colormap``."""
    if max_value is None:
        max_value = float(arr.max()) if arr.size else 1.0
    if arr.ndim == 2:
        norm = np.clip(arr / max(max_value, 1e-12), 0, 1)
        return apply_colormap(norm, colormap).transpose(2, 0, 1)[:3].astype(np.float32)
    if arr.ndim == 3 and arr.shape[0] == 3:  # CHW image
        return ((arr + 1.0) / 2.0).astype(np.float32)
    if arr.ndim == 3 and arr.shape[2] == 3:  # HWC image
        return ((arr.transpose(2, 0, 1) + 1.0) / 2.0).astype(np.float32)
    raise ValueError(f"unsupported shape {arr.shape}")
