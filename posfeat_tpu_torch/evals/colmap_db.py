"""COLMAP sqlite database helpers shared by the Aachen and ETH pipelines
(a copy of posfeat_tpu/evals/colmap_db.py, which is numpy and sqlite only;
reference evaluations/aachen/reconstruct_pipeline.py:30-53,146-221,
utils.py, camera.py)."""

from __future__ import annotations

import sqlite3
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

MAX_IMAGE_ID = 2147483647


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        return MAX_IMAGE_ID * image_id2 + image_id1
    return MAX_IMAGE_ID * image_id1 + image_id2


def quaternion_to_rotation_matrix(qvec: np.ndarray) -> np.ndarray:
    q = qvec / np.linalg.norm(qvec)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def camera_center_to_translation(c: np.ndarray, qvec: np.ndarray) -> np.ndarray:
    """NVM camera center -> COLMAP translation t = -R c."""
    return -quaternion_to_rotation_matrix(qvec) @ c


@dataclass
class Camera:
    camera_model: Optional[str] = None
    intrinsics: Optional[List[float]] = None
    qvec: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None


def recover_database_images_and_ids(database_path: str):
    """-> (name -> image_id, name -> camera_id)."""
    conn = sqlite3.connect(database_path)
    cur = conn.cursor()
    images, cameras = {}, {}
    cur.execute("SELECT name, image_id, camera_id FROM images;")
    for name, image_id, camera_id in cur:
        images[name] = image_id
        cameras[name] = camera_id
    cur.close()
    conn.close()
    return images, cameras


def import_keypoints(
    database_path: str,
    images: Dict[str, int],
    feature_file_fn,
    with_scale_ori: bool = True,
):
    """Insert npz keypoints into the database.

    feature_file_fn(name) -> path to the .npz. When with_scale_ori,
    placeholder scale=1 / orientation=0 columns are appended (Aachen
    pipeline, reconstruct_pipeline.py:160-163); otherwise the raw 2-col
    layout is kept (ETH pipeline, reconstruction_pipeline.py:82-96).
    """
    conn = sqlite3.connect(database_path)
    cur = conn.cursor()
    for name, image_id in images.items():
        kpts = np.load(feature_file_fn(name))["keypoints"][:, :2]
        n = kpts.shape[0]
        if with_scale_ori:
            kpts = np.concatenate(
                [kpts, np.ones((n, 1)), np.zeros((n, 1))], axis=1
            ).astype(np.float32)
        else:
            # COLMAP reads keypoint blobs as float32; extractor npz files
            # are f32 already but cast defensively for foreign features
            kpts = kpts.astype(np.float32)
        cur.execute(
            "INSERT INTO keypoints(image_id, rows, cols, data) VALUES(?, ?, ?, ?);",
            (image_id, kpts.shape[0], kpts.shape[1], kpts.tobytes()),
        )
    conn.commit()
    cur.close()
    conn.close()


def insert_matches(cursor, image_id1: int, image_id2: int, matches: np.ndarray):
    """Insert a match table row with COLMAP pair-id ordering."""
    pair_id = image_ids_to_pair_id(image_id1, image_id2)
    if image_id1 > image_id2:
        matches = matches[:, [1, 0]]
    m = np.int32(matches)
    cursor.execute(
        "INSERT INTO matches(pair_id, rows, cols, data) VALUES(?, ?, ?, ?);",
        (pair_id, m.shape[0], m.shape[1], m.tobytes()),
    )
    return pair_id


def run_colmap(colmap_binary: str, command: str, *args: str) -> None:
    subprocess.call([colmap_binary, command, *args])


def matching_stats(database_path: str) -> Dict[str, int]:
    """Inlier statistics after geometric verification
    (reconstruction_pipeline.py:148-166)."""
    conn = sqlite3.connect(database_path)
    cur = conn.cursor()
    cur.execute("SELECT count(*) FROM images;")
    num_images = next(cur)[0]
    cur.execute("SELECT count(*) FROM two_view_geometries WHERE rows > 0;")
    num_inlier_pairs = next(cur)[0]
    cur.execute("SELECT sum(rows) FROM two_view_geometries WHERE rows > 0;")
    num_inlier_matches = next(cur)[0]
    cur.close()
    conn.close()
    return dict(
        num_images=num_images,
        num_inlier_pairs=num_inlier_pairs,
        num_inlier_matches=num_inlier_matches,
    )
