"""ETH SfM local-feature benchmark pipeline (posfeat_tpu/evals/eth.py;
reference evaluations/ETH_local_feature/reconstruction_pipeline.py).

Imports npz features into the scene's COLMAP database, all-pairs matches
with the configured matcher (on the device: ``--device``, default the
card), runs `colmap matches_importer` + `mapper`, picks the largest
model, and reports model_analyzer statistics. Reads the same
extract_ETH.yaml used for extraction.

    python -m posfeat_tpu_torch.evals.eth --config configs/extract_ETH.yaml [--ckpt_root ./ckpts] [--device cpu]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import sqlite3
import subprocess
import types

import numpy as np

from ..core.config import load_config
from ..ops.matchers import MATCHERS
from . import colmap_db as cdb


def import_features_and_match(configs, paths, device=None):
    """Reference :55-166 — clear tables, insert keypoints, all-pairs match
    (the similarity on ``device``, None: the card), geometric verification,
    inlier stats."""
    conn = sqlite3.connect(paths.database_path)
    cur = conn.cursor()
    cur.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name='inlier_matches';"
    )
    try:
        has_inlier_table = bool(next(cur)[0])
    except StopIteration:
        has_inlier_table = False
    cur.execute("DELETE FROM keypoints;")
    cur.execute("DELETE FROM descriptors;")
    cur.execute("DELETE FROM matches;")
    cur.execute(
        "DELETE FROM inlier_matches;" if has_inlier_table
        else "DELETE FROM two_view_geometries;"
    )
    conn.commit()

    images = {}
    cur.execute("SELECT name, image_id FROM images;")
    for name, image_id in cur:
        images[name] = image_id

    def feat_path(name):
        return os.path.join(
            paths.features_path, f"{name}.{configs['method_postfix']}"
        )

    cur.close()
    conn.close()
    # raw 2-col layout, reference reconstruction_pipeline.py:82-96
    cdb.import_keypoints(
        paths.database_path, images, feat_path, with_scale_ori=False
    )
    conn = sqlite3.connect(paths.database_path)
    cur = conn.cursor()

    matcher = MATCHERS[configs["matcher"]]
    mcfg = configs.get("matcher_config") or {}
    names = list(images.keys())
    image_pairs = []
    seen = set()
    for i, name1 in enumerate(names[:-1]):
        desc1 = np.load(feat_path(name1))["descriptors"].astype(np.float32)
        for name2 in names[i + 1 :]:
            image_pairs.append((name1, name2))
            id1, id2 = images[name1], images[name2]
            pair_id = cdb.image_ids_to_pair_id(id1, id2)
            if pair_id in seen:
                continue
            seen.add(pair_id)
            desc2 = np.load(feat_path(name2))["descriptors"].astype(np.float32)
            matches = matcher(desc1, desc2, device=device, **mcfg)
            cdb.insert_matches(cur, id1, id2, matches)
        conn.commit()
        print(f"matched image {i + 1}/{len(names)}", end="\r")
    print()
    with open(paths.match_list_path, "w") as fid:
        for n1, n2 in image_pairs:
            fid.write(f"{n1} {n2}\n")
    cur.close()
    conn.close()

    cdb.run_colmap(
        paths.colmap_path, "matches_importer",
        "--database_path", paths.database_path,
        "--match_list_path", paths.match_list_path,
        "--match_type", "pairs",
    )
    return cdb.matching_stats(paths.database_path)


def reconstruct(configs, paths):
    """Reference :169-281 — mapper, largest-model pick, analyzer stats."""
    sparse_path = os.path.join(
        os.path.dirname(paths.features_path), f"{configs['subfolder']}_sparse"
    )
    os.makedirs(sparse_path, exist_ok=True)

    cdb.run_colmap(
        paths.colmap_path, "mapper",
        "--database_path", paths.database_path,
        "--image_path", paths.image_path,
        "--output_path", sparse_path,
        "--Mapper.num_threads", str(min(multiprocessing.cpu_count(), 16)),
    )

    models = [
        os.path.join(sparse_path, d)
        for d in sorted(os.listdir(sparse_path))
        if os.path.isdir(os.path.join(sparse_path, d))
    ]
    if not models:
        print("Warning: Could not reconstruct any model")
        return None

    largest_model, largest_n = None, 0
    for model in models:
        cdb.run_colmap(
            paths.colmap_path, "model_converter",
            "--input_path", model,
            "--output_path", model,
            "--output_type", "TXT",
        )
        with open(os.path.join(model, "cameras.txt")) as fid:
            for line in fid:
                if line.startswith("# Number of cameras"):
                    n = int(line.split()[-1])
                    if n > largest_n:
                        largest_model, largest_n = model, n
                    break
    assert largest_n > 0

    stats_raw = subprocess.check_output(
        [paths.colmap_path, "model_analyzer", "--path", largest_model]
    ).decode().split("\n")
    stats = {}
    for line in stats_raw:
        if line.startswith("Registered images"):
            stats["num_reg_images"] = int(line.split()[-1])
        elif line.startswith("Points"):
            stats["num_sparse_points"] = int(line.split()[-1])
        elif line.startswith("Observations"):
            stats["num_observations"] = int(line.split()[-1])
        elif line.startswith("Mean track length"):
            stats["mean_track_length"] = float(line.split()[-1])
        elif line.startswith("Mean observations per image"):
            stats["num_observations_per_image"] = float(line.split()[-1])
        elif line.startswith("Mean reprojection error"):
            stats["mean_reproj_error"] = float(line.split()[-1][:-2])
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="ETH local-feature benchmark")
    parser.add_argument("--config", required=True, help="the extract_ETH.yaml")
    parser.add_argument("--ckpt_root", default="./ckpts")
    parser.add_argument("--device", default=None, help="matching device (default: the card)")
    args = parser.parse_args(argv)

    configs = load_config(args.config)
    configs["method_postfix"] = configs["postfix"]
    configs["subfolder"] = configs["data_config_extract"]["subfolder"]
    features_root = os.path.join(args.ckpt_root, configs["output_root"], "desc")

    paths = types.SimpleNamespace()
    colmap = configs["colmap_path"]
    paths.colmap_path = (
        colmap if os.path.isfile(colmap) or os.sep not in colmap
        else os.path.join(colmap, "colmap")
    )
    paths.dataset_path = os.path.join(
        configs["data_config_extract"]["data_path"], configs["subfolder"]
    )
    paths.image_path = os.path.join(paths.dataset_path, "images")
    paths.features_path = os.path.join(features_root, configs["subfolder"])
    paths.database_path = os.path.join(
        features_root, f"{configs['subfolder']}_{configs['method_postfix']}.db"
    )
    paths.match_list_path = os.path.join(
        paths.features_path, f"image_pairs_{configs['method_postfix']}.txt"
    )
    paths.result_path = os.path.join(
        features_root, f"res_{configs['subfolder']}_{configs['method_postfix']}.txt"
    )

    if os.path.exists(paths.database_path):
        raise FileExistsError(
            f"The {configs['subfolder']} database already exists for method "
            f"{configs['method_postfix']}."
        )
    shutil.copyfile(
        os.path.join(paths.dataset_path, "database.db"), paths.database_path
    )

    matching_stats = import_features_and_match(configs, paths, device=args.device)
    reconstruction_stats = reconstruct(configs, paths)

    print("=" * 78)
    print("Raw statistics")
    print(matching_stats)
    print(reconstruction_stats)

    if reconstruction_stats:
        scene = os.path.basename(paths.dataset_path)
        keys = "|".join([scene] + list(reconstruction_stats.keys())) + "|\n"
        vals = "|".join(
            [scene]
            + [
                str(v).rjust(len(k))
                for k, v in reconstruction_stats.items()
            ]
        ) + "|\n"
        print(keys + vals)
        with open(paths.result_path, "w") as fid:
            fid.write(keys + vals)


if __name__ == "__main__":
    main()
