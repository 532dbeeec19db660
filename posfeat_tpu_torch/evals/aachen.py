"""Aachen Day-Night visual-localization pipeline (posfeat_tpu/evals/aachen.py;
reference evaluations/aachen/reconstruct_pipeline.py +
reconstruct_pipeline_v1_1.py, unified behind --version).

Host-side orchestration around the COLMAP binary: import npz features into
the dummy database, mutual-NN match the listed pairs (the similarity on
the device through ops.matchers; ``--device``, default the card),
geometric verification (`colmap matches_importer`), triangulation, query
registration, and benchmark-submission pose export.

    python -m posfeat_tpu_torch.evals.aachen --dataset_path <aachen> --feature_path <desc dir> \
        --colmap_path <colmap> --method_name <postfix> [--version v1_1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sqlite3
import types

import numpy as np

from ..ops.matchers import MATCHERS
from . import colmap_db as cdb


def preprocess_reference_model(paths, version: str):
    """Intrinsics txt + NVM poses -> Camera dict (reference :56-103)."""
    intr_file = (
        "database_intrinsics.txt" if version == "v1" else "database_intrinsics_v1_1.txt"
    )
    nvm_file = "aachen_cvpr2018_db.nvm" if version == "v1" else "aachen_v_1_1.nvm"

    cameras = {}
    with open(os.path.join(paths.reference_model_path, intr_file)) as f:
        for line in f:
            parts = line.strip("\n").split(" ")
            cam = cdb.Camera(
                camera_model=parts[1],
                intrinsics=[float(p) for p in parts[2:]],
            )
            cameras[parts[0]] = cam

    with open(os.path.join(paths.reference_model_path, nvm_file)) as f:
        raw = f.readlines()
    n_cameras = int(raw[2])
    for line in raw[3 : 3 + n_cameras]:
        parts = line.strip("\n").split(" ")
        name = parts[0]
        qw, qx, qy, qz, cx, cy, cz = [float(p) for p in parts[2:-2]]
        qvec = np.array([qw, qx, qy, qz])
        c = np.array([cx, cy, cz])
        cameras[name].qvec = qvec
        cameras[name].t = cdb.camera_center_to_translation(c, qvec)
    return cameras


def generate_empty_reconstruction(images, camera_ids, camera_parameters, paths):
    """cameras.txt / images.txt / points3D.txt (reference :106-143)."""
    os.makedirs(paths.empty_model_path, exist_ok=True)
    with open(os.path.join(paths.empty_model_path, "cameras.txt"), "w") as f:
        for name, image_id in images.items():
            cam = camera_parameters.get(name)
            if cam is None:
                continue
            f.write(
                "%d %s %s\n"
                % (camera_ids[name], cam.camera_model, " ".join(map(str, cam.intrinsics)))
            )
    with open(os.path.join(paths.empty_model_path, "images.txt"), "w") as f:
        for name, image_id in images.items():
            cam = camera_parameters.get(name)
            if cam is None:
                continue
            f.write(
                "%d %s %s %d %s\n\n"
                % (
                    image_id,
                    " ".join(map(str, cam.qvec)),
                    " ".join(map(str, cam.t)),
                    camera_ids[name],
                    name,
                )
            )
    open(os.path.join(paths.empty_model_path, "points3D.txt"), "w").close()


def match_features(images, paths, method_name: str, matcher_name: str = "mutual_nn_matcher",
                   device=None):
    """Pairwise matching over the match list -> sqlite (reference :182-221);
    the similarity on ``device`` (None: the card)."""
    matcher = MATCHERS[matcher_name]
    conn = sqlite3.connect(paths.database_path)
    cur = conn.cursor()
    with open(paths.match_list_path) as f:
        raw_pairs = f.readlines()

    seen = set()
    desc_cache = {}

    def load_desc(name):
        if name not in desc_cache:
            desc_cache[name] = np.load(
                os.path.join(paths.features_path, f"{name}.{method_name}")
            )["descriptors"].astype(np.float32)
            if len(desc_cache) > 64:
                desc_cache.pop(next(iter(desc_cache)))
        return desc_cache[name]

    for i, raw_pair in enumerate(raw_pairs):
        name1, name2 = raw_pair.strip("\n").split(" ")
        id1, id2 = images[name1], images[name2]
        pair_id = cdb.image_ids_to_pair_id(id1, id2)
        if pair_id in seen:
            continue
        seen.add(pair_id)
        matches = matcher(load_desc(name1), load_desc(name2), device=device).astype(np.uint32)
        cdb.insert_matches(cur, id1, id2, matches)
        if i % 200 == 0:
            conn.commit()
            print(f"matched {i}/{len(raw_pairs)} pairs", end="\r")
    conn.commit()
    cur.close()
    conn.close()
    print()


def recover_query_poses(paths, args, version: str):
    """TXT model -> benchmark-submission txt (reference :262-311)."""
    os.makedirs(paths.final_txt_model_path, exist_ok=True)
    cdb.run_colmap(
        args.colmap, "model_converter",
        "--input_path", paths.final_model_path,
        "--output_path", paths.final_txt_model_path,
        "--output_type", "TXT",
    )

    query_lists = []
    if version == "v1":
        query_lists.append("queries/night_time_queries_with_intrinsics.txt")
        if os.path.basename(args.match_list_path) != "image_pairs_to_match.txt":
            query_lists.append("queries/day_time_queries_with_intrinsics.txt")
    else:
        query_lists.append("queries/night_time_queries_with_intrinsics_v1_1.txt")

    query_names = set()
    for ql in query_lists:
        with open(os.path.join(args.dataset_path, ql)) as f:
            for line in f:
                query_names.add(line.strip("\n").split(" ")[0])

    with open(os.path.join(paths.final_txt_model_path, "images.txt")) as f:
        raw_extrinsics = f.readlines()

    os.makedirs(os.path.dirname(paths.prediction_path), exist_ok=True)
    with open(paths.prediction_path, "w") as f:
        for line in raw_extrinsics[4::2]:
            parts = line.strip("\n").split(" ")
            name = parts[-1]
            if name in query_names:
                f.write("%s %s\n" % (name.split("/")[-1], " ".join(parts[1:-2])))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Aachen Day-Night localization")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--feature_path", required=True)
    parser.add_argument("--colmap_path", required=True,
                        help="folder containing the colmap binary, or the binary")
    parser.add_argument("--method_name", required=True)
    parser.add_argument("--match_list_path", default="image_pairs_to_match.txt")
    parser.add_argument("--version", choices=["v1", "v1_1"], default="v1")
    parser.add_argument("--matcher", default="mutual_nn_matcher")
    parser.add_argument("--device", default=None, help="matching device (default: the card)")
    args = parser.parse_args(argv)

    args.colmap = (
        args.colmap_path
        if os.path.isfile(args.colmap_path)
        else os.path.join(args.colmap_path, "colmap")
    )

    ds = args.dataset_path
    m = args.method_name
    ref_model = "aachen_v_1" if args.version == "v1" else "aachen_v_1_1"
    dummy = "database.db" if args.version == "v1" else "database_v1_1.db"

    paths = types.SimpleNamespace()
    paths.dummy_database_path = os.path.join(ds, "others", dummy)
    paths.database_path = os.path.join(ds, "intermedia", m, f"{m}.db")
    paths.image_path = os.path.join(ds, "images/images_upright")
    paths.features_path = args.feature_path
    paths.reference_model_path = os.path.join(ds, "3D-models", ref_model)
    paths.match_list_path = os.path.join(ds, "others", args.match_list_path)
    paths.empty_model_path = os.path.join(ds, "intermedia", m, f"sparse-{m}-empty")
    paths.database_model_path = os.path.join(ds, "intermedia", m, f"sparse-{m}-database")
    paths.final_model_path = os.path.join(ds, "intermedia", m, f"sparse-{m}-final")
    paths.final_txt_model_path = os.path.join(ds, "intermedia", m, f"sparse-{m}-final-txt")
    paths.prediction_path = os.path.join(ds, "results", f"Aachen_eval_[{m}].txt")
    args.match_list_path_base = args.match_list_path

    if os.path.exists(paths.database_path):
        raise FileExistsError(
            f"The database file already exists for method {m}."
        )
    os.makedirs(os.path.dirname(paths.database_path), exist_ok=True)
    shutil.copyfile(paths.dummy_database_path, paths.database_path)

    camera_parameters = preprocess_reference_model(paths, args.version)
    images, camera_ids = cdb.recover_database_images_and_ids(paths.database_path)
    generate_empty_reconstruction(images, camera_ids, camera_parameters, paths)
    cdb.import_keypoints(
        paths.database_path,
        images,
        lambda name: os.path.join(paths.features_path, f"{name}.{m}"),
        with_scale_ori=True,
    )
    match_features(images, paths, m, args.matcher, device=args.device)
    print("Running geometric verification...")
    cdb.run_colmap(
        args.colmap, "matches_importer",
        "--database_path", paths.database_path,
        "--match_list_path", paths.match_list_path,
        "--match_type", "pairs",
    )
    os.makedirs(paths.database_model_path, exist_ok=True)
    cdb.run_colmap(
        args.colmap, "point_triangulator",
        "--database_path", paths.database_path,
        "--image_path", paths.image_path,
        "--input_path", paths.empty_model_path,
        "--output_path", paths.database_model_path,
        "--Mapper.ba_refine_focal_length", "0",
        "--Mapper.ba_refine_principal_point", "0",
        "--Mapper.ba_refine_extra_params", "0",
    )
    os.makedirs(paths.final_model_path, exist_ok=True)
    cdb.run_colmap(
        args.colmap, "image_registrator",
        "--database_path", paths.database_path,
        "--input_path", paths.database_model_path,
        "--output_path", paths.final_model_path,
        "--Mapper.ba_refine_focal_length", "0",
        "--Mapper.ba_refine_principal_point", "0",
        "--Mapper.ba_refine_extra_params", "0",
    )
    recover_query_poses(paths, args, args.version)
    print(f"submission file: {paths.prediction_path}")


if __name__ == "__main__":
    main()
