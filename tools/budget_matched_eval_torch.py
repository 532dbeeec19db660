"""Budget-matched learned-vs-SIFT detector comparison on extracted npz
slates, with posfeat_tpu_torch's HPatches harness (a port of
tools/budget_matched_eval.py).

The learned arm's slates are score-descending (the extractor's top-k
contract, reference putils:249-261), so keeping a slate's first n rows
keeps its n best keypoints. The tool compares:

  1. the SIFT arm (an Extractor run with ``use_sift: True``), MMA at
     1, 2, 3 and 5 px;
  2. the learned arm truncated, image by image, to the SIFT arm's own
     keypoint count for that image: the like-for-like detector comparison;
  3. the learned arm truncated to each fixed budget of ``--ladder``.

Usage (matching on the card unless ``--device cpu``):

    python tools/budget_matched_eval_torch.py --learned <desc-dir> \\
        --sift <desc-dir> --data <hpatches-root> [--postfix c] \\
        [--ladder 64,96,128] [--device cpu]

Prints one JSON line per evaluation.
"""
import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def truncate_dir(src, dst, postfix, n_for):
    """Copy the npz slates of src into dst, each truncated to its first
    n_for(relative path) rows."""
    for f in sorted(glob.glob(os.path.join(src, "*", f"*.{postfix}"))):
        rel = os.path.relpath(f, src)
        z = np.load(f)
        n = min(n_for(rel), z["keypoints"].shape[0])
        out = os.path.join(dst, rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "wb") as fo:
            np.savez(fo, keypoints=z["keypoints"][:n], scores=z["scores"][:n], descriptors=z["descriptors"][:n])


def mma_bands(desc_dir, postfix, data_root, thrs=(1, 2, 3, 5), device=None):
    """MMA at several pixel thresholds: a gap at the tight ones is
    sub-pixel localization, a gap that survives the loose ones is match
    coverage or ranking."""
    from posfeat_tpu_torch.evals import hpatches as hp

    seqs = sorted(os.listdir(data_root))
    n_i = sum(s.startswith("i_") for s in seqs)
    n_v = sum(s.startswith("v_") for s in seqs)
    errors = hp.benchmark_features(hp.generate_read_function(desc_dir, postfix), data_root, device=device)
    return {f"mma{t}": round(float(hp.mma_at(errors, t, n_i=n_i, n_v=n_v)[0]), 4) for t in thrs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--learned", required=True, help="learned-detector desc dir")
    ap.add_argument("--sift", required=True, help="SIFT-arm desc dir")
    ap.add_argument("--data", required=True, help="HPatches-layout root")
    ap.add_argument("--postfix", default="c")
    ap.add_argument("--ladder", default="64,96,128")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    sift_counts = {}
    for f in sorted(glob.glob(os.path.join(args.sift, "*", f"*.{args.postfix}"))):
        sift_counts[os.path.relpath(f, args.sift)] = int(np.load(f)["keypoints"].shape[0])
    mean_n = float(np.mean(list(sift_counts.values())))
    bands = lambda d: mma_bands(d, args.postfix, args.data, device=args.device)
    print(json.dumps({"eval": "sift_arm", "mean_kpts": round(mean_n, 1), **bands(args.sift)}), flush=True)

    work = tempfile.mkdtemp(prefix="bmatch_")
    try:
        d = os.path.join(work, "matched")
        truncate_dir(args.learned, d, args.postfix, lambda rel: sift_counts[rel])
        print(json.dumps({"eval": "learned_matched_budget", "mean_kpts": round(mean_n, 1), **bands(d)}),
              flush=True)
        for n in (int(x) for x in args.ladder.split(",") if x):
            d = os.path.join(work, f"n{n}")
            truncate_dir(args.learned, d, args.postfix, lambda rel: n)
            mma3 = mma_bands(d, args.postfix, args.data, thrs=(3,), device=args.device)["mma3"]
            print(json.dumps({"eval": f"learned_n{n}", "mma3": mma3}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
