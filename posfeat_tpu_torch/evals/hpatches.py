"""HPatches MMA evaluation (posfeat_tpu/evals/hpatches.py; reference
evaluations/hpatches/evaluation.py).

Cache-compatible with the reference and the JAX package: errors are
stored and loaded as np.save([i_err, v_err, [seq_type, n_feats,
n_matches]]) object arrays, so precomputed caches of the 12 published
methods (PoSFeat_CVPR among them) compare with the port's runs directly.
Mutual-NN matching runs on ``device`` (None: the card); the homography
errors are host numpy.

    python -m posfeat_tpu_torch.evals.hpatches --dataset_path <hpatches-sequences-release> \\
        --features_path <ckpts/<output_root>/desc> --method <postfix> [--device cpu]
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np

from ..ops.matchers import mnn_matcher

N_I = 52
N_V = 56
THRESHOLDS = np.arange(1, 16)


def generate_read_function(
    features_path: str, method: str, extension: str = "ppm"
) -> Callable:
    def read_function(seq_name, im_idx):
        aux = np.load(
            os.path.join(features_path, seq_name, f"{im_idx}.{extension}.{method}")
        )
        return aux["keypoints"], aux["descriptors"]

    return read_function


def benchmark_features(read_feats: Callable, dataset_path: str, device=None):
    """Per-sequence 1↔{2..6} matching with homography-projected pixel error
    (reference evaluation.py:40-96)."""
    seq_names = sorted(
        d for d in os.listdir(dataset_path)
        if os.path.isdir(os.path.join(dataset_path, d))
    )

    n_feats, n_matches, seq_type = [], [], []
    i_err = {int(t): 0 for t in THRESHOLDS}
    v_err = {int(t): 0 for t in THRESHOLDS}

    for seq_name in seq_names:
        kp_a, desc_a = read_feats(seq_name, 1)
        if kp_a.shape[0] > 60000:
            kp_a, desc_a = kp_a[:60000], desc_a[:60000]
        n_feats.append(kp_a.shape[0])

        for im_idx in range(2, 7):
            kp_b, desc_b = read_feats(seq_name, im_idx)
            if kp_b.shape[0] > 60000:
                kp_b, desc_b = kp_b[:60000], desc_b[:60000]
            n_feats.append(kp_b.shape[0])

            matches = mnn_matcher(
                desc_a.astype(np.float32), desc_b.astype(np.float32), device=device
            )

            homography = np.loadtxt(
                os.path.join(dataset_path, seq_name, f"H_1_{im_idx}")
            )
            pos_a = kp_a[matches[:, 0], :2]
            pos_a_h = np.concatenate([pos_a, np.ones([matches.shape[0], 1])], axis=1)
            pos_b_proj_h = (homography @ pos_a_h.T).T
            pos_b_proj = pos_b_proj_h[:, :2] / pos_b_proj_h[:, 2:]
            pos_b = kp_b[matches[:, 1], :2]
            dist = np.sqrt(np.sum((pos_b - pos_b_proj) ** 2, axis=1))

            n_matches.append(matches.shape[0])
            seq_type.append(seq_name[0])
            if dist.shape[0] == 0:
                dist = np.array([float("inf")])
            for thr in THRESHOLDS:
                t = int(thr)
                if seq_name[0] == "i":
                    i_err[t] += np.mean(dist <= thr)
                else:
                    v_err[t] += np.mean(dist <= thr)

    return i_err, v_err, [np.array(seq_type), np.array(n_feats), np.array(n_matches)]


def mma_at(errors, thr: int, n_i: int = N_I, n_v: int = N_V) -> Tuple[float, float, float]:
    """(overall, illumination, viewpoint) MMA at a pixel threshold."""
    i_err, v_err, _ = errors
    return (
        (i_err[thr] + v_err[thr]) / ((n_i + n_v) * 5),
        i_err[thr] / (n_i * 5),
        v_err[thr] / (n_v * 5),
    )


def mma_score(errors, n_i: int = N_I, n_v: int = N_V) -> Tuple[float, float, float]:
    """Weighted 1-10px MMAscore (reference evaluation.py:160-179)."""
    cur = np.zeros(3)
    upper = 0.0
    for thr in range(1, 11):
        w = 2 - thr / 10.0
        cur += w * np.array(mma_at(errors, thr, n_i, n_v))
        upper += w
    return tuple(cur / upper)


def evaluate_method(
    dataset_path: str,
    features_path: str,
    method: str,
    cache_dir: str = None,
    extension: str = "ppm",
    device=None,
):
    """Run (or load cached) benchmark for one method; returns errors tuple."""
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache_file = os.path.join(cache_dir, method + ".npy")
        if os.path.exists(cache_file):
            return tuple(np.load(cache_file, allow_pickle=True))
    errors = benchmark_features(
        generate_read_function(features_path, method, extension), dataset_path, device=device
    )
    if cache_dir:
        np.save(cache_file, np.array(errors, dtype=object))
    return errors


def load_reference_cache(cache_file: str):
    """Load a reference-format cache npy (e.g. PoSFeat_CVPR.npy)."""
    return tuple(np.load(cache_file, allow_pickle=True))


def summary_line(name: str, errors) -> str:
    seq_type, n_feats, n_matches = errors[2]
    num_feat = float(np.mean(n_feats))
    num_match = float(np.sum(n_matches) / ((N_I + N_V) * 5))
    s = mma_score(errors)
    return "{} & {:.1f} & {:.1f} & {:.3f} & {:.3f} & {:.3f}".format(
        name.ljust(25), num_feat, num_match, s[0], s[1], s[2]
    )


def plot_mma_curves(method_errors: Dict[str, tuple], out_path: str, plt_lim=(1, 10)):
    """Three-panel MMA-vs-threshold curves (overall / illumination /
    viewpoint), the reference's results figure (evaluation.py:181-243).

    method_errors: {display_name: errors tuple}; writes pdf/png per the
    out_path extension (plus a sibling .png when out_path is a .pdf).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt_rng = np.arange(plt_lim[0], plt_lim[1] + 1)
    panels = [
        ("Overall", lambda e, t: mma_at(e, t)[0]),
        ("Illumination", lambda e, t: mma_at(e, t)[1]),
        ("Viewpoint", lambda e, t: mma_at(e, t)[2]),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2), sharey=True)
    for ax, (title, f) in zip(axes, panels):
        for name, errors in method_errors.items():
            ys = [f(errors, int(t)) for t in plt_rng]
            ax.plot(plt_rng, ys, linewidth=2, marker="o", markersize=3, label=name)
        ax.set_title(title)
        ax.set_xlabel("threshold [px]")
        ax.set_xlim(plt_lim)
        ax.set_ylim(0, 1)
        ax.grid(alpha=0.3)
    axes[0].set_ylabel("MMA")
    axes[-1].legend(fontsize=8, loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    if out_path.endswith(".pdf"):
        fig.savefig(out_path[:-4] + ".png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def results_table(method_errors: Dict[str, tuple]) -> str:
    """The reference's txt results table (evaluation.py:245-256):
    one `summary_line` row per method + header."""
    header = "{} & #Features & #Matches & MMAscore & MMAsc.illum & MMAsc.view".format(
        "Method".ljust(25)
    )
    rows = [header] + [summary_line(name, errors) for name, errors in method_errors.items()]
    return "\n".join(rows)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="HPatches MMA evaluation")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--features_path", required=True)
    p.add_argument("--method", required=True, help="feature-file postfix")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--ref_cache", default=None, help="reference .npy to compare")
    p.add_argument(
        "--compare_cache_dir", default=None,
        help="directory of reference-format .npy caches to overlay (all files)",
    )
    p.add_argument("--plot", default=None, help="write MMA curve figure here")
    p.add_argument("--table", default=None, help="write results txt table here")
    p.add_argument("--device", default=None, help="matching device (default: the card)")
    args = p.parse_args(argv)

    errors = evaluate_method(
        args.dataset_path, args.features_path, args.method, args.cache_dir, device=args.device
    )
    method_errors = {args.method: errors}
    if args.ref_cache:
        ref = load_reference_cache(args.ref_cache)
        method_errors[os.path.splitext(os.path.basename(args.ref_cache))[0]] = ref
        print("reference MMA@3px: {:.4f} / {:.4f} / {:.4f}".format(*mma_at(ref, 3)))
    if args.compare_cache_dir:
        for f in sorted(os.listdir(args.compare_cache_dir)):
            if f.endswith(".npy") and os.path.splitext(f)[0] not in method_errors:
                method_errors[os.path.splitext(f)[0]] = load_reference_cache(
                    os.path.join(args.compare_cache_dir, f)
                )

    print(results_table(method_errors))
    print("MMA@3px (overall/illum/view): {:.4f} / {:.4f} / {:.4f}".format(*mma_at(errors, 3)))
    if args.plot:
        plot_mma_curves(method_errors, args.plot)
        print(f"curves -> {args.plot}")
    if args.table:
        with open(args.table, "w") as fh:
            fh.write(results_table(method_errors) + "\n")
        print(f"table -> {args.table}")


if __name__ == "__main__":
    main()
