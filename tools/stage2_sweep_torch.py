#!/usr/bin/env python3
"""Stage-2 (detector, REINFORCE) recipe sweep of posfeat_tpu_torch on a
fixed stage-1 checkpoint: the port's counterpart of tools/stage2_sweep.py,
the sweep that chose configs/train_kp_best.yaml's levers.

Each variant trains the head (backbone frozen) from the same stage-1
checkpoint on SyntheticPairs at 96x128, seed by seed, then scores an
unseen synthetic-HPatches fixture (4 sequences x 6 images) with the
HPatches protocol: learned-detector MMA@3 at 128 and 256 points, with
the quad and quad5 refiners at 128, and the budget-matched bands of the
256-point slates, avg3 and quad5, against the shared SIFT arm (SIFT
keypoints with the stage-1 descriptors, tools/budget_matched_eval_torch.py).
One JSON line per result, with tools/stage2_sweep.py's keys; ``--seeds N``
adds each figure's mean and std over seeds 0..N-1.

    python3 tools/stage2_sweep_torch.py --ckpt1 <stage-1 epoch dir> [--work DIR]
        [--variants hot10x200,rt1,kp2] [--seeds N] [--device cpu]
        [--rot 30] [--scale 0.3] [--photo 1.3] [--lr1 1e-4] [--pairs 256] [--model default|head192]

The nuisance magnitudes, stage 1's learning rate, the number of distinct
pairs and the model (head192: fine_out_ch 128, so the head has the
flagship's 192 input channels) are the values the JAX tool reads from
its ``CONV_*`` environment variables, here flags with the JAX defaults.
Training and scoring run on the card unless ``--device cpu``; with the
constant reward, stage 2's REINFORCE reduction runs the K4-K6 kernels.
"""

import argparse
import copy
import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path[:0] = [
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.path.dirname(os.path.abspath(__file__)),
]

from budget_matched_eval_torch import mma_bands, truncate_dir  # noqa: E402
from convergence_experiment_torch import learned_mma, sift_mma, train_config  # noqa: E402
from selection_stability_torch import MODEL_CONFIG as HEAD192_CONFIG  # noqa: E402
from selection_stability_torch import make_eval_fixture  # noqa: E402

# tools/convergence_experiment.py:53-67's defaults of CONV_ROT, CONV_SCALE,
# CONV_PHOTO, CONV_LR1, CONV_PAIRS and CONV_MODEL
RECIPE = {"rot": 30.0, "scale": 0.3, "photo": 1.3, "lr1": 1e-4, "pairs": 256, "model": "default"}

# name -> (epochs, steps/epoch, lr, decay_at_epoch, reward_thr, kp_penalty
#          [, reward_thr_final, reward_anneal_epochs]); tools/stage2_sweep.py:70-123
VARIANTS = {
    # double the hot5x200 budget; decay 0.1 at 80% like the reference's
    # 5-epoch/decay-at-4 shape
    "hot10x200": (10, 200, 5e-3, 8, 2, -0.001),
    # tighter reward: only <1px-consistent pairs count as good
    "rt1": (5, 200, 5e-3, 4, 1, -0.001),
    # stronger keypoint-count penalty
    "kp2": (5, 200, 5e-3, 4, 2, -0.002),
    "hot10_rt1_kp2": (10, 200, 5e-3, 8, 1, -0.002),
    "hot10_rt1": (10, 200, 5e-3, 8, 1, -0.001),
    # does tightening past 1 px keep sharpening the ranking, or starve the reward?
    "rt05": (5, 200, 5e-3, 4, 0.5, -0.001),
    # curricula: start at a permissive threshold and anneal into a tight one
    "a1to05": (10, 200, 5e-3, 8, 1, -0.001, 0.5, 8),
    "a2to05": (10, 200, 5e-3, 8, 2, -0.001, 0.5, 8),
    "a2to1": (10, 200, 5e-3, 8, 2, -0.001, 1, 8),
    # 1.5x budget for the winning curriculum shape (decay at 12)
    "h15_a2to05": (15, 200, 5e-3, 12, 2, -0.001, 0.5, 12),
    # anneal across the whole schedule (the final threshold at epoch 10)
    "ramp2to05": (10, 200, 5e-3, 8, 2, -0.001, 0.5, 9),
    # the anneal's endpoint further into the sub-noise band (:133-134)
    "a2to025": (10, 200, 5e-3, 8, 2, -0.001, 0.25, 8),
    "ramp2to025": (10, 200, 5e-3, 8, 2, -0.001, 0.25, 9),
}

# name -> (base variant, DiskLoss_config overrides, top-level config
# overrides); tools/stage2_sweep.py:125-166: denser proposal cells, another
# seed, the continuous (dynamic) reward, the reward at the quad-refined
# coordinates (qr) and the soft-argmax localization term (locN, weight N)
EXTRAS = {
    "cell4_a2to05": ("a2to05", {"grid_size": 4}, None),
    "cell4_ramp2to05": ("ramp2to05", {"grid_size": 4}, None),
    "ramp2to05_s1": ("ramp2to05", None, {"seed": 1}),
    "a2to05_s1": ("a2to05", None, {"seed": 1}),
    "dyn2": ("hot10x200", {"epipolar_reward": "dynamic_reward"}, None),
    "dyn1": ("hot10_rt1", {"epipolar_reward": "dynamic_reward"}, None),
    "dyn2to05": ("a2to05", {"epipolar_reward": "dynamic_reward"}, None),
    "qr_ramp2to05": ("ramp2to05", {"reward_at_refined": True}, None),
    "loc1_ramp2to05": ("ramp2to05", {"loc_weight": 1.0}, None),
    "loc10_ramp2to05": ("ramp2to05", {"loc_weight": 10.0}, None),
    "loc100_ramp2to05": ("ramp2to05", {"loc_weight": 100.0}, None),
    "qrloc10_ramp2to05": ("ramp2to05", {"reward_at_refined": True, "loc_weight": 10.0}, None),
    "loc10t5_ramp2to05": ("ramp2to05", {"loc_weight": 10.0, "loc_temperature": 5.0}, None),
    "loc30_ramp2to05": ("ramp2to05", {"loc_weight": 30.0}, None),
    "loc10w5_ramp2to05": ("ramp2to05", {"loc_weight": 10.0, "loc_window": 5}, None),
}

PER_SEED = ("mma3_n128", "mma3_n256", "mma3_n128_quad", "mma3_n128_quad5", "matched_mma3", "matched_mma5",
            "matched_mma3_quad5")


def kp_config(name, ck1, epochs, steps, lr, decay_at, rthr, kpen, thr_final=None, anneal_epochs=0,
              disk_extras=None, cfg_extras=None, recipe=RECIPE):
    """The stage-2 config of one variant (tools/stage2_sweep.py:168-186)
    on the port's two-stage recipe, with ``recipe``'s nuisances."""
    cfg = train_config("kp", steps, recipe["rot"], recipe["scale"], recipe["photo"], recipe["lr1"],
                       recipe["pairs"], load_path=ck1)
    if recipe["model"] == "head192":
        cfg["model_config"] = copy.deepcopy(HEAD192_CONFIG)
    cfg["checkpoint_name"] = f"kp_{name}"
    cfg["epoch"] = epochs
    cfg["optimal_lrs"] = [lr]
    cfg["lr_decay_step"] = decay_at
    cfg["lr_decay_factor"] = 0.1
    cfg["DiskLoss_config"]["reward_config"]["reward_thr"] = rthr
    if thr_final is not None:
        cfg["DiskLoss_config"]["reward_config"]["reward_thr_final"] = thr_final
        cfg["DiskLoss_config"]["reward_config"]["reward_anneal_epochs"] = anneal_epochs
    cfg["DiskLoss_config"]["kp_penalty"] = kpen
    cfg["DiskLoss_config"].update(disk_extras or {})
    cfg.update(cfg_extras or {})
    return cfg


def variant(name):
    """(tuple, DiskLoss_config overrides, config overrides) of a named variant."""
    base, extras, cextras = EXTRAS.get(name, (name, None, None))
    return VARIANTS[base], extras, cextras


def matched_budget_mma(work, run_name, refine=None, device=None):
    """Budget-matched MMA bands of a run's 256-point slates (avg3, or the
    ``refine`` extraction) against the shared SIFT arm: each image's
    learned slate truncated to the SIFT arm's count for that image."""
    sift_dir = os.path.join(work, "ckpts", "hp", "sift_arm", "desc")
    tag = f"{run_name}_n256" + (f"_{refine}" if refine else "")
    counts = {os.path.relpath(f, sift_dir): int(np.load(f)["keypoints"].shape[0])
              for f in sorted(glob.glob(os.path.join(sift_dir, "*", "*.c")))}
    tmp = tempfile.mkdtemp(prefix="bmatch_")
    try:
        d = os.path.join(tmp, "matched")
        truncate_dir(os.path.join(work, "ckpts", "hp", tag, "desc"), d, "c", lambda rel: counts[rel])
        return mma_bands(d, "c", os.path.join(work, "hp_eval"), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sift_arm(work, ck1, recipe=RECIPE, device=None):
    """The fixture under ``work`` and the shared SIFT arm's MMA@3."""
    data_root = os.path.join(work, "hp_eval")
    os.makedirs(data_root, exist_ok=True)
    make_eval_fixture(data_root, rot_max=recipe["rot"], scale_range=(1.0 - recipe["scale"], 1.0 + recipe["scale"]),
                      photo_strength=recipe["photo"])
    return sift_mma("sift_arm", data_root, work, ck1, device)[0]


def run_variant(work, name, tup, ck1, sift3, seeds=1, extras=None, cextras=None, recipe=RECIPE, device=None):
    """One variant, ``tup`` its (epochs, steps, lr, decay_at, reward_thr,
    kp_penalty[, reward_thr_final, reward_anneal_epochs]), over ``seeds``
    seeds: prints each seed's line and returns the variant's record."""
    from posfeat_tpu_torch.train import Trainer

    epochs, steps, lr, decay_at, rthr, kpen, *anneal = tup
    data_root = os.path.join(work, "hp_eval")
    rec = {"variant": name, "epochs": epochs, "steps": steps, "lr": lr, "reward_thr": rthr, "kp_penalty": kpen,
           "seeds": seeds, "sift_arm_mma3": round(sift3, 4)}
    if extras:
        rec["disk_extras"] = extras
    if anneal:
        rec["reward_thr_final"], rec["reward_anneal_epochs"] = anneal
    per_seed = {k: [] for k in PER_SEED}
    for seed in range(seeds):
        t0 = time.time()
        ce = dict(cextras or {})
        ce["seed"] = ce.get("seed", 0) + seed
        run_name = name if seeds == 1 else f"{name}_s{seed}"
        cfg = kp_config(run_name, ck1, epochs, steps, lr, decay_at, rthr, kpen, *anneal, disk_extras=extras,
                        cfg_extras=ce, recipe=recipe)
        Trainer(cfg, ckpt_root=os.path.join(work, "ckpts"), device=device).train()
        ck2 = os.path.join(work, "ckpts", f"kp_{run_name}", f"{epochs:03d}")
        for n_pts in (128, 256):
            m3 = learned_mma(f"{run_name}_n{n_pts}", data_root, work, ck2, device, num_pts=n_pts)
            per_seed[f"mma3_n{n_pts}"].append(round(m3, 4))
        # the Taylor sub-pixel refiners: the same checkpoint and selection
        for rf in ("quad", "quad5"):
            m3q = learned_mma(f"{run_name}_n128_{rf}", data_root, work, ck2, device, num_pts=128,
                              detector_extra={"refine": rf})
            per_seed[f"mma3_n128_{rf}"].append(round(m3q, 4))
        # budget-matched bands of the avg3 and the quad5-refined 256-point slates
        learned_mma(f"{run_name}_n256_quad5", data_root, work, ck2, device, num_pts=256,
                    detector_extra={"refine": "quad5"})
        mb = matched_budget_mma(work, run_name, device=device)
        mbq = matched_budget_mma(work, run_name, refine="quad5", device=device)
        per_seed["matched_mma3"].append(mb["mma3"])
        per_seed["matched_mma5"].append(mb["mma5"])
        per_seed["matched_mma3_quad5"].append(mbq["mma3"])
        print(json.dumps({"variant": name, "seed": seed, "secs": round(time.time() - t0, 1),
                          **{k: v[-1] for k, v in per_seed.items()}}), flush=True)
    for k, vals in per_seed.items():
        if seeds == 1:
            rec[k] = vals[0]
        else:
            rec[k] = vals
            rec[f"{k}_mean"] = round(float(np.mean(vals)), 4)
            rec[f"{k}_std"] = round(float(np.std(vals)), 4)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt1", required=True, help="stage-1 checkpoint dir")
    ap.add_argument("--work", default=None)
    ap.add_argument("--variants", default="hot10x200,rt1,kp2,hot10_rt1_kp2")
    ap.add_argument("--seeds", type=int, default=1,
                    help="replicates per variant (seed 0..N-1); REINFORCE cells carry seed-to-seed noise, so a "
                         "small-delta ranking needs N >= 3")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--rot", type=float, default=RECIPE["rot"], help="largest rotation, degrees (CONV_ROT)")
    ap.add_argument("--scale", type=float, default=RECIPE["scale"], help="scales within 1 ± this (CONV_SCALE)")
    ap.add_argument("--photo", type=float, default=RECIPE["photo"], help="photometric strength (CONV_PHOTO)")
    ap.add_argument("--lr1", type=float, default=RECIPE["lr1"], help="stage-1 learning rate (CONV_LR1)")
    ap.add_argument("--pairs", type=int, default=RECIPE["pairs"], help="distinct training pairs (CONV_PAIRS)")
    ap.add_argument("--model", choices=("default", "head192"), default=RECIPE["model"], help="(CONV_MODEL)")
    args = ap.parse_args(argv)
    recipe = {k: getattr(args, k) for k in RECIPE}

    work = args.work or tempfile.mkdtemp(prefix="s2sweep_")
    print("work dir:", work, flush=True)
    sift3 = sift_arm(work, args.ckpt1, recipe, args.device)
    print(json.dumps({"variant": "sift_arm", "mma3": round(sift3, 4)}), flush=True)
    results = {"sift_arm": sift3}
    for name in args.variants.split(","):
        tup, extras, cextras = variant(name)
        results[name] = run_variant(work, name, tup, args.ckpt1, sift3, args.seeds, extras, cextras, recipe,
                                    args.device)
    return results


if __name__ == "__main__":
    main()
