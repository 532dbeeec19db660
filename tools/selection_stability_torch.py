#!/usr/bin/env python3
"""The bf16 ΔMMA probe of posfeat_tpu_torch on trained weights: the port's
counterpart of tools/selection_stability.py::trained_probe and of the
parts of tools/convergence_experiment.py that it uses.

HPatches MMA depends on which keypoints win the top-k, so bf16 rounding
can change matching accuracy where a score-map tolerance cannot see it.
The probe trains the small two-stage model on SyntheticPairs (stage 1,
then stage 2 through DiskLoss, whose REINFORCE reduction runs K4-K6 on
the card), writes a synthetic-HPatches fixture and extracts it in three
arms through the port's Extractor:

  f32         float32, the reference dataflow;
  bf16_plain  bfloat16, the reference dataflow (``head_dataflow: False``):
              the bf16 backbone and head without any hand-written kernel;
  bf16        bfloat16 with the fused head (``head_dataflow: "pallas"``),
              which runs K1 and K2 on the card (their plain versions on
              the CPU).

These three pin ``fast_mode: False``. Two more arms take the JAX
package's fast-path gates (tools/selection_stability.py:118-160 strips
them from its f32 arm; the port's f32 extraction never takes them):

  lite        the fused bf16 arm with the "lite" gate set (the ring-skip
              head, im2col, the packed top-k, quad sampling), given
              explicitly in ``fast_gates`` so that it runs on the CPU too;
  ship        lite plus ``backbone_config.desc_tail: split3``.

``gate_arms`` scores them against an f32 arm already extracted.

Each arm is scored with ``evals.hpatches`` (mutual-NN matching on the
device) and compared keypoint by keypoint: top-k overlap per image and
mutual-NN match agreement between neighbouring images of a sequence.
``delta_mma3`` (bf16 − f32) is what a user of the bf16 default sees;
``delta_mma3_kernels`` (bf16 − bf16_plain) is the kernels' own share.

The model is tools/convergence_experiment.py's ``head192`` variant: the
resnet18 encoder with ``fine_out_ch`` 128, so the head's input has the
flagship's 192 channels (128 + 64) and K1 runs its C = 192 path.

    python3 tools/selection_stability_torch.py --work DIR [--ckpt DIR] [--num-pts 512]
        [--n-seq 4] [--height 96 --width 128] [--device cpu] [--gates]

Without ``--ckpt`` it trains the checkpoint first (``--steps1``,
``--steps2``). It prints one JSON record (with ``--gates``, the lite and
ship arms' too). chip_smoke.py phase 13 runs it on the card at 480x640
(8192 points) and at 96x128 (512 points), and phase 22 the gate arms.
"""

import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tools/convergence_experiment.py:26-55 with its head192 variant
MODEL_CONFIG = {
    "backbone": "ResUNet",
    "backbone_config": {
        "encoder": "resnet18",
        "pretrained": False,
        "coarse_out_ch": 64,
        "fine_out_ch": 128,
    },
    "localheader": "KeypointDet",
    "localheader_config": {
        "in_channels": 192,
        "prior": "identity",
        "act": "Softplus",
    },
    "align_local_grad": False,
    "local_input_elements": ["local_map", "local_map_small"],
    "local_with_img": True,
}
# the training resolution and the nuisance magnitudes of
# tools/convergence_experiment.py:57-67
H, W = 96, 128
LR1 = 1e-4
N_PAIRS = 256
ROT_MAX = 30.0
SCALE_RANGE = (0.7, 1.3)
PHOTO_STRENGTH = 1.3
# EpipolarLoss_full's grid and window weights: from random init the grid
# term is the signal that bootstraps the descriptors (convergence_experiment.py:133-137)
W_G = 1.0
W_W = 1.0
# (tag, compute_dtype, head_dataflow) of each arm
ARMS = (("f32", "float32", False), ("bf16_plain", "bfloat16", False), ("bf16", "bfloat16", "pallas"))
# the lite gate set (posfeat_tpu/__init__.py:24-30), and each gate arm's
# fast_gates and backbone_config numerics; both run the fused bf16 head
LITE_GATES = {"head_ring": False, "head_im2col": True, "topk": "approx", "sample_impl": "quad"}
GATE_ARMS = {"lite": (LITE_GATES, {}), "ship": (LITE_GATES, {"desc_tail": "split3"})}
POSTFIX = "c"


def write_ppm(path, im):
    """A uint8 [H, W, 3] RGB image as binary PPM (P6, maxval 255)."""
    h, w = im.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(im, np.uint8).tobytes())


def make_eval_fixture(root, n_seq=4, n_img=6, seed=77, h=None, w=None, rot_max=ROT_MAX,
                      scale_range=SCALE_RANGE, photo_strength=PHOTO_STRENGTH):
    """HPatches-layout sequences (``i_syn0``, ``v_syn1``, ... alternating)
    from the nuisance distribution SyntheticPairs trains on, with unseen
    textures: image 1 a texture, images 2..n_img its warp by a rotation,
    scale and shift ``H_1_i`` with gain, gamma and noise, drawn in the
    order of tools/convergence_experiment.py:70-130. ``h``, ``w`` default
    to the training resolution; the nuisance magnitudes to the probe's."""
    from posfeat_tpu_torch.data.synthetic import _texture, rotation_matrix_2d, warp_perspective_reflect

    fh, fw = h or H, w or W
    rng = np.random.RandomState(seed)
    for si in range(n_seq):
        kind = "i" if si % 2 == 0 else "v"
        seq = os.path.join(root, f"{kind}_syn{si}")
        os.makedirs(seq, exist_ok=True)
        base = _texture(rng, fh, fw)
        write_ppm(os.path.join(seq, "1.ppm"), base)
        for ii in range(2, n_img + 1):
            angle = rng.uniform(-rot_max, rot_max)
            scale = rng.uniform(*scale_range)
            Hm = np.eye(3)
            Hm[:2, :] = rotation_matrix_2d((fw / 2, fh / 2), angle, scale)
            Hm[0, 2] += rng.uniform(-0.05, 0.05) * fw
            Hm[1, 2] += rng.uniform(-0.05, 0.05) * fh
            warped = warp_perspective_reflect(base, Hm, fw, fh)
            s = photo_strength
            wf = warped.astype(np.float32) / 255.0
            gain = 1.0 + (rng.uniform(0.5, 1.6, size=3) - 1.0) * s
            gamma = 1.0 + (rng.uniform(0.6, 1.6) - 1.0) * s
            wf = np.clip(wf * gain, 0, 1) ** max(gamma, 0.05)
            wf = np.clip(wf + rng.randn(fh, fw, 3) * 0.08 * s, 0, 1)
            write_ppm(os.path.join(seq, f"{ii}.ppm"), (wf * 255).astype(np.uint8))
            np.savetxt(os.path.join(seq, f"H_1_{ii}"), Hm)


def train_config(root, stage, steps, load_path=None):
    """The two-stage recipe of tools/convergence_experiment.py:140-232 on
    SyntheticPairs at 96x128, batch 4: ``stage`` "desc" trains the
    backbone (Line2Window, EpipolarLoss_full, Adam 1e-4), "kp" the head
    (DiskLoss, SGD 1e-3) from the stage-1 checkpoint ``load_path``.
    ``root`` is unused, as in the JAX recipe."""
    base = {
        "checkpoint_name": f"conv_{stage}",
        "epoch": 1,
        "epoch_step": steps,
        "lr_decay_step": 10,
        "lr_decay_factor": 0.5,
        "log_freq": max(steps // 4, 1),
        "grad_clip": False,
        "clip_norm": 10.0,
        "optimizer": "Adam",
        "seed": 0,
        "model": "PoSFeat",
        "model_config": copy.deepcopy(MODEL_CONFIG),
        "data": "SyntheticPairs",
        "data_config_train": {
            "num_pairs": N_PAIRS,
            "num_scenes": 32,  # 8 geometries per scene: line constraints intersect
            "height": H,
            "width": W,
            "num_pts": 128,
            "batch_size": 4,
            "workers": 4,
            "photometric": True,
            "rot_max": ROT_MAX,
            "scale_range": SCALE_RANGE,
            "photo_strength": PHOTO_STRENGTH,
        },
        "val_config": None,
        "load_path": load_path,
    }
    if stage == "desc":
        base.update({
            "optimal_modules": ["backbone"],
            "optimal_lrs": [LR1],
            "preprocess_train": "Preprocess_Line2Window",
            "preprocess_train_config": {
                "kps_generator": "generate_kpts_regular_grid_random",
                "kps_generator_config": {
                    "grid_size": 16,
                    "map_init": "identity",
                    "keep_spatial": True,
                    "random_select": "random",
                },
                "window_size": 0.1,
                "loss_distance": "cos",
                "use_nn_grid": False,
                "use_line_search": True,
                "line_search_config": {"line_step": 50, "use_nn": True, "loc_rand": True},
                "temperature_base": 60,
                "temperature_max": 60,
            },
            "losses": ["EpipolarLoss_full"],
            "losses_weight": [1],
            "tb_component": ["loss_w1", "loss_w2"],
            "EpipolarLoss_full_config": {
                "grid_cost_thr": 0.5,
                "win_cost_thr": 0.1,
                "use_std_as_weight": True,
                "weight_grid": W_G,
                "weight_window": W_W,
            },
        })
    else:
        base.update({
            "optimal_modules": ["localheader"],
            "optimal_lrs": [1e-3],
            "optimizer": "SGD",
            "losses": ["DiskLoss"],
            "losses_weight": [1],
            "tb_component": ["reinforce", "kp_penalty"],
            "DiskLoss_config": {
                "grid_size": 8,
                "loss_distance": "cos",
                "temperature_base": 60,
                "temperature_max": 60,
                "epipolar_reward": "constant_reward",
                "reward_config": {"reward_thr": 2, "rescale_thr": False},
                "cor_detach": True,
                "good_reward": 1,
                "bad_reward": -0.25,
                "kp_penalty": -0.001,
                "match_grad": False,
            },
        })
    return base


def train_probe_ckpt(work, steps1=200, steps2=100, device=None):
    """Train stage 1, then stage 2 from it, under ``work/ckpts``; returns
    the stage-2 checkpoint directory. ``device``: None for the card."""
    from posfeat_tpu_torch.train import Trainer

    ckpt_root = os.path.join(work, "ckpts")
    Trainer(train_config(work, "desc", steps1), ckpt_root=ckpt_root, device=device).train()
    ck1 = os.path.join(ckpt_root, "conv_desc", "001")
    Trainer(train_config(work, "kp", steps2, load_path=ck1), ckpt_root=ckpt_root, device=device).train()
    return os.path.join(ckpt_root, "conv_kp", "001")


def _sequence_counts(data_root):
    """(n_i, n_v) of the fixture, for the MMA's normalization."""
    seqs = os.listdir(data_root)
    return sum(s.startswith("i_") for s in seqs), sum(s.startswith("v_") for s in seqs)


def run_arm(tag, ckpt, work, data_root, compute_dtype, head_dataflow, num_pts, device=None, refine="avg3",
            gates=None):
    """Extract the fixture under ``work/ckpts/hp/<tag>`` with the given
    dtype, head dataflow (checked in the model and the run's
    config.yaml) and sub-pixel refiner, score it; returns (desc_dir,
    MMA@3, launches of K1 and K2 during the extraction). ``gates``: a key
    of ``GATE_ARMS``, or None for ``fast_mode: False``."""
    import torch

    from posfeat_tpu_torch.core.config import load_config
    from posfeat_tpu_torch.evals import hpatches as hp
    from posfeat_tpu_torch.extract import Extractor
    from posfeat_tpu_torch.ops import fused_head as fh

    cfg = {
        "output_root": f"hp/{tag}",
        "postfix": POSTFIX,
        "load_path": ckpt,
        "loss_distance": "cos",
        "output_desc": True,
        "output_img": False,
        "model": "PoSFeat",
        "model_config": copy.deepcopy(MODEL_CONFIG),
        "data": "HPatch_SIFT",
        "data_config_extract": {"data_path": data_root, "batch_size": 4, "workers": 2},
        "local_thr": 0.99,
        "use_sift": False,
        "compute_dtype": compute_dtype,
        "head_dataflow": head_dataflow,
        "fast_mode": False,
        "detector": "generate_kpts_single",
        "detector_config": {
            "num_pts": num_pts,
            "stable": True,
            "use_nms": True,
            "nms_radius": 1,
            "thr": False,
            "refine": refine,
        },
    }
    fast_gates, numerics = GATE_ARMS[gates] if gates else ({}, {})
    if gates:
        cfg.update(fast_mode=True, fast_gates=dict(fast_gates))
        cfg["model_config"]["backbone_config"].update(numerics)
    ckpt_root = os.path.join(work, "ckpts")
    ex = Extractor(cfg, ckpt_root=ckpt_root, device=device)
    saved = load_config(os.path.join(ex.save_root, "config.yaml"))
    dataflows = (ex.model.localheader.fused_upsample,
                 saved["model_config"]["localheader_config"]["fused_upsample"])
    if dataflows != (head_dataflow, head_dataflow) or ex.model.dtype != getattr(torch, compute_dtype):
        raise RuntimeError(f"arm {tag}: asked for {compute_dtype} {head_dataflow!r}, got "
                           f"{ex.model.dtype} {dataflows}")
    want = {**(LITE_GATES if gates else {}), "desc_tail": numerics.get("desc_tail", "")}
    got = {**{k: saved["fast_gates"][k] for k in fast_gates}, "desc_tail": ex.model.backbone.desc_tail}
    if got != want or (not gates and saved["fast_gates"]["topk"] != "exact"):
        raise RuntimeError(f"arm {tag}: asked for gates {want}, got {got} ({saved['fast_gates']})")
    fh.conv_phase.launches = fh.head_tail.launches = 0
    ex.extract()
    if ex.device.type == "cuda":
        torch.cuda.synchronize()
    launches = {"K1": fh.conv_phase.launches, "K2": fh.head_tail.launches}
    errors = hp.benchmark_features(hp.generate_read_function(ex.desc_root, POSTFIX), data_root,
                                   device=device)
    mma3, _, _ = hp.mma_at(errors, 3, *_sequence_counts(data_root))
    return ex.desc_root, float(mma3), launches


def _pixel_set(kpts):
    return {tuple(p) for p in np.round(np.asarray(kpts)).astype(int)}


def _match_pairs(k1, d1, k2, d2, device):
    from posfeat_tpu_torch.ops.matchers import mnn_matcher

    m = mnn_matcher(d1, d2, device=device)
    return {
        (tuple(np.round(k1[x]).astype(int)), tuple(np.round(k2[y]).astype(int)))
        for x, y in m
    }


def compare_arms(dir_a, dir_b, device=None):
    """Top-k overlap of each image's keypoints (pixel sets) and the share
    of arm a's mutual-NN matches between neighbouring images of a
    sequence that arm b also finds (tools/selection_stability.py:196-224).
    Returns (overlaps, agreements)."""
    feats = {}
    for root, _, files in os.walk(dir_a):
        for f in sorted(files):
            if f.endswith("." + POSTFIX):
                rel = os.path.relpath(os.path.join(root, f), dir_a)
                feats[rel] = (np.load(os.path.join(dir_a, rel)), np.load(os.path.join(dir_b, rel)))
    overlaps, agreements = [], []
    for a, b in feats.values():
        ka, kb = _pixel_set(a["keypoints"]), _pixel_set(b["keypoints"])
        overlaps.append(len(ka & kb) / max(len(ka), len(kb)))
    keys = sorted(feats)
    for k1, k2 in zip(keys[:-1], keys[1:]):
        if os.path.dirname(k1) != os.path.dirname(k2):
            continue
        (a1, b1), (a2, b2) = feats[k1], feats[k2]
        pa = _match_pairs(a1["keypoints"], a1["descriptors"], a2["keypoints"], a2["descriptors"], device)
        pb = _match_pairs(b1["keypoints"], b1["descriptors"], b2["keypoints"], b2["descriptors"], device)
        agreements.append(len(pa & pb) / max(len(pa), 1))
    return overlaps, agreements


def trained_probe(ckpt, work, num_pts=512, n_seq=4, h=None, w=None, device=None):
    """Write the fixture (``n_seq`` sequences of 6 images at ``h`` x ``w``,
    default 96x128) under ``work/hpatches`` unless it is there, extract and
    score it in each arm with the weights of ``ckpt`` (None: random init),
    and compare the fused bf16 arm with the f32 one and with the plain
    bf16 one. Returns the record, with each arm's MMA@3 and K1/K2
    launches."""
    data_root = os.path.join(work, "hpatches")
    if not os.path.isdir(data_root):
        os.makedirs(data_root)
        make_eval_fixture(data_root, n_seq=n_seq, h=h, w=w)
    out = {tag: run_arm(tag, ckpt, work, data_root, dt, df, num_pts, device) for tag, dt, df in ARMS}
    rec = {f"mma3_{tag}": mma3 for tag, (_, mma3, _) in out.items()}
    rec.update({f"launches_{tag}": launches for tag, (_, _, launches) in out.items()})
    for name, a in (("", "f32"), ("_kernels", "bf16_plain")):
        overlaps, agreements = compare_arms(out[a][0], out["bf16"][0], device)
        rec.update({
            f"delta_mma3{name}": out["bf16"][1] - out[a][1],
            f"topk_overlap_mean{name}": float(np.mean(overlaps)),
            f"topk_overlap_min{name}": float(np.min(overlaps)),
            f"match_agreement_mean{name}": float(np.mean(agreements)),
        })
    rec.update(n_images=len(overlaps), num_pts=num_pts, bf16_head=ARMS[-1][2])
    return rec


def gate_arms(ckpt, work, f32_dir, mma3_f32, num_pts=512, device=None, arms=tuple(GATE_ARMS)):
    """The gate arms on the fixture under ``work/hpatches``, each scored
    and compared with the f32 arm's features in ``f32_dir`` (MMA@3
    ``mma3_f32``): ``delta_mma3_<arm>``, ``topk_overlap_mean_<arm>``,
    ``match_agreement_mean_<arm>``, ``mma3_<arm>`` and the K1/K2
    launches of each."""
    data_root = os.path.join(work, "hpatches")
    rec = {}
    for arm in arms:
        desc_dir, mma3, launches = run_arm(arm, ckpt, work, data_root, "bfloat16", "pallas", num_pts, device,
                                           gates=arm)
        overlaps, agreements = compare_arms(f32_dir, desc_dir, device)
        rec.update({
            f"mma3_{arm}": mma3,
            f"delta_mma3_{arm}": mma3 - mma3_f32,
            f"topk_overlap_mean_{arm}": float(np.mean(overlaps)),
            f"match_agreement_mean_{arm}": float(np.mean(agreements)),
            f"launches_{arm}": launches,
        })
    return rec


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", required=True, help="directory for checkpoints, fixture and features")
    p.add_argument("--ckpt", default=None, help="stage-2 checkpoint dir (default: train one)")
    p.add_argument("--steps1", type=int, default=200)
    p.add_argument("--steps2", type=int, default=100)
    p.add_argument("--num-pts", type=int, default=512)
    p.add_argument("--n-seq", type=int, default=4)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--gates", action="store_true", help="also the lite and ship arms")
    args = p.parse_args(argv)
    ckpt = args.ckpt or train_probe_ckpt(args.work, args.steps1, args.steps2, args.device)
    rec = trained_probe(ckpt, args.work, args.num_pts, args.n_seq, args.height, args.width, args.device)
    if args.gates:
        f32_dir = os.path.join(args.work, "ckpts", "hp", "f32", "desc")
        rec.update(gate_arms(ckpt, args.work, f32_dir, rec["mma3_f32"], args.num_pts, args.device))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
