#!/usr/bin/env python3
"""The convergence proof of posfeat_tpu_torch: the port's counterpart of
tools/convergence_experiment.py, which tests/test_training_convergence.py
runs for the JAX package.

It trains stage 1 (Line2Window + EpipolarLoss_full, Adam on the backbone)
from random init on SyntheticPairs at 96x128, then stage 2 (DiskLoss, SGD
on the head) from that checkpoint, and scores an unseen synthetic-HPatches
fixture drawn from the same nuisance distribution with the HPatches
protocol (MMA@3 and MMA@1, mutual-NN matching):

  * stage 1 with OpenCV SIFT keypoints and the port's descriptors, the
    reference's stage-1 validation protocol (train_desc.yaml's val
    detector 'sift'), before and after training;
  * stage 2 with the learned detector (``generate_kpts_single``, 512
    points), on the stage-1 checkpoint (an untrained head) and after
    stage 2; with the trends of n_pairs and reinforce over stage 2.

The nuisance magnitudes, the stage-1 learning rate and the number of
distinct training pairs are arguments. tests/test_torch_convergence.py
runs the JAX test's regime (rotation 20, scale 0.18, photometric 1.15,
lr 3e-4, 512 pairs, 500 + 250 steps) and asserts the JAX test's margins.

    python3 tools/convergence_experiment_torch.py --work DIR [--steps 500] [--rot 20]
        [--scale 0.18] [--photo 1.15] [--lr1 3e-4] [--pairs 512] [--device cpu]
        [--seed 0] [--init CKPT_DIR] [--stage1-only]

It prints one JSON record on its last line; ``--device`` defaults to the
card.
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tools/convergence_experiment.py:26-46
MODEL_CONFIG = {
    "backbone": "ResUNet",
    "backbone_config": {"encoder": "resnet18", "pretrained": False, "coarse_out_ch": 64, "fine_out_ch": 64},
    "localheader": "KeypointDet",
    "localheader_config": {"in_channels": 128, "prior": "identity", "act": "Softplus"},
    "align_local_grad": False,
    "local_input_elements": ["local_map", "local_map_small"],
    "local_with_img": True,
}
H, W = 96, 128
# EpipolarLoss_full's grid and window weights: from random init the dense
# grid term is the signal that bootstraps the descriptors
# (tools/convergence_experiment.py:133-145)
W_G, W_W = 1.0, 1.0
POSTFIX = "c"
N_SIFT_SEQ = 4  # the fixture: 2 illumination and 2 viewpoint sequences of 6 images


def train_config(stage, steps, rot, scale, photo, lr1, pairs, load_path=None, seed=0):
    """tools/convergence_experiment.py:148-232: stage "desc" trains the
    backbone, "kp" the head, each from ``load_path`` when given."""
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
        "seed": seed,
        "model": "PoSFeat",
        "model_config": copy.deepcopy(MODEL_CONFIG),
        "data": "SyntheticPairs",
        "data_config_train": {
            "num_pairs": pairs,
            "num_scenes": 32,  # 8 geometries per scene: line constraints intersect
            "height": H,
            "width": W,
            "num_pts": 128,
            "batch_size": 4,
            "workers": 4,
            "photometric": True,
            "rot_max": rot,
            "scale_range": (1.0 - scale, 1.0 + scale),
            "photo_strength": photo,
        },
        "val_config": None,
        "load_path": load_path,
    }
    if stage == "desc":
        base.update({
            "optimal_modules": ["backbone"],
            "optimal_lrs": [lr1],
            "preprocess_train": "Preprocess_Line2Window",
            "preprocess_train_config": {
                "kps_generator": "generate_kpts_regular_grid_random",
                "kps_generator_config": {"grid_size": 16, "map_init": "identity", "keep_spatial": True,
                                         "random_select": "random"},
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
            "EpipolarLoss_full_config": {"grid_cost_thr": 0.5, "win_cost_thr": 0.1, "use_std_as_weight": True,
                                         "weight_grid": W_G, "weight_window": W_W},
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
                "grid_size": 8, "loss_distance": "cos", "temperature_base": 60, "temperature_max": 60,
                "epipolar_reward": "constant_reward", "reward_config": {"reward_thr": 2, "rescale_thr": False},
                "cor_detach": True, "good_reward": 1, "bad_reward": -0.25, "kp_penalty": -0.001,
                "match_grad": False,
            },
        })
    return base


def _score(desc_root, data_root, device):
    from posfeat_tpu_torch.evals import hpatches as hp

    errors = hp.benchmark_features(hp.generate_read_function(desc_root, POSTFIX), data_root, device=device)
    n_i = sum(s.startswith("i_") for s in os.listdir(data_root))
    o3, _, _ = hp.mma_at(errors, 3, n_i, N_SIFT_SEQ - n_i)
    o1, _, _ = hp.mma_at(errors, 1, n_i, N_SIFT_SEQ - n_i)
    return float(o3), float(o1)


def sift_mma(tag, data_root, work, load_path, device=None, seed=0):
    """(MMA@3, MMA@1) of SIFT keypoints (every one OpenCV finds on the
    %16-cropped image, unit scores) with the port's descriptors sampled at
    them: the Extractor's ``use_sift`` passthrough, as
    tools/convergence_experiment.py scores them. ``load_path``: None for
    the random init of ``seed``."""
    from posfeat_tpu_torch.extract import Extractor

    cfg = {
        "output_root": f"hp/{tag}",
        "postfix": POSTFIX,
        "load_path": load_path,
        "loss_distance": "cos",
        "output_desc": True,
        "output_img": False,
        "model": "PoSFeat",
        "model_config": copy.deepcopy(MODEL_CONFIG),
        "data": "HPatch_SIFT",
        "data_config_extract": {"data_path": data_root, "workers": 4},
        "use_sift": True,
    }
    ex = Extractor(cfg, ckpt_root=os.path.join(work, "ckpts"), device=device, seed=seed)
    ex.extract()
    return _score(ex.desc_root, data_root, device)


def learned_mma(tag, data_root, work, load_path, device=None, num_pts=512, detector_extra=None):
    """MMA@3 of the learned detector through the port's Extractor
    (tools/convergence_experiment.py:235-289 without ``use_sift``);
    ``detector_extra`` merges detector_config keys (e.g. ``{"refine":
    "quad"}``)."""
    from posfeat_tpu_torch.extract import Extractor

    cfg = {
        "output_root": f"hp/{tag}",
        "postfix": POSTFIX,
        "load_path": load_path,
        "loss_distance": "cos",
        "output_desc": True,
        "output_img": False,
        "model": "PoSFeat",
        "model_config": copy.deepcopy(MODEL_CONFIG),
        "data": "HPatch_SIFT",
        "data_config_extract": {"data_path": data_root, "batch_size": 4, "workers": 4},
        "local_thr": 0.99,
        "use_sift": False,
        "detector": "generate_kpts_single",
        "detector_config": {"num_pts": num_pts, "stable": True, "use_nms": True, "nms_radius": 1, "thr": False,
                            **(detector_extra or {})},
    }
    ex = Extractor(cfg, ckpt_root=os.path.join(work, "ckpts"), device=device)
    ex.extract()
    return _score(ex.desc_root, data_root, device)[0]


def run(work, steps=500, rot=20.0, scale=0.18, photo=1.15, lr1=3e-4, pairs=512, device=None, init=None,
        stage2=True, seed=0):
    """The two-stage proof (tools/convergence_experiment.py:292-367);
    returns the record. ``init``: a checkpoint directory to start stage 1
    from (and to score as its start) instead of the random weights of
    ``seed``, which also seeds the trainers' draws and batch order;
    ``stage2=False`` stops after stage 1."""
    from posfeat_tpu_torch.train import Trainer
    from selection_stability_torch import make_eval_fixture

    data_root = os.path.join(work, "hp_eval")
    os.makedirs(data_root, exist_ok=True)
    make_eval_fixture(data_root, n_seq=N_SIFT_SEQ, h=H, w=W, rot_max=rot, scale_range=(1 - scale, 1 + scale),
                      photo_strength=photo)
    ckpt_root = os.path.join(work, "ckpts")
    rec = {"steps1": steps, "rot": rot, "scale": scale, "photo": photo, "lr1": lr1, "pairs": pairs, "seed": seed}
    rec["mma3_sift_random_init"], rec["mma1_sift_random_init"] = sift_mma("random", data_root, work, init, device,
                                                                          seed)

    t0 = time.time()
    cfg1 = train_config("desc", steps, rot, scale, photo, lr1, pairs, load_path=init, seed=seed)
    Trainer(cfg1, ckpt_root=ckpt_root, device=device).train()
    rec["seconds_stage1"] = time.time() - t0
    ck1 = os.path.join(ckpt_root, "conv_desc", "001")
    rec["mma3_sift_stage1"], rec["mma1_sift_stage1"] = sift_mma("trained", data_root, work, ck1, device, seed)
    loss1 = [json.loads(x)["total_loss"] for x in open(os.path.join(ckpt_root, "conv_desc", "metrics.jsonl"))]
    rec["loss_stage1_first"], rec["loss_stage1_last"] = loss1[0], loss1[-1]
    if not stage2:
        return rec
    rec["mma3_learned_stage1"] = learned_mma("stage1_learned", data_root, work, ck1, device)

    steps2 = max(steps // 2, 50)
    t0 = time.time()
    Trainer(train_config("kp", steps2, rot, scale, photo, lr1, pairs, load_path=ck1, seed=seed),
            ckpt_root=ckpt_root, device=device).train()
    rec["steps2"], rec["seconds_stage2"] = steps2, time.time() - t0
    recs = [json.loads(x) for x in open(os.path.join(ckpt_root, "conv_kp", "metrics.jsonl"))]
    k = max(len(recs) // 4, 1)  # the records are noisy: average each end of the run
    for key in ("n_pairs", "reinforce"):
        rec[f"{key}_first"] = float(np.mean([r[key] for r in recs[:k]]))
        rec[f"{key}_last"] = float(np.mean([r[key] for r in recs[-k:]]))
    rec["mma3_learned_stage2"] = learned_mma("stage2", data_root, work, os.path.join(ckpt_root, "conv_kp", "001"),
                                             device)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", required=True, help="directory for the fixture, checkpoints and features")
    p.add_argument("--steps", type=int, default=500, help="stage-1 steps; stage 2 takes half, at least 50")
    p.add_argument("--rot", type=float, default=20.0, help="largest rotation, degrees")
    p.add_argument("--scale", type=float, default=0.18, help="scales within 1 ± this")
    p.add_argument("--photo", type=float, default=1.15, help="photometric strength")
    p.add_argument("--lr1", type=float, default=3e-4, help="stage-1 learning rate")
    p.add_argument("--pairs", type=int, default=512, help="distinct training pairs")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--seed", type=int, default=0, help="random init, draws and batch order")
    p.add_argument("--init", default=None, help="checkpoint directory that stage 1 starts from")
    p.add_argument("--stage1-only", action="store_true")
    a = p.parse_args(argv)
    rec = run(a.work, a.steps, a.rot, a.scale, a.photo, a.lr1, a.pairs, a.device, a.init, not a.stage1_only,
              a.seed)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
