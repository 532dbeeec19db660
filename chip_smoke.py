#!/usr/bin/env python3
"""Smoke run of posfeat_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases, one line each (more for the build):
  1. device: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc of csrc/*.cu, with each kernel's registers, shared
     memory and spills from -Xptxas -v (and the conv kernels' dynamic
     shared memory at Cin = 192; K2's 24 template instances in one
     line); the four conv kernels, every K2 instance and the three
     reduction kernels (the split, the lse and reward passes) must not
     spill, nor K2 and the reduction kernels keep a stack frame, nor
     ptxas inject more warpgroup.waits (C7517) into the lse or the
     reward pass than their builds carry;
  3. kernels: K1 and K2 at the shapes the main path gives them (B=16,
     h=120, w=160, Cin=192, Cout=128, out_ch=1) against their plain
     versions on the same bf16 inputs, the fused head's score map with
     kernels against the plain versions, and each kernel's time per
     B=16 launch beside its bound, its plain version's and one PyTorch
     call's (library_ms), K1's achieved TFLOP/s and K2's achieved TB/s,
     each with its share of the bound;
  4. the fused bf16 head against the f32 reference dataflow at 480x640;
  5. the main path: an Extractor at the flagship model, bf16, 128 seeded
     480x640 images (8 batches of 16) after a warm-up batch, 8192
     points, npz into a temp dir, with the kernels' launch counts read
     around it;
  6. reduction kernels: the stage-2 REINFORCE lse and reward passes
     (K4-K6) at the training path's shapes (B=6, m=n=4800, D=128, T=60,
     thr=2, rewards 1 / -0.25) on seeded unit descriptors with planted
     matches, half of them on each other's epipolar lines so that the
     outputs carry the good reward, against their plain versions (rtol
     2e-4 on all seven outputs, flipped good/bad decisions at most 1e-3
     of the good pairs; the operands' TF32 split bit for bit; the reward
     pass on the lse pass's outputs, as the reduction runs it, the plain
     version on the plain log-sum-exps), with
     times, bounds, plain times and one PyTorch logsumexp expression;
     each pass's TFLOP/s and share of its bound, its product's three TF32
     products (3xTF32) on the tensor cores, with the same work as f32
     FMAs beside it; the reward pass timed on the split that the
     reduction shares with the lse pass;
  7. stage-2 training at the flagship width: configs/train_kp.yaml with
     the flagship model in f32, SyntheticPairs 480x640 in batches of 6
     through the PrefetchLoader; one step with the kernels against the
     same step through the dense DiskLoss on the same draws (loss rtol
     2e-4, head gradient rtol 2e-3), then a Trainer run of a warm-up
     step and 5 timed steps with the reduction's launch counts read
     around it (one split per reduction): every step finite, the head
     moved, the backbone bit-identical;
  8. the v1 head's conv kernels: K3 (full-res z_img), T1 (no image
     term) and T2 (pre-phased z_img) at the v1 path's shapes (B=16,
     h=120, w=160, Cin=192, Cout=128) against their plain versions on the
     same bf16 inputs, with times, bounds, plain times and cuDNN's conv
     of the trunk half (library_ms), and each one's TFLOP/s and share of
     its bound;
  9. the v1 bf16 head (``fused_head_mode="v1"``) against the f32
     reference dataflow at 480x640, as phase 4 holds v3;
 10. the v1 path: an Extractor with ``head_mode: v1`` at the flagship
     model, bf16, 64 seeded 480x640 images (4 batches of 16) after a
     warm-up batch, 8192 points, with K3's and K2's launches read around
     it (and K1's, which must stay 0);
 11. the per-stage head bench (tools/bench_torch_fused_parts.py) at its
     point, with the launches of K1, K3, T1, T2 and K2 read around it;
 12. stage-1 descriptor training at the flagship width: configs/train_desc.yaml
     with the flagship model in f32, SyntheticPairs 480x640 in batches of
     8; one step on the card against the same step on the CPU (2 pairs of
     240x320, same weights, batch and draws: the loss and the backbone's
     gradient norm under unit weights, percent_w and the running
     statistics under the shipped std weights too), the fused
     engine's window expectation against the reference engine's at the
     flagship shapes on the same centres (rtol 1e-3 / atol 1e-4), then a
     Trainer run of a warm-up step and 4 timed steps: every loss finite,
     the backbone and all its running statistics moved, the head
     bit-identical, the checkpoint files written; it runs no
     hand-written kernel (the JAX stage 1 reaches no Pallas kernel);
 13. the bf16 ΔMMA probe (tools/selection_stability_torch.py): stage 1
     (200 steps) then stage 2 (100 steps, K4-K6 launched) of the small
     head192 model on SyntheticPairs 96x128, batch 4; then at two points,
     480x640 with 8 sequences x 6 images and 8192 points, and 96x128 with
     4 x 6 and 512 points, the synthetic-HPatches fixture extracted in
     three arms (f32 reference dataflow; bf16 reference dataflow, no
     kernels; bf16 fused head, K1 + K2 launched) and scored with
     evals.hpatches on the card: |ΔMMA@3| of the fused arm against the f32
     arm and against the plain bf16 arm at most 0.01, top-k overlap at
     least 0.75 and match agreement at least 0.60 (the JAX test's
     thresholds, tests/test_selection_stability.py:67-71); plus MMA@3 of
     random weights at both points and mnn_matcher's time at 8192 x 8192,
     D = 128;
 14. training as shipped, the slice-E path: a MegaDepth-layout fixture
     (tools/make_megadepth_fixture.py, 2 scenes x 4 images at 480x640),
     the MegaDepth_SIFT loader alone (6 threads) per stage, then
     ``python -m posfeat_tpu_torch.train`` (its ``main``, in this process,
     so that the kernels' counts are read) on configs/train_desc.yaml
     (batch 8) and then configs/train_kp.yaml (batch 6) from stage 1's
     checkpoint, as shipped but for the data paths, 4 steps logged every
     2 and ``compute_dtype``: in f32, then in bf16. Every loss finite;
     the split, the lse and the reward pass launched once in every stage-2
     step and never in stage 1; K1-K3, T1 and T2 never (the head trains
     through its dilated composite); the six visual-dump folders of both
     validation samples hold a file for every logged step; stage 2's
     backbone equal to stage 1's bit for bit; checkpoints f32. Prints
     each run's s/step and its wait for the loader. Budget: 120 s;
then the script's seconds, a ``kernels`` JSON line (K1, K2, K3, T1, T2 and the two reduction
kernels), nvidia-smi's line, and the final
``{"ok": true, "device": {...}}`` line. Any failed check raises and the
exit code is non-zero; without a CUDA card it exits 2 and prints no
result.
"""

import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# posfeat_tpu's FLAGSHIP_MODEL_CONFIG (__graft_entry__.py:24-41)
FLAGSHIP_MODEL_CONFIG = {
    "backbone": "ResUNet",
    "backbone_config": {
        "encoder": "resnet50",
        "pretrained": False,
        "coarse_out_ch": 128,
        "fine_out_ch": 128,
    },
    "localheader": "KeypointDet",
    "localheader_config": {"in_channels": 192, "prior": "identity", "act": "Softplus"},
    "align_local_grad": False,
    "local_input_elements": ["local_map", "local_map_small"],
    "local_with_img": True,
}
H, W, BATCH, NUM_PTS, N_IMAGES = 480, 640, 16, 8192, 128
N_IMAGES_V1 = 64  # the v1 path: 4 batches of 16
# stage 2 (configs/train_kp.yaml): batch 6 pairs, grid 8 -> m = n = 60 * 80
TRAIN_BATCH, GRID, TRAIN_STEPS = 6, 8, 6
# stage 1 (configs/train_desc.yaml): batch 8 pairs, grid 16 -> m = n = 30 * 40;
# its card-vs-CPU step check at 2 pairs of 240x320
DESC_BATCH, DESC_GRID, DESC_STEPS = 8, 16, 5
H_CHECK, W_CHECK, CHECK_BATCH = 240, 320, 2
# training as shipped (phase 14): steps and log frequency of each CLI run, on a
# MegaDepth-layout fixture of SCENES x IMAGES at 480x640; its budget in seconds
SHIPPED_STEPS, SHIPPED_LOG_FREQ, SHIPPED_SCENES, SHIPPED_IMAGES = 4, 2, 2, 4
SHIPPED_BUDGET_S = 120.0
VIS_FOLDERS = ("0_original_images", "1_score_maps", "2_all_keypoints", "3_matched_keypoints",
               "4_matches_less", "5_matches_all")
# the ΔMMA probe (phase 13): training steps, then (height, width, sequences, points) of each point
PROBE_STEPS1, PROBE_STEPS2 = 200, 100
PROBE_POINTS = ((H, W, 8, NUM_PTS), (96, 128, 4, 512))
# tests/test_selection_stability.py:67-71
MAX_DELTA_MMA3, MIN_TOPK_OVERLAP, MIN_MATCH_AGREEMENT = 0.01, 0.75, 0.60
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
SEED = 0


def _time_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _bound(ops, peak, nbytes):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


CONV_KERNELS = ("conv_phase_kernel", "conv_phase_img_full_kernel", "conv_phase_img_none_kernel",
                "conv_phase_img_phase_kernel")


def _kernel_key(mangled):
    """A kernel's key in the ptxas summary: its name, with K2's template
    arguments as head_tail_kernel<LPR,OUT>."""
    m = re.search(r"head_tail_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"head_tail_kernel<{m.group(1)},{m.group(2)}>"
    return next(k for k in (*CONV_KERNELS, "lse_split_kernel", "lse_pass_kernel", "reward_pass_kernel", mangled)
                if k in mangled)


def _ptxas_summary(log):
    """{kernel: {'regs', 'static_smem', 'stack', 'spill_stores', 'spill_loads'}} from -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_key(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {})["regs"] = int(m.group(1))
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def _rate(r, tflop):
    """The conv kernel's achieved TFLOP/s and its share of the bound."""
    return (f"{tflop / r['ms'] * 1e-9:.1f} TFLOP/s achieved ({tflop * 1e-12:.4g} TFLOP per launch), "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def phase_kernels(torch, fh, rng):
    """K1/K2 against their plain versions at the main path's shapes, plus
    times; returns the kernel records (launches filled in later)."""
    dev = torch.device("cuda")
    B, h, w, C, cout, out_ch = BATCH, H // 4, W // 4, 192, 128, 1
    N, KP, kk = 16 * cout, 192, 16
    bf = torch.bfloat16

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    tp, kph = g(B, h + 2, w + 2, C).to(bf), g(9, C, N, scale=0.03).to(bf)
    pat, wm, b2b = g(B, h, w, KP).to(bf), g(B, KP, N, scale=0.03).to(bf), g(B, N, scale=0.1)
    z, s, q = fh.conv_phase(tp, kph, pat, wm, b2b)
    torch.cuda.synchronize()
    zr, sr, qr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)
    # z at bf16 resolution (one ulp of 2^-8 relative, doubled for ties in rounding)
    err1 = (z.float() - zr.float()).abs().max().item()
    torch.testing.assert_close(z.float(), zr.float(), rtol=2 ** -7, atol=1e-2)
    # f32 moments at rtol 1e-3 (atol covers column sums that cancel toward 0)
    n_cells = h * w
    for got, ref in ((s.sum(1), sr.sum(1)), (q.sum(1), qr.sum(1))):
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * ref.abs().mean().item())
    # K2 on K1's z with the pooled IN1 statistics, as the head feeds it
    s1 = s.sum(1).reshape(B, kk, cout).sum(1)
    s2 = q.sum(1).reshape(B, kk, cout).sum(1)
    mu = s1 / (n_cells * kk)
    sc = torch.rsqrt(torch.clamp(s2 / (n_cells * kk) - mu * mu, min=0.0) + 1e-5)
    a, w3, b3 = torch.tensor([0.25], device=dev), g(cout, out_ch, scale=0.1), g(out_ch, scale=0.1)
    u, us, uq = fh.head_tail(z, mu, sc, a, w3, b3)
    torch.cuda.synchronize()
    ur, usr, uqr = fh.head_tail_plain(z, mu, sc, a, w3, b3)
    err2 = (u - ur).abs().max().item()
    torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(us.sum(1), usr.sum(1), rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(uq.sum(1), uqr.sum(1), rtol=1e-3, atol=1e-2)

    # the whole fused head: kernels against plain versions, same bf16 inputs
    trunk = g(B, h, w, C).to(bf)
    img_s = g(B, 4 * h, 4 * w, 3).to(bf)
    k1 = g(3, 3, 3, 64, scale=0.2)
    b1 = g(64, scale=0.1)
    img_y = (torch.nn.functional.conv2d(img_s.permute(0, 3, 1, 2).float(), k1.permute(3, 2, 0, 1), b1, padding=1)
             .permute(0, 2, 3, 1).to(bf))
    head = dict(
        k1_img=k1, b1_img=b1, k2_trunk=g(3, 3, C, cout, scale=0.03), k2_img=g(3, 3, 64, cout, scale=0.05),
        b2=g(cout, scale=0.1), w3=g(1, 1, cout, out_ch, scale=0.1), b3=g(out_ch, scale=0.1),
        prelu_a=torch.tensor([0.25], device=dev), act="Softplus",
    )
    score = fh.fused_head_tail(trunk, img_s, img_y, **head)
    score_plain = fh._fused_head_tail(fh.conv_phase_plain, fh.head_tail_plain, trunk, img_s, img_y, **head)
    torch.cuda.synchronize()
    d = (score - score_plain).abs()
    ref_mean = score_plain.abs().mean().item()
    assert torch.isfinite(score).all() and score.dtype == torch.float32
    # bf16 bound of test_pallas_fused_head.py:217-227
    assert d.max().item() < 2e-2 * ref_mean, (d.max().item(), ref_mean)
    print(f"[3] kernels at B={B} h={h} w={w} Cin={C} Cout={cout} out_ch={out_ch}: "
          f"K1 z max|err| {err1:.4g} (max|z| {zr.float().abs().max().item():.4g}), "
          f"K2 u max|err| {err2:.3g}; fused-head score kernels vs plain max {d.max().item():.3g} "
          f"mean {d.mean().item():.3g} (mean|score| {ref_mean:.4g})")

    # times (CUDA events, after warm-up)
    k1_ms = _time_ms(lambda: fh.conv_phase(tp, kph, pat, wm, b2b))
    k1_plain = _time_ms(lambda: fh.conv_phase_plain(tp, kph, pat, wm, b2b), n=5)
    kph4 = kph.reshape(3, 3, C, N).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    tp_nchw = tp.permute(0, 3, 1, 2)  # channels_last view
    k1_lib = _time_ms(lambda: torch.nn.functional.conv2d(tp_nchw, kph4))
    k2_ms = _time_ms(lambda: fh.head_tail(z, mu, sc, a, w3, b3))
    k2_plain = _time_ms(lambda: fh.head_tail_plain(z, mu, sc, a, w3, b3), n=5)
    zb = z.view(B, -1, kk, cout)
    mu_b, sc_b, w3t = mu[:, None, None].to(bf), sc[:, None, None].to(bf), w3.t().to(bf).contiguous()
    k2_lib = _time_ms(lambda: torch.nn.functional.linear(
        torch.nn.functional.prelu((zb - mu_b) * sc_b, a.to(bf)), w3t, b3.to(bf)))

    M = B * h * w
    k1_bytes = 2 * (tp.numel() + kph.numel() + pat.numel() + wm.numel() + z.numel()) + 4 * (
        b2b.numel() + s.numel() + q.numel())
    k1_bound = _bound(2.0 * M * N * (9 * C + KP), PEAK_BF16, k1_bytes)
    k2_bytes = 2 * z.numel() + 4 * (mu.numel() + sc.numel() + 1 + w3.numel() + b3.numel()
                                    + u.numel() + us.numel() + uq.numel())
    k2_bound = _bound(z.numel() * (3.0 + 2 * out_ch), PEAK_F32, k2_bytes)
    records = [
        {"name": "K1 conv_phase", "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head.cu",
         "replaces": "posfeat_tpu/ops/pallas/fused_head.py:148", "launches": 0,
         "max_abs_err": err1, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": k1_lib},
        {"name": "K2 head_tail", "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head.cu",
         "replaces": "posfeat_tpu/ops/pallas/fused_head.py:284", "launches": 0,
         "max_abs_err": err2, "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib},
    ]
    for r in records:
        print(f"[3] {r['name']}: {r['ms']:.4f} ms per B={B} launch (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms)")
    print(f"[3] K1 conv_phase: {_rate(records[0], 2.0 * M * N * (9 * C + KP))}")
    print(f"[3] K2 head_tail: {k2_bytes / (k2_ms * 1e-3) * 1e-12:.3f} TB/s achieved "
          f"({k2_bytes * 1e-9:.4g} GB per launch), {k2_bound[0] / k2_ms:.1%} of the bound")
    return records


def phase_head_vs_reference(torch, rng, mode="v3", tag="[4]"):
    """The fused bf16 head in ``mode`` against the f32 reference dataflow,
    same weights."""
    from posfeat_tpu_torch.models import KeypointDet, init_parameters

    dev = torch.device("cuda")
    kw = dict(in_channels=192, out_channels=1, prior="identity", act="Softplus")
    fused = KeypointDet(**kw, fused_upsample="pallas", fused_head_mode=mode, dtype=torch.bfloat16)
    init_parameters(fused, torch.Generator().manual_seed(SEED))
    ref = KeypointDet(**kw, fused_upsample=False)
    ref.load_state_dict(fused.state_dict())
    fused, ref = fused.to(dev), ref.to(dev)
    B = 2
    # bf16-representable inputs, so both heads see the same values
    fm = torch.from_numpy(rng.random((B, H // 4, W // 4, 192), dtype=np.float32)).to(dev)
    img = torch.from_numpy(rng.standard_normal((B, H, W, 3), dtype=np.float32)).to(dev)
    fm, img = fm.to(torch.bfloat16).float(), img.to(torch.bfloat16).float()
    with torch.no_grad():
        s_f = fused(fm, img)
        s_r = ref(fm, img)
    torch.cuda.synchronize()
    assert s_f.shape == s_r.shape == (B, H, W, 1) and s_f.dtype == torch.float32
    assert torch.isfinite(s_f).all() and torch.isfinite(s_r).all()
    d = (s_f - s_r).abs()
    scale = s_r.abs().mean().item()
    print(f"{tag} fused bf16 head ({mode}) vs f32 reference dataflow at {H}x{W}: max|d| "
          f"{d.max().item():.4g}, mean|d| {d.mean().item():.4g}, mean|score| {scale:.4g}")
    # bf16 trunk vs f32: the mean within the fused head's bf16 bound
    # (test_pallas_fused_head.py:217-227); the max one catches an O(1)
    # error on the border ring or at a phase-layout corner, which the
    # mean (ring = 1.5% of the pixels) cannot see
    assert d.mean().item() < 2e-2 * scale, (d.mean().item(), scale)
    assert d.max().item() < 1e-1 * scale, (d.max().item(), scale)


def _images(rng, n, tag):
    """Seeded 480x640 uint8 images: smooth blobs plus noise, as dicts of
    the extraction datasets' sample contract."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for i in range(n):
        f = rng.uniform(0.01, 0.08, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
        base = np.stack([np.sin(f[c, 0] * yy + ph[c, 0]) * np.cos(f[c, 1] * xx + ph[c, 1]) for c in range(3)], -1)
        im = 127.5 + 80 * base + rng.normal(0, 20, size=(H, W, 3))
        out.append({
            "im1": None,
            "im1_ori": np.clip(im, 0, 255).astype(np.uint8),
            "coord1": np.zeros((0, 2), np.float32),
            "name1": f"{tag}/{i:03d}.png",
            "pad1": (0, 0, 0, 0),
        })
    return out


def flagship_extractor(tmp, rng, output_root="smoke", head_mode=None):
    """An Extractor at the flagship model (bf16, batch 16, 8192 points,
    fused head, in its v3 dataflow unless ``head_mode`` says "v1"),
    writing npz under ``tmp``, after one warm-up batch of seeded images
    (cuDNN autotuning, allocator). Set ``.dataset`` and call
    ``.extract()`` to drive the main path."""
    import torch
    from posfeat_tpu_torch.extract import Extractor

    cfg = {
        "output_root": output_root, "postfix": "npz", "load_path": None,
        "loss_distance": "cos", "output_desc": True, "output_img": False,
        "compute_dtype": "bfloat16", "model": "PoSFeat",
        "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
        "data": "HPatch_SIFT", "data_config_extract": {"batch_size": BATCH, "workers": 4},
        "use_sift": False, "detector": "generate_kpts_single",
        "detector_config": {"num_pts": NUM_PTS, "stable": True, "use_nms": True,
                            "nms_radius": 1, "thr": 0.9, "thr_mod": "abs"},
    }
    if head_mode is not None:
        cfg["head_mode"] = head_mode
    ex = Extractor(cfg, ckpt_root=tmp, dataset=_images(rng, BATCH, "warm"))
    assert ex.config["model_config"]["localheader_config"]["fused_upsample"] == "pallas"
    assert ex.model.localheader.fused_head_mode == (head_mode or "v3")
    ex.extract()
    torch.cuda.synchronize()
    return ex


def _zero_counts(fh):
    fh.conv_phase.launches = 0
    fh.head_tail.launches = 0
    fh.conv_phase_img.launches = dict.fromkeys(fh.IMG_LAYOUTS, 0)


def _read_counts(fh):
    img = fh.conv_phase_img.launches
    return {"K1 conv_phase": fh.conv_phase.launches, "K2 head_tail": fh.head_tail.launches,
            "K3 conv_phase_img": img["full"], "T1 conv_phase_img": img["none"],
            "T2 conv_phase_img": img["phase"]}


def drive_extraction(torch, fh, rng, n_images, head_mode=None):
    """The flagship Extractor over ``n_images`` seeded images after a
    warm-up batch, every npz checked; returns (images, seconds, peak
    bytes, launches, keypoints per image)."""
    data = _images(rng, n_images, "main")
    with tempfile.TemporaryDirectory() as tmp:
        ex = flagship_extractor(tmp, rng, head_mode=head_mode)
        ex.dataset = data
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fh)
        t0 = time.perf_counter()
        n, _ = ex.extract()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _read_counts(fh)
        peak = torch.cuda.max_memory_allocated()
        assert n == n_images
        counts = []
        for it in data:
            f = np.load(f"{ex.desc_root}/{it['name1']}.npz")
            kp, sc, de = f["keypoints"], f["scores"], f["descriptors"]
            assert kp.dtype == sc.dtype == de.dtype == np.float32
            assert kp.ndim == 2 and kp.shape[1] == 2 and 128 <= kp.shape[0] <= NUM_PTS, kp.shape
            assert sc.shape == (kp.shape[0], 1) and de.shape == (kp.shape[0], 128)
            assert np.isfinite(kp).all() and np.isfinite(sc).all() and np.isfinite(de).all()
            assert ((kp >= 0) & (kp <= [W - 1, H - 1])).all()
            assert np.abs(np.linalg.norm(de, axis=1) - 1).max() < 1e-3
            counts.append(kp.shape[0])
    return n, dt, peak, launches, counts


def phase_main_path(torch, fh, rng, records):
    n, dt, peak, launches, counts = drive_extraction(torch, fh, rng, N_IMAGES)
    for r in records:
        r["launches"] = launches[r["name"]]
        assert r["launches"] > 0, f"{r['name']} was not launched on the main path"
    print(f"[5] main path: {n} images {H}x{W} bf16 in {n // BATCH} batches of {BATCH} after a warm-up batch, "
          f"{NUM_PTS} pts: {n / dt:.2f} im/s ({dt:.3f} s, one pipeline fill and drain included), "
          f"peak memory {peak / 2**30:.2f} GiB, keypoints/image min {min(counts)} max {max(counts)}, "
          f"launches {launches}")


def phase_v1_kernels(torch, fh, rng):
    """K3, T1 and T2 against their plain versions at the v1 path's shapes,
    plus times; returns their kernel records (launches filled in later)."""
    dev = torch.device("cuda")
    B, h, w, C, cout = BATCH, H // 4, W // 4, 192, 128
    N, bf = 16 * cout, torch.bfloat16

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    tp, kph, b2 = g(B, h + 2, w + 2, C).to(bf), g(9, C, N, scale=0.03).to(bf), g(N, scale=0.1)
    kph4 = kph.reshape(3, 3, C, N).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    tp_nchw = tp.permute(0, 3, 1, 2)  # channels_last view
    lib = _time_ms(lambda: torch.nn.functional.conv2d(tp_nchw, kph4))
    kinds = (
        ("full", "K3 conv_phase_img", "posfeat_tpu/ops/pallas/fused_head.py:70", g(B, H, W, cout)),
        ("none", "T1 conv_phase_img", "tools/bench_fused_parts.py:105", None),
        ("phase", "T2 conv_phase_img", "tools/bench_fused_parts.py:154", g(B, h, w, N)),
    )
    records = []
    for layout, name, replaces, zimg in kinds:
        zimg = None if zimg is None else zimg.to(bf)
        z, s, q = fh.conv_phase_img(tp, kph, zimg, b2, layout)
        torch.cuda.synchronize()
        zr, sr, qr = fh.conv_phase_img_plain(tp, kph, zimg, b2, layout)
        # z at bf16 resolution, f32 moments at rtol 1e-3, as for K1
        err = (z.float() - zr.float()).abs().max().item()
        torch.testing.assert_close(z.float(), zr.float(), rtol=2 ** -7, atol=1e-2)
        for got, ref in ((s.sum(1), sr.sum(1)), (q.sum(1), qr.sum(1))):
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * ref.abs().mean().item())
        z_max = zr.float().abs().max().item()
        del zr, sr, qr
        ms = _time_ms(lambda: fh.conv_phase_img(tp, kph, zimg, b2, layout))
        plain = _time_ms(lambda: fh.conv_phase_img_plain(tp, kph, zimg, b2, layout), n=5)
        nbytes = 2 * (tp.numel() + kph.numel() + z.numel() + (0 if zimg is None else zimg.numel())) + 4 * (
            b2.numel() + s.numel() + q.numel())
        bound = _bound(2.0 * B * h * w * N * 9 * C, PEAK_BF16, nbytes)
        records.append({
            "name": name, "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
        })
        print(f"[8] {name} ({layout}) at B={B} h={h} w={w} Cin={C} Cout={cout}: z max|err| {err:.4g} "
              f"(max|z| {z_max:.4g}); {ms:.4f} ms per launch (bound {bound[0]:.4f} ms by {bound[1]}, "
              f"plain {plain:.4f} ms, cuDNN trunk conv {lib:.4f} ms); "
              f"{_rate(records[-1], 2.0 * B * h * w * N * 9 * C)}")
        del z, s, q
    return records


def phase_v1_path(torch, fh, rng, records):
    """The v1 dataflow through Extractor (head_mode: v1)."""
    n, dt, peak, launches, counts = drive_extraction(torch, fh, rng, N_IMAGES_V1, head_mode="v1")
    assert launches["K1 conv_phase"] == 0, launches
    assert launches["K3 conv_phase_img"] > 0 and launches["K2 head_tail"] > 0, launches
    for r in records:
        if r["name"] == "K3 conv_phase_img":
            r["launches"] = launches[r["name"]]
    print(f"[10] v1 path: {n} images {H}x{W} bf16 in {n // BATCH} batches of {BATCH} after a warm-up batch, "
          f"{NUM_PTS} pts, head_mode v1: {n / dt:.2f} im/s ({dt:.3f} s, one pipeline fill and drain "
          f"included), peak memory {peak / 2**30:.2f} GiB, keypoints/image min {min(counts)} max "
          f"{max(counts)}, launches {launches}")


def _load_tool(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_head_bench(torch, fh, records):
    """The per-stage head bench as its CLI runs it, with every fused-head
    kernel's launches read around it: the path of T1 and T2."""
    bench = _load_tool("bench_torch_fused_parts")
    _zero_counts(fh)
    res = bench.run(torch)
    torch.cuda.synchronize()
    launches = _read_counts(fh)
    assert all(v > 0 for v in launches.values()), launches
    for r in records:
        if r["name"] in ("T1 conv_phase_img", "T2 conv_phase_img"):
            r["launches"] = launches[r["name"]]
    stages = ", ".join(f"{k} {v:.4f}" for k, v in res.items())
    print(f"[11] head bench (tools/bench_torch_fused_parts.py, B={bench.B}): ms/img {stages}; "
          f"launches {launches}")


def _unit(torch, x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


# the reduction's keyword arguments on the training path (configs/train_kp.yaml: T = 60, reward_thr 2)
REDUCTION_KW = dict(temperature=60.0, thr=2.0, good_reward=1.0, bad_reward=-0.25)


def reduction_problem(torch, rng):
    """The reduction's inputs at the training path's shapes (B=6,
    m=n=4800, D=128) on the card: seeded unit descriptors with planted
    matches, half of them on each other's epipolar lines. Returns (f1,
    f2, line1, c2h, line2, c1h, accept1, accept2)."""
    from posfeat_tpu_torch.ops.coords import homogenize
    from posfeat_tpu_torch.ops.epipolar import epipolar_lines

    dev = torch.device("cuda")
    B, m, D = TRAIN_BATCH, (H // GRID) * (W // GRID), 128
    n = m

    def g(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    # planted matches: f2[j] is a noisy copy of f1[perm[j]], so p is peaked
    f1 = _unit(torch, g(B, m, D))
    perm = torch.from_numpy(rng.permutation(m)).to(dev)
    f2 = _unit(torch, f1[:, perm] + 0.15 * g(B, n, D)).contiguous()
    c1, c2 = (torch.from_numpy((rng.uniform(0, 1, (B, k, 2)) * [W - 1, H - 1]).astype(np.float32)).to(dev)
              for k in (m, n))
    F1 = []
    for _ in range(B):  # random rank-2 fundamental matrices
        u, _, vt = np.linalg.svd(rng.standard_normal((3, 3)))
        F1.append(u @ np.diag([1.0, rng.uniform(0.3, 1.0), 0.0]) @ vt)
    F1 = torch.from_numpy(np.stack(F1).astype(np.float32)).to(dev)
    F2 = F1.mT.contiguous()  # image 2 -> image 1, as for a real pair
    line1 = epipolar_lines(F1, c1).contiguous()
    # half of the planted matches are epipolar-good: c2[j] on the line of
    # c1[perm[j]], up to 200 px from the foot of the image centre
    lp = line1[:, perm]
    ctr = torch.tensor([(W - 1) / 2, (H - 1) / 2], device=dev)
    off = (lp[..., :2] * ctr).sum(-1, keepdim=True) + lp[..., 2:]
    t = torch.from_numpy(rng.uniform(-200, 200, (B, n, 1)).astype(np.float32)).to(dev)
    on_line = ctr - off * lp[..., :2] + t * torch.stack([-lp[..., 1], lp[..., 0]], -1)
    c2 = torch.where(torch.from_numpy(rng.random((B, n, 1)) < 0.5).to(dev), on_line, c2)
    a1 = (torch.from_numpy(rng.random((B, m))) > 0.5).float().to(dev)
    a2 = (torch.from_numpy(rng.random((B, n))) > 0.5).float().to(dev)
    return f1, f2, line1, homogenize(c2), epipolar_lines(F2, c2).contiguous(), homogenize(c1), a1, a2


def phase_reduction(torch, rng):
    """The lse and reward passes against their plain versions at the
    training path's shapes, plus times; returns their kernel records."""
    from posfeat_tpu_torch.ops import reinforce as rf

    args = reduction_problem(torch, rng)
    f1, f2 = args[:2]
    (B, m, D), n = f1.shape, f2.shape[1]
    kw = REDUCTION_KW
    T = kw["temperature"]

    # JAX's tolerance (test_pallas_reinforce.py:70) on every output
    def close(got, ref):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5)
        return (got - ref).abs().max().item()

    # the operands' TF32 split, shared by both passes, bit for bit
    tiles = rf._split_operands(f1, f2)
    torch.cuda.synchronize()
    assert torch.equal(tiles[0], rf._split_plain(f1, True)) and torch.equal(tiles[1], rf._split_plain(f2, False))
    rl, cl = rf.lse_pass(f1, f2, T)
    torch.cuda.synchronize()
    rlp, clp = rf.lse_pass_plain(f1, f2, T)
    err_lse = max(close(rl, rlp), close(cl, clp))
    # the reward kernel and its plain version on the same inputs (the plain
    # log-sum-exps), all seven outputs and the decisions; then the kernel as
    # the reduction runs it, on the lse kernel's outputs, against the same
    # plain run (its 3xTF32 dots' error partly cancels in lp there)
    ref = rf.reward_pass_plain(*args, rlp, clp, **kw)
    n_good = ref[7].sum().item()
    errs, s0_rel, flips = [], [], []
    for lse in ((rlp, clp), (rl, cl)):
        out = rf.reward_pass(*args, *lse, **kw, tiles=tiles)
        torch.cuda.synchronize()
        errs.append(max(close(o, r) for o, r in zip(out[:7], ref[:7])))
        s0_rel.append(((out[0] - ref[0]).abs() / ref[0].abs()).max().item())
        # pairs at exactly thr may flip good <-> bad between kernel and plain
        flips.append((out[7] - ref[7]).abs().sum().item())
        assert flips[-1] <= 1e-3 * n_good, (flips, n_good)
    err_rw = errs[0]
    # the planted good matches carry the good reward: a column whose
    # match is good and accepted has colW near good_reward * p
    assert ref[2].amax().item() > 0.5 * kw["good_reward"], ref[2].amax().item()
    whole = rf.reinforce_reduction(*args, **kw)
    torch.cuda.synchronize()
    whole_ref = rf.reinforce_reduction_plain(*args, **kw)
    err_whole = max(close(o, r) for o, r in zip(whole, whole_ref))
    print(f"[6] reduction at B={B} m={m} n={n} D={D} T={T:g} thr={kw['thr']:g}: lse max|err| {err_lse:.3g}, "
          f"reward outputs max|err| {errs[0]:.3g} on the plain lse (s0 rel {s0_rel[0]:.3g}), {errs[1]:.3g} on "
          f"the lse kernel's (s0 rel {s0_rel[1]:.3g}), "
          f"whole reduction max|err| {err_whole:.3g}; good pairs "
          f"{int(n_good)} of {B * m * n}, flipped {flips[0]:g} / {flips[1]:g}; max colW {ref[2].amax().item():.4g}, "
          f"s0 {whole_ref[0].min().item():.5g}..{whole_ref[0].max().item():.5g}, "
          f"p_max {whole_ref[5].min().item():.4g}..{whole_ref[5].max().item():.4g}, "
          f"p_sum/m {(whole_ref[6] / m).mean().item():.4g}")

    lse_ms = _time_ms(lambda: rf.lse_pass(f1, f2, T))
    lse_plain = _time_ms(lambda: rf.lse_pass_plain(f1, f2, T), n=5)

    def lse_library():
        aff = T * torch.bmm(f1, f2.mT) - T
        return torch.logsumexp(aff, -1), torch.logsumexp(aff, 1)

    lse_lib = _time_ms(lse_library, n=10)
    # the reward pass as the reduction runs it, on the split it shares with the lse pass
    rw_ms = _time_ms(lambda: rf.reward_pass(*args, rl, cl, **kw, tiles=tiles))
    rw_plain = _time_ms(lambda: rf.reward_pass_plain(*args, rl, cl, **kw), n=5)
    split_ms = _time_ms(lambda: rf._split_operands(f1, f2))
    whole_ms = _time_ms(lambda: rf.reinforce_reduction(*args, **kw))
    pairs, f4 = B * m * n, 4
    product = 2.0 * pairs * D
    # both passes run their product on the tensor cores as 3xTF32: three
    # TF32 products (hi·hi, hi·lo, lo·hi) at the TF32 peak. Their
    # epilogues run on the f32 cores and take less at their peak: the lse
    # pass's (scale, two max, two exp, two adds per pair) 0.017 ms, the
    # reward pass's (scale, two subtractions, exp, two 3-term distances,
    # compares, W and six sums, about 24 operations per pair) 0.05 ms at
    # B=6, m=n=4800
    lse_bound = _bound(3 * product, PEAK_TF32, f4 * (f1.numel() + f2.numel() + rl.numel() + cl.numel()))
    rw_bytes = f4 * (sum(a.numel() for a in args) + rl.numel() + cl.numel() + 2 * m * B + 2 * n * B + 3 * B)
    rw_bound = _bound(3 * product, PEAK_TF32, rw_bytes)
    records = [
        {"name": "K4+K5 lse_pass", "route": "cuda", "source": "posfeat_tpu_torch/csrc/reinforce.cu",
         "replaces": "posfeat_tpu/ops/pallas/reinforce.py:66", "launches": 0, "max_abs_err": err_lse,
         "ms": lse_ms, "plain_ms": lse_plain, "bound_ms": lse_bound[0], "bound_by": lse_bound[1],
         "library_ms": lse_lib},
        {"name": "K6 reward_pass", "route": "cuda", "source": "posfeat_tpu_torch/csrc/reinforce.cu",
         "replaces": "posfeat_tpu/ops/pallas/reinforce.py:110", "launches": 0, "max_abs_err": err_rw,
         "ms": rw_ms, "plain_ms": rw_plain, "bound_ms": rw_bound[0], "bound_by": rw_bound[1],
         "library_ms": None},
    ]
    for r in records:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[6] {r['name']}: {r['ms']:.4f} ms per B={B} launch (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {lib})")
    # the product and epilogue as f32 FMAs on the CUDA cores, each pass's
    # bound before its product moved to the tensor cores
    for r, epi_ops in zip(records, (8, 24)):
        f32_ms = pairs * (2.0 * D + epi_ops) / PEAK_F32 * 1e3
        print(f"[6] {r['name']}: {product / (r['ms'] * 1e-3) * 1e-12:.2f} TFLOP/s of the product "
              f"({product * 1e-9:.4g} GFLOP per launch), {r['bound_ms'] / r['ms']:.1%} of its bound "
              f"(3xTF32 on the tensor cores); the same work as f32 FMAs would be bounded at {f32_ms:.4f} ms "
              f"({f32_ms / r['ms']:.1%} of its time)")
    print(f"[6] split of f1 and f2 (lse_split_kernel, once per reduction): {split_ms:.4f} ms; whole reduction "
          f"(one split, both passes, the merges): {whole_ms:.4f} ms per B={B} call")
    return records


def train_config():
    """configs/train_kp.yaml as shipped, with the flagship model in f32,
    random weights from the seed, ``val_config`` removed and
    SyntheticPairs at 480x640, one epoch of TRAIN_STEPS steps, every step
    logged."""
    from posfeat_tpu_torch.core.config import load_config

    cfg = load_config("configs/train_kp.yaml")
    cfg.pop("val_config")  # no visual dumps: s/step stays comparable with earlier runs
    cfg.update(
        checkpoint_name="smoke_kp", model_config=copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
        compute_dtype="float32", load_path=None, epoch=1, epoch_step=TRAIN_STEPS, log_freq=1,
        data="SyntheticPairs",
    )
    cfg["data_config_train"].update(num_pairs=64, height=H, width=W)
    assert cfg["data_config_train"]["batch_size"] == TRAIN_BATCH
    assert cfg["DiskLoss_config"]["grid_size"] == GRID
    return cfg


def phase_training(torch, records):
    """Stage-2 training at the flagship width through Trainer."""
    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.losses import DiskLoss
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.train import Trainer

    cfg = train_config()
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp, device="cuda")
        assert tr.device.type == "cuda"
        head, backbone = tr.model.localheader, tr.model.backbone
        head0 = {k: v.clone() for k, v in head.state_dict().items()}
        bb0 = {k: v.clone() for k, v in backbone.state_dict().items()}

        # one step's loss and head gradient: kernels against the dense DiskLoss
        batch = tr.to_device(collate([tr.train_dataset[i] for i in range(TRAIN_BATCH)]))
        name, weight, loss_k = tr.loss_fns[0]
        assert loss_k._use_streamed(FLAGSHIP_MODEL_CONFIG["backbone_config"]["fine_out_ch"])
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.no_grad():
            out = tr.model(batch)
            draws = tuple(loss_k.draw(out[p]["local_point"], gen) for p in ("preds1", "preds2"))

        def step_with(loss_fn):
            tr.loss_fns = [(name, weight, loss_fn)]
            head.zero_grad(set_to_none=True)
            total, comps = tr.loss(batch, 1, draws)
            total.backward()
            return total.item(), {k: float(v) for k, v in comps.items()}, [p.grad.clone() for p in head.parameters()]

        l_k, c_k, g_k = step_with(loss_k)
        l_d, c_d, g_d = step_with(DiskLoss({**cfg["DiskLoss_config"], "use_pallas": False}))
        tr.loss_fns = [(name, weight, loss_k)]
        head.zero_grad(set_to_none=True)
        assert np.isfinite(l_k) and abs(l_k - l_d) <= 2e-4 * abs(l_d) + 1e-5, (l_k, l_d)
        # each head gradient entry is a sum over 12 images and 57,600
        # samples of terms of both signs, and the biases before an
        # InstanceNorm have a gradient of exactly 0 up to rounding: hold the
        # whole head's gradient to rtol 2e-3 in norm, and every entry to
        # 2e-3 of the largest
        gk, gd = torch.cat([a.flatten() for a in g_k]), torch.cat([b.flatten() for b in g_d])
        g_rel = ((gk - gd).norm() / gd.norm()).item()
        g_err, g_max = (gk - gd).abs().max().item(), gd.abs().max().item()
        assert g_rel <= 2e-3 and g_err <= 2e-3 * g_max, (g_rel, g_err, g_max)
        print(f"[7] one step, kernels vs dense DiskLoss on the same draws: loss {l_k:.6g} vs {l_d:.6g}, "
              f"head grad |d|/|g| {g_rel:.3g}, max|d| {g_err:.3g} (max|grad| {g_max:.4g}); reinforce {c_k['reinforce']:.6g} vs {c_d['reinforce']:.6g}, "
              f"n_pairs {c_k['n_pairs']:.5g} vs {c_d['n_pairs']:.5g}")

        # the main path: Trainer.train, as the CLI runs it
        rf.lse_pass.launches = 0
        rf.reward_pass.launches = 0
        rf._split_operands.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K4+K5 lse_pass": rf.lse_pass.launches, "K6 reward_pass": rf.reward_pass.launches}
        # one split of f1 and f2 per reduction, shared by its two passes
        assert rf._split_operands.launches == launches["K4+K5 lse_pass"] == launches["K6 reward_pass"], (
            rf._split_operands.launches, launches)
        peak = torch.cuda.max_memory_allocated()

        run = f"{tmp}/{cfg['checkpoint_name']}"
        steps = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
        metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
        assert len(steps) == len(metrics) == TRAIN_STEPS, (len(steps), len(metrics))
        assert all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm/localheader"]) for r in metrics)
        assert not [f for f in os.listdir(run) if f.startswith("error_step")]
        assert sorted(os.listdir(f"{run}/001")) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
        moved = sum(not torch.equal(v, head0[k]) for k, v in head.state_dict().items())
        assert moved > 0, "the head's parameters did not move"
        assert all(torch.equal(v, bb0[k]) for k, v in backbone.state_dict().items()), "the backbone moved"
    for r in records:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]
            assert r["launches"] > 0, f"{r['name']} was not launched on the training path"
    timed = [s["step_time_s"] for s in steps[1:]]
    s_step = float(np.mean(timed))
    print(f"[7] training: {TRAIN_STEPS} Trainer steps at {H}x{W}, batch {TRAIN_BATCH} pairs, f32, "
          f"m = n = {(H // GRID) * (W // GRID)}: warm-up {steps[0]['step_time_s']:.4f} s, then "
          f"{s_step:.4f} s/step over {len(timed)} steps (min {min(timed):.4f}, max {max(timed):.4f}), "
          f"{TRAIN_BATCH / s_step:.3f} pairs/s; wall {wall:.3f} s with checkpoints; peak memory "
          f"{peak / 2**30:.2f} GiB; {moved} head tensors moved, backbone unchanged; loss "
          f"{metrics[0]['total_loss']:.5g} -> {metrics[-1]['total_loss']:.5g}; launches {launches}")


def desc_config(height=H, width=W, batch=DESC_BATCH, steps=DESC_STEPS):
    """configs/train_desc.yaml as shipped (Adam 1e-4 on the backbone, the
    fused Line2Window preprocess with grid 16, window 0.1 and T = 60,
    EpipolarLoss_full), with the flagship model in f32, random weights
    from the seed, ``val_config`` and ``load_path`` removed and
    SyntheticPairs in place of MegaDepth; one epoch of ``steps`` steps,
    every step logged."""
    from posfeat_tpu_torch.core.config import load_config

    cfg = load_config("configs/train_desc.yaml")
    cfg.pop("val_config")
    cfg.pop("load_path", None)
    cfg.update(
        checkpoint_name="smoke_desc", model_config=copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
        compute_dtype="float32", seed=SEED, epoch=1, epoch_step=steps, log_freq=1, data="SyntheticPairs",
    )
    cfg["data_config_train"].update(num_pairs=64, height=height, width=width, batch_size=batch)
    pp = cfg["preprocess_train_config"]
    assert cfg["optimal_modules"] == ["backbone"] and cfg["optimizer"] == "Adam"
    assert pp.get("engine", "fused") == "fused" and pp["kps_generator_config"]["grid_size"] == DESC_GRID
    assert pp["window_size"] == 0.1 and pp["temperature_base"] == pp["temperature_max"] == 60
    return cfg


def _step_on_both(torch, cfg, root, batch_np=None, draws=None):
    """One stage-1 step of ``cfg`` on the card and on the CPU from the same
    weights (both drawn from the seed), batch and draws (made on the card
    unless given): (results per device, batch, draws, trainers)."""
    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.train import Trainer

    trs = {d: Trainer(copy.deepcopy(cfg), ckpt_root=f"{root}/{d}", device=d) for d in ("cuda", "cpu")}
    for k, v in trs["cpu"].model.state_dict().items():
        assert torch.equal(v, trs["cuda"].model.state_dict()[k].cpu()), k
    if batch_np is None:
        batch_np = collate([trs["cpu"].train_dataset[i] for i in range(CHECK_BATCH)])
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        ones = {"local_point": torch.ones((CHECK_BATCH, H_CHECK, W_CHECK, 1), device="cuda")}
        # map_init identity: the draws read only the score maps' shape
        draws = trs["cuda"].preprocess.draw(trs["cuda"].to_device(batch_np), {"preds1": ones, "preds2": ones}, gen)
    res = {}
    for d, tr in trs.items():
        dd = {"kps": tuple(x.to(d) for x in draws["kps"]), "jitter1": draws["jitter1"].to(d),
              "jitter2": draws["jitter2"].to(d)}
        t0 = time.perf_counter()
        total, comps, gn, finite = tr.train_step(tr.to_device(batch_np), 1, preprocess_draws=dd)
        if d == "cuda":
            torch.cuda.synchronize()
        assert finite, d
        res[d] = dict(total=float(total), percent_w=float(comps["percent_w"]), gn=float(gn["backbone"]),
                      s=time.perf_counter() - t0, draws=dd,
                      stats={k: v.cpu() for k, v in tr.model.backbone.state_dict().items() if "running" in k})
    return res, batch_np, draws, trs


def stage1_card_vs_cpu(torch, tmp):
    """One stage-1 step on the card against the same step on the CPU, 2
    pairs of 240x320 at the flagship width.

    Held: with unit weights (``use_std_as_weight: False``), the loss and
    the backbone's gradient norm; with the shipped std weights, percent_w
    and the running statistics. The shipped std-weighted loss is printed
    beside the count of its weights in f32's rounding regime, not held:
    each window or grid std is Σ sqrt(E[x²] − E[x]²), which in a peaked
    softmax cancels to rounding (the window's variance to ~1e-6, the grid's
    to its 1e-6 clamp), and such a query's inverse-std weight is up to
    hundreds of times the others', whichever rounding the device makes."""
    cfg = desc_config(H_CHECK, W_CHECK, CHECK_BATCH, 1)
    unit = copy.deepcopy(cfg)
    unit["EpipolarLoss_full_config"]["use_std_as_weight"] = False
    res_u, batch_np, draws, _ = _step_on_both(torch, unit, f"{tmp}/unit")
    res, _, _, trs = _step_on_both(torch, cfg, f"{tmp}/shipped", batch_np, draws)
    # tolerances: both f32, TF32 off; the convolutions sum in other orders
    # through 50 layers, so the maps differ by ~1e-5 relative. The loss and
    # the gradient norm at rtol 1e-3; percent_w is a share of the
    # 2 x 2 x 300 window costs under their threshold, held to 4 of them;
    # the running statistics, 0.9·init + 0.1·(batch stats) twice, at
    # rtol 1e-3 / atol 1e-5
    n_terms = 2 * CHECK_BATCH * (H_CHECK // DESC_GRID) * (W_CHECK // DESC_GRID)
    cu, cc = res_u["cuda"], res_u["cpu"]
    d_loss = abs(cu["total"] - cc["total"]) / abs(cc["total"])
    d_gn = abs(cu["gn"] - cc["gn"]) / cc["gn"]
    g, c = res["cuda"], res["cpu"]
    d_pw = max(abs(r["cuda"]["percent_w"] - r["cpu"]["percent_w"]) for r in (res, res_u))
    worst = max(((r["cuda"]["stats"][k] - v).abs() / (v.abs() * 1e-3 + 1e-5)).max().item()
                for r in (res, res_u) for k, v in r["cpu"]["stats"].items())

    # the shipped weights' inputs: the stds of a training-mode forward
    # (after the step) on the same batch and draws
    rounding = {}
    for d, tr in trs.items():
        b = tr.to_device(batch_np)
        with torch.no_grad():
            out = tr.model(b, train=True)
            out["epoch"] = 1
            pr = tr.preprocess(b, out, draws=res[d]["draws"])
        rounding[d] = (int(sum((pr[f"feat{i}w_std"] < 2e-3).sum() for i in (1, 2))),
                       int(sum((pr[f"feat{i}g_std"] < 2.1e-3).sum() for i in (1, 2))))
    print(f"[12] one stage-1 step, card vs CPU, same weights, batch and draws ({CHECK_BATCH} pairs of "
          f"{H_CHECK}x{W_CHECK}, flagship width), unit weights: loss {cu['total']:.7g} vs {cc['total']:.7g} "
          f"(rel {d_loss:.3g}), backbone grad norm {cu['gn']:.7g} vs {cc['gn']:.7g} (rel {d_gn:.3g}); "
          f"percent_w {g['percent_w']:.5f} vs {c['percent_w']:.5f}; running stats at {worst:.3g} of their "
          f"tolerance; step {cu['s']:.3f} s on the card, {cc['s']:.3f} s on the CPU")
    print(f"[12] shipped std weights (not held): loss {g['total']:.7g} vs {c['total']:.7g} (rel "
          f"{abs(g['total'] - c['total']) / abs(c['total']):.3g}), grad norm {g['gn']:.7g} vs {c['gn']:.7g}; "
          f"window stds below 2e-3 and grid stds at their clamp, of {n_terms}: card {rounding['cuda']}, "
          f"CPU {rounding['cpu']}")
    assert d_loss <= 1e-3 and d_gn <= 1e-3, (d_loss, d_gn)
    assert d_pw <= 4 / n_terms + 1e-7, d_pw
    assert worst <= 1.0, worst


def stage1_window_check(torch, tr, batch):
    """At the flagship shapes on the card: the fused engine's window
    expectation against the reference engine's
    get_expected_correspondence_within_window on the fused engine's own
    centres (direction 1 of the preprocess), with both engines' times."""
    from posfeat_tpu_torch.ops.coords import denormalize_coords
    from posfeat_tpu_torch.ops.epipolar import get_expected_correspondence_within_window
    from posfeat_tpu_torch.ops.grid_sample import l2_normalize, sample_feat_by_coord
    from posfeat_tpu_torch.ops.line_window import fused_line_window
    from posfeat_tpu_torch.ops.samplers import generate_kpts_regular_grid_random

    pp = tr.preprocess
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        out = tr.model(batch, train=False)
        draws = pp.draw(batch, out, gen)
        c1n, _, _, _ = generate_kpts_regular_grid_random(
            out["preds1"]["local_point"], out["preds2"]["local_point"], pp.grid_size, draws["kps"],
            pp.random_select)
        c1n = c1n.reshape(DESC_BATCH, -1, 2)
        coord1 = denormalize_coords(c1n, H, W)
        feat1 = sample_feat_by_coord(out["preds1"]["local_map"], c1n, True)
        T, ws = 60.0, pp.config["window_size"]
        xf2_n = T * l2_normalize(out["preds2"]["local_map"])

        def fused():
            return fused_line_window(xf2_n, feat1, coord1, batch["F1"], H, W, window_size=ws,
                                     jitter_u=draws["jitter1"])

        centres, _, valid, exp_f, std_f = fused()

        def reference():
            return get_expected_correspondence_within_window(feat1, xf2_n, centres, ws, with_std=True)

        exp_r, _, std_r, _ = reference()
        torch.cuda.synchronize()
        torch.testing.assert_close(exp_f, exp_r, rtol=1e-3, atol=1e-4)  # tests/test_line_window.py:30
        # the std: Σ sqrt(E[x²] − E[x]²), which cancels to ~1e-6 in f32, so up to 1e-3 per axis
        torch.testing.assert_close(std_f, std_r, rtol=1e-3, atol=2e-3)
        fused_ms, ref_ms = _time_ms(fused, n=5, warmup=1), _time_ms(reference, n=5, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused()
        fused_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        reference()
        ref_peak = torch.cuda.max_memory_allocated() - base
    n = centres.shape[1]
    print(f"[12] window stage at B={DESC_BATCH}, {n} queries, {H // 4}x{W // 4} maps, D=128, window "
          f"{int(ws * H // 4)}x{int(ws * W // 4)}: fused vs reference expectation max|d| "
          f"{(exp_f - exp_r).abs().max().item():.3g}, std max|d| {(std_f - std_r).abs().max().item():.3g} "
          f"on the fused engine's centres ({int(valid.sum())} of {valid.numel()} valid); fused line+window "
          f"{fused_ms:.3f} ms (peak +{fused_peak / 2**30:.2f} GiB), reference window alone {ref_ms:.3f} ms "
          f"(peak +{ref_peak / 2**30:.2f} GiB), one direction, no graph")


def phase_stage1(torch, smi):
    """Stage-1 descriptor training at the flagship width (phase 12)."""
    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        stage1_card_vs_cpu(torch, tmp)
        cfg = desc_config()
        tr = Trainer(cfg, ckpt_root=tmp, device="cuda")
        assert tr.device.type == "cuda" and tr.train_backbone
        head, backbone = tr.model.localheader, tr.model.backbone
        head0 = {k: v.clone() for k, v in head.state_dict().items()}
        bb0 = {k: v.clone() for k, v in backbone.state_dict().items()}
        stage1_window_check(torch, tr, tr.to_device(collate([tr.train_dataset[i] for i in range(DESC_BATCH)])))

        # the main path: Trainer.train, as the CLI runs it
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run = f"{tmp}/{cfg['checkpoint_name']}"
        steps = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
        metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
        assert len(steps) == len(metrics) == DESC_STEPS, (len(steps), len(metrics))
        assert all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm/backbone"]) for r in metrics)
        assert not [f for f in os.listdir(run) if f.startswith("error_step")]
        assert sorted(os.listdir(f"{run}/001")) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
        sd = backbone.state_dict()
        moved = sum(not torch.equal(v, bb0[k]) for k, v in sd.items() if "running" not in k)
        stats_moved = sum(not torch.equal(v, bb0[k]) for k, v in sd.items() if "running" in k)
        n_stats = sum("running" in k for k in sd)
        assert moved > 0, "the backbone's parameters did not move"
        assert stats_moved == n_stats, (stats_moved, n_stats)
        assert all(torch.equal(v, head0[k]) for k, v in head.state_dict().items()), "the head moved"
    timed = [s["step_time_s"] for s in steps[1:]]
    s_step = float(np.mean(timed))
    m = (H // DESC_GRID) * (W // DESC_GRID)
    print(f"[12] stage-1 training: {DESC_STEPS} Trainer steps at {H}x{W}, batch {DESC_BATCH} pairs, f32, "
          f"m = n = {m}: warm-up {steps[0]['step_time_s']:.4f} s, then {s_step:.4f} s/step over {len(timed)} "
          f"steps (min {min(timed):.4f}, max {max(timed):.4f}), {DESC_BATCH / s_step:.3f} pairs/s; wall "
          f"{wall:.3f} s with checkpoints; peak memory {peak / 2**30:.2f} GiB; loss "
          f"{metrics[0]['total_loss']:.5g} -> {metrics[-1]['total_loss']:.5g}, percent_w "
          f"{metrics[0]['percent_w']:.4f} -> {metrics[-1]['percent_w']:.4f}; {moved} backbone tensors and all "
          f"{n_stats} running statistics moved, head unchanged; {smi}")


def _stage_record(run):
    """(seconds in the steps, first and last metrics records) of a Trainer run."""
    steps = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
    metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    return sum(s["step_time_s"] for s in steps), len(steps), metrics[0], metrics[-1]


def phase_probe(torch, smi):
    """The bf16 ΔMMA probe on trained weights (phase 13)."""
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.ops.matchers import mnn_matcher

    probe = _load_tool("selection_stability_torch")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        # 1. train stage 1, then stage 2 (stage 1 runs no reduction kernel)
        rf.lse_pass.launches = rf.reward_pass.launches = rf._split_operands.launches = 0
        t0 = time.perf_counter()
        ckpt = probe.train_probe_ckpt(work, PROBE_STEPS1, PROBE_STEPS2, device="cuda")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {"K4+K5 lse_pass": rf.lse_pass.launches, "K6 reward_pass": rf.reward_pass.launches,
                    "split": rf._split_operands.launches}
        assert all(v > 0 for v in launches.values()), launches
        for stage, steps, keys in (("desc", PROBE_STEPS1, ("total_loss", "loss_w1")),
                                   ("kp", PROBE_STEPS2, ("total_loss", "reinforce"))):
            secs, n, first, last = _stage_record(f"{work}/ckpts/conv_{stage}")
            assert n == steps and all(np.isfinite(first[k]) and np.isfinite(last[k]) for k in keys)
            shown = ", ".join(f"{k} {first[k]:.6g} -> {last[k]:.6g}" for k in keys)
            print(f"[13] probe stage {1 if stage == 'desc' else 2} ({stage}): {n} steps at {probe.H}x{probe.W}, "
                  f"batch 4, {secs:.1f} s in the steps; steps {first['global_step']} -> {last['global_step']}: "
                  f"{shown}")
        print(f"[13] probe training: {t_train:.1f} s for both stages; stage 2's reduction launches {launches}")

        # 2.-4. per point: the fixture, the three arms, the checks
        t_fixture = t_arms = 0.0
        failed = []
        for h, w, n_seq, num_pts in PROBE_POINTS:
            point = f"{work}/p{h}x{w}"
            t0 = time.perf_counter()
            probe.make_eval_fixture(f"{point}/hpatches", n_seq=n_seq, h=h, w=w)
            t_fixture += time.perf_counter() - t0
            t0 = time.perf_counter()
            rec = probe.trained_probe(ckpt, point, num_pts=num_pts, n_seq=n_seq, h=h, w=w, device="cuda")
            # the f32 arm with random weights: what training on the card changed
            _, mma3_random, _ = probe.run_arm("random", None, point, f"{point}/hpatches", "float32", False,
                                              num_pts, "cuda")
            t_arms += time.perf_counter() - t0
            print(f"[13] probe at {h}x{w}, {n_seq} sequences x 6 images, {num_pts} points: {json.dumps(rec)}")
            print(f"[13]   {h}x{w}: MMA@3 f32, trained {rec['mma3_f32']:.6g}, random weights {mma3_random:.6g}")
            assert rec["launches_bf16"]["K1"] > 0 and rec["launches_bf16"]["K2"] > 0, rec
            assert not any(rec[f"launches_{a}"][k] for a in ("f32", "bf16_plain") for k in ("K1", "K2")), rec
            checks = {
                "|delta_mma3| (bf16 fused - f32)": (abs(rec["delta_mma3"]), "<=", MAX_DELTA_MMA3),
                "topk_overlap_mean (bf16 fused vs f32)": (rec["topk_overlap_mean"], ">=", MIN_TOPK_OVERLAP),
                "match_agreement_mean (bf16 fused vs f32)": (rec["match_agreement_mean"], ">=",
                                                             MIN_MATCH_AGREEMENT),
                "|delta_mma3_kernels| (bf16 fused - bf16 plain)": (abs(rec["delta_mma3_kernels"]), "<=",
                                                                   MAX_DELTA_MMA3),
            }
            for name, (value, op, limit) in checks.items():
                ok = value <= limit if op == "<=" else value >= limit
                print(f"[13]   {h}x{w}: {name} {value:.6g} {op} {limit}: {'ok' if ok else 'MISSED'}")
                if not ok:
                    failed.append(f"{h}x{w} {name} {value:.6g}")

    # 5. the matcher alone
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d1, d2 = (torch.nn.functional.normalize(torch.randn(NUM_PTS, 128, generator=gen, device="cuda"), dim=1)
              for _ in range(2))
    match_ms = _time_ms(lambda: mnn_matcher(d1, d2, device="cuda"), n=20, warmup=3)
    t_match = time.perf_counter() - t0
    print(f"[13] mnn_matcher at {NUM_PTS} x {NUM_PTS}, D = 128, on the card: {match_ms:.4f} ms per call "
          f"(f32 product, argmax both ways, indices to the host)")
    print(f"[13] probe seconds: training {t_train:.1f}, fixtures {t_fixture:.1f}, arms {t_arms:.1f} (four at "
          f"each point, random weights included), matcher {t_match:.2f}, phase "
          f"{time.perf_counter() - t_phase:.1f}; {smi}")
    assert not failed, f"the probe missed: {failed}"


def shipped_config(stage, fixture, dtype, load_path=None):
    """configs/train_desc.yaml (stage "desc") or configs/train_kp.yaml
    ("kp") as shipped, with only the data paths, the step counts
    (SHIPPED_STEPS, logged every SHIPPED_LOG_FREQ), ``compute_dtype`` and
    stage 2's ``load_path`` changed."""
    from posfeat_tpu_torch.core.config import load_config

    cfg = load_config(f"configs/train_{stage}.yaml")
    cfg.update(epoch=1, epoch_step=SHIPPED_STEPS, log_freq=SHIPPED_LOG_FREQ, compute_dtype=dtype)
    cfg["data_config_train"]["data_path"] = fixture
    if "data_config_val" in cfg["val_config"]:
        cfg["val_config"]["data_config_val"]["data_path"] = fixture
    if stage == "kp":
        cfg["load_path"] = load_path
    assert cfg["data"] == "MegaDepth_SIFT" and cfg["checkpoint_name"] == {"desc": "descriptor", "kp": "keypoint"}[stage]
    return cfg


def _loader_s_per_batch(dataset_cls, dcfg, seed, n_batches=3):
    """Seconds per batch of the PrefetchLoader alone on ``dcfg`` (its batch
    size and workers), over n_batches after the first."""
    from posfeat_tpu_torch.data.loader import PrefetchLoader

    ds = dataset_cls(dcfg, is_train=True, seed=seed)
    it = iter(PrefetchLoader(ds, batch_size=dcfg["batch_size"], num_workers=dcfg["workers"], seed=seed,
                             infinite=True))
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return (time.perf_counter() - t0) / n_batches
    finally:
        it.close()


def phase_shipped(torch, fh, smi):
    """Training as shipped (phase 14): the two CLI runs of the README,
    stage 1 then stage 2 from its checkpoint, on a MegaDepth-layout
    fixture, in f32 and then in bf16."""
    import yaml

    from posfeat_tpu_torch.data.megadepth import MegaDepth_SIFT
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.train.__main__ import main as train_cli

    fixture_tool = _load_tool("make_megadepth_fixture")
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        fixture = fixture_tool.write_megadepth_fixture(f"{tmp}/megadepth", SHIPPED_SCENES, SHIPPED_IMAGES, H, W)
        t_fixture = time.perf_counter() - t_phase
        dcfgs = {stage: shipped_config(stage, fixture, "float32")["data_config_train"] for stage in ("desc", "kp")}
        loader = {stage: _loader_s_per_batch(MegaDepth_SIFT, dcfg, SEED) for stage, dcfg in dcfgs.items()}
        print(f"[14] MegaDepth-layout fixture: {SHIPPED_SCENES} scenes x {SHIPPED_IMAGES} images at {H}x{W} in "
              f"{t_fixture:.2f} s; the loader alone ({dcfgs['desc']['workers']} threads, SIFT and jitter): stage 1 "
              f"{loader['desc']:.4f} s a batch of {dcfgs['desc']['batch_size']}, stage 2 {loader['kp']:.4f} s a "
              f"batch of {dcfgs['kp']['batch_size']}")
        _zero_counts(fh)
        logged = sorted({1, *range(SHIPPED_LOG_FREQ, SHIPPED_STEPS + 1, SHIPPED_LOG_FREQ)})
        for dtype in ("float32", "bfloat16"):
            work = f"{tmp}/{dtype}"
            os.makedirs(work)
            runs = {}
            for stage in ("desc", "kp"):
                cfg = shipped_config(stage, fixture, dtype, load_path=f"{work}/ckpts/descriptor/001")
                path = f"{work}/train_{stage}.yaml"
                with open(path, "w") as f:
                    yaml.safe_dump(cfg, f)
                rf.lse_pass.launches = rf.reward_pass.launches = rf._split_operands.launches = 0
                t0 = time.perf_counter()
                os.chdir(work)
                try:
                    train_cli(["--config", path])
                finally:
                    os.chdir(cwd)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = (rf._split_operands.launches, rf.lse_pass.launches, rf.reward_pass.launches)
                run = f"{work}/ckpts/{cfg['checkpoint_name']}"
                steps = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
                metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
                assert len(steps) == SHIPPED_STEPS and [m["global_step"] for m in metrics] == logged, metrics
                assert all(np.isfinite(m["total_loss"]) for m in metrics), metrics
                assert not [f for f in os.listdir(run) if f.startswith("error_step")]
                if stage == "desc":
                    assert launches == (0, 0, 0), launches
                else:  # one reduction a step: its split, the lse pass and the reward pass
                    assert launches == (SHIPPED_STEPS,) * 3, launches
                for si in range(2):
                    for folder in VIS_FOLDERS:
                        files = sorted(os.listdir(f"{run}/vis/sample{si}/{folder}"))
                        assert files == sorted(f"{g}.jpg" for g in logged), (run, si, folder, files)
                        assert all(os.path.getsize(f"{run}/vis/sample{si}/{folder}/{f}") > 0 for f in files)
                timed = [r["step_time_s"] for r in steps[1:]]
                runs[stage] = run
                print(f"[14] {dtype} {'stage 1' if stage == 'desc' else 'stage 2'} (configs/train_{stage}.yaml, "
                      f"batch {cfg['data_config_train']['batch_size']}): {SHIPPED_STEPS} steps, first "
                      f"{steps[0]['step_time_s']:.4f} s, then {np.mean(timed):.4f} s/step (min {min(timed):.4f}, "
                      f"max {max(timed):.4f}); wait for the loader {np.mean([r['data_wait_s'] for r in steps[1:]]):.4f} "
                      f"s/step; loss {metrics[0]['total_loss']:.6g} -> {metrics[-1]['total_loss']:.6g}; "
                      f"K4-K6 launches (split, lse, reward) {launches}; vis {len(logged)} x 6 folders x 2 samples; "
                      f"wall {wall:.2f} s")
            # stage 2 read stage 1's backbone, running statistics included, bit for bit
            bb1 = torch.load(f"{runs['desc']}/001/backbone.pth", weights_only=True)
            for epoch in ("000", "001"):
                bb2 = torch.load(f"{runs['kp']}/{epoch}/backbone.pth", weights_only=True)
                assert bb1.keys() == bb2.keys() and all(torch.equal(bb1[k], bb2[k]) for k in bb1), epoch
            dtypes = {v.dtype for m in ("backbone", "localheader")
                      for v in torch.load(f"{runs['kp']}/001/{m}.pth", weights_only=True).values()}
            assert dtypes <= {torch.float32, torch.int64}, dtypes
        counts = _read_counts(fh)
        assert not any(counts.values()), f"a fused-head kernel launched under autograd or in the dumps: {counts}"
    seconds = time.perf_counter() - t_phase
    print(f"[14] training as shipped: fixture, loader, 2 x (stage 1 + stage 2) in {seconds:.1f} s (budget "
          f"{SHIPPED_BUDGET_S:.0f}); stage 2 loaded stage 1's backbone bit for bit in both dtypes, checkpoints f32; "
          f"K1-K3, T1, T2 launches {counts}; {smi}")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import fused_head as fh

    resolve_device("cuda")  # f32 work on the card stays out of TF32
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    info = _build.build(force=True)
    print(f"[2] build: {info['seconds']:.2f} s -> {info['path'].name}")
    summary = _ptxas_summary(info["log"])
    lib = _build.load_kernels()
    k2 = {k: v for k, v in summary.items() if k.startswith("head_tail_kernel<")}
    for kname, props in summary.items():
        if kname in CONV_KERNELS:
            # the launch's dynamic shared memory at the flagship point (C = KP = 192)
            props["dynamic_smem"] = lib.posfeat_conv_smem_bytes(192, 192 if kname == "conv_phase_kernel" else 0)
        if kname not in k2 or kname == "head_tail_kernel<16,1>":  # the main path's instance
            print(f"[2]   {kname}: {props}")
    assert len(k2) == 24, sorted(k2)
    print(f"[2]   head_tail_kernel, all {len(k2)} instances: registers {min(v['regs'] for v in k2.values())}-"
          f"{max(v['regs'] for v in k2.values())}, stack {max(v['stack'] for v in k2.values())} B, "
          f"spills {sum(v['spill_stores'] + v['spill_loads'] for v in k2.values())} B")
    for kname in (*CONV_KERNELS, *k2, "lse_split_kernel", "lse_pass_kernel", "reward_pass_kernel"):
        props = summary[kname]
        assert props["spill_stores"] == props["spill_loads"] == 0, (kname, props)
        if kname not in CONV_KERNELS:
            assert props["stack"] == 0, (kname, props)
    # a warpgroup.wait that ptxas injects (C7517, before a read of registers
    # a wgmma defines) serializes the wgmmas of product_tiles, the loop both
    # reduction passes run; its column tiles' first wgmmas write their
    # accumulators without reading them, and the build has none
    for kname in ("lse_pass_kernel", "reward_pass_kernel"):
        injected = [x for x in info["log"].splitlines() if "C7517" in x and kname in x]
        print(f"[2]   {kname}: {len(injected)} warpgroup.wait injected by ptxas (C7517)")
        assert not injected, injected

    rng = np.random.default_rng(SEED)
    records = phase_kernels(torch, fh, rng)
    phase_head_vs_reference(torch, rng)
    phase_main_path(torch, fh, rng, records)
    reduction = phase_reduction(torch, rng)
    phase_training(torch, reduction)
    v1 = phase_v1_kernels(torch, fh, rng)
    phase_head_vs_reference(torch, rng, mode="v1", tag="[9]")
    phase_v1_path(torch, fh, rng, v1)
    phase_head_bench(torch, fh, v1)
    phase_stage1(torch, smi)
    phase_probe(torch, smi)
    phase_shipped(torch, fh, smi)
    records += v1 + reduction

    print(f"[total] chip_smoke.py: {time.perf_counter() - t_start:.1f} s, build included")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
