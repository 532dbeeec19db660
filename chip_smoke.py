#!/usr/bin/env python3
"""Smoke run of posfeat_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases, one line each (more for the build):
  1. device: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc of csrc/*.cu, one process a source, with each kernel's
     registers, shared memory and spills from -Xptxas -v (and the conv
     kernels' dynamic shared memory at Cin = 192; K2's 24 template
     instances for each z dtype, bf16 and f32, in one line each); the
     four bf16 and four f32 conv kernels, the f32 ones' two split
     kernels, all 48 K2 instances and the reduction kernels (the split,
     the lse and reward passes with f1 resident and streamed) must not
     spill, nor any but the bf16 conv kernels keep a stack frame, nor
     ptxas inject warpgroup.waits (C7517) into the lse or the reward pass
     or the f32 conv kernels, nor serialize the passes' wgmmas (C7514,
     C7518);
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
     outputs carry the good reward, against their plain versions (the
     operands' TF32 split bit for bit; the reward pass on the plain
     log-sum-exps over five draws, this stream's, the one that
     tools/compare_torch_trees.py's former phase order gave and seeds
     1-3: s0 within its error-model bound (``s0_bound``), the six other
     outputs at rtol 2e-4, flipped good/bad decisions at most 1e-3 of the
     good pairs, the worst |d s0| / bound printed; the reward pass on the
     lse pass's outputs, as the reduction runs it, all seven at rtol
     2e-4 against the plain run on the plain log-sum-exps), with
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
 15. slice F: (a) each sub-pixel refiner (avg3, quad, quad5, soft, soft5)
     in the flagship bf16 extraction, 32 images at 480x640, batch 16, 8192
     points: im/s, K1/K2 launched, the detector's ms per batch of 16 on
     the head's score map and its output against the CPU's on that map
     (slot by slot within 1e-5); (b) MMA@3 of each refiner in the fused
     bf16 arm on phase 13's trained weights and 480x640 fixture; (c)
     stage 2 (configs/train_kp.yaml, 480x640, batch 6, 3 steps) with
     ``loc_weight: 10`` and ``reward_at_refined: true`` in f32 and bf16:
     the dense loss, K4-K6 launched 0 times, finite loss and loc_pen, the
     head moved and the backbone not, s/step and peak memory; (d)
     ResUNetHR extraction in f32 and bf16 (its H/2 local map takes the
     head's reference dataflow, as the JAX head does; K1/K2 launched 0
     times); (e) the SIFT passthrough, the h5 writers (where h5py is
     installed) and the image dumps on a 2 x 2-image fixture at 240x320,
     the files checked. Budget: 90 s;
 16. slice G (tools/multihost_torch.py starts every rank and process, each
     with a timeout): (a) two ranks of stage 2 (configs/train_kp.yaml, f32,
     SyntheticPairs 480x640, global batch 6, 3 per rank) on the one card
     over gloo: one step held against the one-process step on the same
     global batch with the same draws (loss, head gradient, updated head;
     rtol 1e-3 / atol 2e-4), then 3 Trainer steps (s/step per rank beside
     phase 7's); K4-K6 launched on both ranks; only rank 0 wrote the run
     and its checkpoint carries the reference's names; (b) two ranks of
     stage 1 (configs/train_desc.yaml, global batch 8): step 1's BatchNorm
     running statistics and backbone against the one-process step; (c)
     two extraction processes (the flagship bf16 model, 480x640, 8192
     points, batch 16) sharing 128 images: disjoint, complete shard lists,
     each npz once, K1/K2 launched in both, the aggregate im/s beside
     phase 5's; (d) ``profile_trace_dir`` over two stage-2 steps: the
     trace names the lse and reward passes; (e) the native preprocessing
     library built with g++ against numpy (rtol 1e-5); (f) ``save_npz:
     False`` writes no npz, ``spatial_shard: auto`` on the one card runs
     unsharded, bit for bit the plain run. Budget: 150 s;
 17. slice H: (a) the f32 instances of K1, K3 (and T1, T2, which the
     conv body gives) and K2 against their plain f32 versions at phases 3
     and 8's shapes (z within 1e-5 x max|z|, moments within rtol 1e-5,
     u within 1e-4; the conv kernels run 3xTF32 on the split's hi and
     lo parts, and K1's split is held bit for bit to its plain version),
     with times beside the 3xTF32 bound, the plain version and cuDNN's f32
     trunk conv or an f32 linear(prelu);
     (b) the f32 fused head against the f32 reference dataflow at
     480x640 in v3 and v1 (rtol 2e-3 / atol 2e-4, the JAX test's);
     (c) the f32 extraction with ``head_dataflow: pallas`` in v3 and v1
     and, beside it, the shipped f32 config's reference dataflow, 64
     images each after a warm-up batch: im/s, peak memory, the f32
     instances launched (one split per conv launch) and the bf16 ones
     not; (d) the reduction at D = 256 and 200 (f1 streamed) with phase
     6's checks and times; (e)
     phase 7's stage 2 at ``fine_out_ch: 256`` (the head's inputs 320):
     the kernels step against the dense one, then a warm-up and 5 timed
     Trainer steps, the reduction launched once a step, the dense loss
     never. Budget: 120 s;
 18. slice K, ``spatial_shard`` over several devices: one seeded 2048x3072
     frame (6.3 Mpx, above the 4 Mpx default threshold) through the
     flagship model with the Aachen detector (configs/extract_aachen.yaml:
     20480 points, NMS radius 3, thr 0.5 abs), in f32 (the reference
     dataflow) and bf16 (the "phase" dataflow), unsharded and banded over
     2 and 4 bands on cuda:0 (and over distinct cards where the machine
     has them): ms per image by CUDA events after a warm-up, peak memory
     per device, no kernel launched on the banded path; against the
     unsharded run of the same dataflow valid_count within 1e-3, at most
     1e-3 of the slate without a partner at its pixel, matched scores
     rtol 1e-3 and descriptors atol 1e-4 in f32, scores within 2e-2 x
     mean|score| in bf16; the bf16 slates' top-k overlap with the
     unsharded fused head ("pallas"); then the Extractor's own sharded
     route (``spatial_shard: 2``, its visible devices seen as two; on one
     card the mesh lists cuda:0 twice) on that frame in bf16, its fused
     head swapped for "phase" there: its npz equal to the banded
     program's slate. Budget: 60 s;
 19. slice L (0 b): one seeded 3024x4032 frame (a 12 MP phone photo,
     above the 2^31 output elements of one resize that the reference
     head's x4 resize of its 192-channel trunk reaches near 11 Mpx),
     flagship model, Aachen detector, unsharded: f32 with the reference
     dataflow (the resize and conv2 in row blocks) and bf16 with the
     "phase" head, each against the frame over 4 bands on cuda:0 with
     phase 18's checks (the bf16 unmatched share held to the unsharded
     program's own under 1e-6 of input noise where that is larger: cuDNN
     picks other algorithms for the whole map than for a band); then the
     bf16 fused head (K1 and K2 on the 756x1008 trunk, launched once a
     forward) against the "phase" head with phase 4's limits. Budget:
     90 s;
 20. slice L (a): the training launcher (``python -m
     posfeat_tpu_torch.train`` without ``--device``) on
     configs/train_kp.yaml, flagship model, f32, SyntheticPairs 480x640,
     batch 6, 3 steps: two ranks on cuda:0 over gloo (and over every card
     on NCCL where there are several), each fed its rows of the
     launcher's one loader: the trained head against the one-process run
     (rtol 1e-3 / atol 2e-4), K4+K5 and K6 launched once a step on every
     rank, s/step per rank beside the one-process run's. Budget: 150 s;
 21. slice L (b): phase 18's frame over 2 bands on cuda:0 in bf16
     ("phase") against the unsharded run of the same configuration, with
     phase 18's limits, for ResUNetHR, generate_kpts_single_noavg, the
     grid detector (grid 8, stable) and generate_kpts_single at stride 2
     (its NaN slots counted apart): ms/image and peak memory of each;
     then Gumbel selection at 256x256, 512 points, on 2 bands against the
     unsharded detector with the same seeded noise, bit for bit. Budget:
     90 s;
 22. slice M, bf16 extraction as the JAX package ships it: (a) K1, K2
     and K3 on the ring-skip dataflow's operands (a zero halo) at phase 3
     and 8's shapes against their plain versions at their limits, timed,
     and the whole ring-skip head (v3 with im2col, v1) with kernels
     against plain versions, one conv and one K2 launch a call; (b) the
     flagship extraction (128 images, 480x640, 8192 points) with
     ``fast_mode: False``, the card's default (the lite gates) and ship
     (lite plus ``desc_tail: split3``), each timed twice in turns: im/s,
     peak memory, K1/K2 launches,
     the full-resolution convimg's calls (none under the ring-skip head)
     and the card's busy share over two profiled batches; (c) the lite and
     ship arms on phase 13's trained weights at both of its points against
     its f32 arm, held to its limits (a miss fails the script); (d) the
     flagship backbone at bf16, B = 16: split3's local map against up2's,
     and each tail variant's ms per batch beside the concat dataflow's.
     Budget: 90 s;
 23. slice N: (a) K1 and K2 through ``fused_head_tail(img_stats="xla")``
     and the default ("gram") at phase 3's shapes against their plain
     versions (z within one bf16 ulp, the score map within 2e-2 x
     mean|score|, one K1 and one K2 launch a call), gram against xla
     within 2e-2 x mean|score|, ms of K1 and of the head; (b) phase 18's
     frame in bf16 through the Extractor's programs (the 'phase' head)
     with the card's default gates (packed top-k, quad) unsharded and
     over 2 and 4 bands, and with ``sample_impl: pair`` over 2 bands: the
     banded detector and samplers on the unsharded maps bit for bit
     (valid_count equal; quad within 1e-4), each banded program's slate
     within phase 18's limits of its unsharded one (1e-3 unmatched, valid
     within 1e-3) with its Δvalid printed, ms/image and peak memory, the
     lite 2-band slate's valid equal to the exact gates' and its share
     that differs printed (no limit), and the lite 2-band Extractor's npz
     equal to its program's slate.
     Budget: 60 s;
Phases 5, 10, 13, 15-21 pin ``fast_mode: False`` (the fused head's
exact ring, the exact top-k, corner sampling), so that their numbers
compare across PRs; the bf16 backbone's concat-free skip iconvs are JAX's
bf16 extraction dataflow, not a gate, and run in them.
then the script's seconds, a ``kernels`` JSON line (K1, K2, K3, T1, T2, T3, the two
reduction kernels, and slice H's f32 K1, K3, K2 and D = 256 passes), nvidia-smi's line, and the final
``{"ok": true, "device": {...}}`` line. Any failed check raises and the
exit code is non-zero; without a CUDA card it exits 2 and prints no
result.
"""

import contextlib
import copy
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

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


def _graph_ms(fn, n=20):
    """Device ms a call of ``fn``: n calls captured in one CUDA graph and
    replayed after a warm-up, so that no host time lies between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _bound(ops, peak, nbytes):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


CONV_KERNELS = ("conv_phase_kernel", "conv_phase_img_full_kernel", "conv_phase_img_none_kernel",
                "conv_phase_img_phase_kernel")
# csrc/fused_head_f32.cu's 3xTF32 conv_phase_f32_kernel<MODE>, by the kernel each MODE is, and its split
F32_CONV_KERNELS = ("conv_phase_f32_kernel<K1>", "conv_phase_f32_kernel<K3>", "conv_phase_f32_kernel<T1>",
                    "conv_phase_f32_kernel<T2>")
F32_SPLIT_KERNELS = ("split_tiles_kernel", "split_b_kernel")
# csrc/moments.cu's instances, by mangled type: the lane plan's
# row_moments_kernel<type> and the slot plan's row_moments_slots_kernel<type, vec>
MOMENTS_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
MOMENTS_KERNELS = (*(f"row_moments_kernel<{t}>" for t in MOMENTS_TYPES.values()),
                   *(f"row_moments_slots_kernel<{t},{v}>" for t, vs in (("f32", (4, 1)), ("bf16", (8, 1)),
                                                                          ("f16", (8, 1))) for v in vs))
# the reduction passes' instances: f1 resident (D <= 128), f1 streamed (D > 128, warp specialised)
REDUCTION_KERNELS = ("lse_split_kernel", "lse_pass_kernel", "reward_pass_kernel", "lse_pass_streamed_kernel",
                     "reward_pass_streamed_kernel")


def _kernel_key(mangled):
    """A kernel's key in the ptxas summary: its name, with K2's template
    arguments as head_tail_kernel<LPR,OUT> (bf16 z) or
    head_tail_kernel<f32,LPR,OUT>, and the f32 conv's as F32_CONV_KERNELS
    names them."""
    m = re.search(r"head_tail_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", mangled)
    if m:
        return f"head_tail_kernel<{'f32,' if m.group(1) == 'f' else ''}{m.group(2)},{m.group(3)}>"
    m = re.search(r"conv_phase_f32_kernelILi(\d)E", mangled)
    if m:
        return F32_CONV_KERNELS[int(m.group(1))]
    m = re.search(r"row_moments_slots_kernelI(f|13__nv_bfloat16|6__half)Li(\d)E", mangled)
    if m:
        return f"row_moments_slots_kernel<{MOMENTS_TYPES[m.group(1)]},{m.group(2)}>"
    m = re.search(r"row_moments_kernelI(f|13__nv_bfloat16|6__half)E", mangled)
    if m:
        return f"row_moments_kernel<{MOMENTS_TYPES[m.group(1)]}>"
    return next(k for k in (*CONV_KERNELS, *F32_SPLIT_KERNELS, *REDUCTION_KERNELS, mangled) if k in mangled)


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


def _k2_times(torch, fh, z, mu, sc, a, w3, b3):
    """K2 (head_tail) on z [B, h, w, 16·Cout] bf16: (ms per launch, its
    plain version's ms, one PyTorch expression's ms, bytes, bound)."""
    bf = torch.bfloat16
    B, cout, out_ch = z.shape[0], mu.shape[1], w3.shape[1]
    ms = _time_ms(lambda: fh.head_tail(z, mu, sc, a, w3, b3))
    plain = _time_ms(lambda: fh.head_tail_plain(z, mu, sc, a, w3, b3), n=5)
    zb = z.view(B, -1, 16, cout)
    mu_b, sc_b, w3t = mu[:, None, None].to(bf), sc[:, None, None].to(bf), w3.t().to(bf).contiguous()
    lib = _time_ms(lambda: torch.nn.functional.linear(
        torch.nn.functional.prelu((zb - mu_b) * sc_b, a.to(bf)), w3t, b3.to(bf)))
    outs = fh.head_tail(z, mu, sc, a, w3, b3)
    nbytes = 2 * z.numel() + 4 * (mu.numel() + sc.numel() + 1 + w3.numel() + b3.numel()
                                  + sum(o.numel() for o in outs))
    return ms, plain, lib, nbytes, _bound(z.numel() * (3.0 + 2 * out_ch), PEAK_F32, nbytes)


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
    k2_ms, k2_plain, k2_lib, k2_bytes, k2_bound = _k2_times(torch, fh, z, mu, sc, a, w3, b3)

    M = B * h * w
    k1_bytes = 2 * (tp.numel() + kph.numel() + pat.numel() + wm.numel() + z.numel()) + 4 * (
        b2b.numel() + s.numel() + q.numel())
    k1_bound = _bound(2.0 * M * N * (9 * C + KP), PEAK_BF16, k1_bytes)
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
    # the row moments of the head's trunk norm at the main path's shape
    records.append(moments_record(torch, g(B, h, w, C).to(bf), "[3]"))
    for r in records:
        print(f"[3] {r['name']}: {r['ms']:.4f} ms per B={B} launch (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms)")
    print(f"[3] K1 conv_phase: {_rate(records[0], 2.0 * M * N * (9 * C + KP))}")
    print(f"[3] K2 head_tail: {k2_bytes / (k2_ms * 1e-3) * 1e-12:.3f} TB/s achieved "
          f"({k2_bytes * 1e-9:.4g} GB per launch), {k2_bound[0] / k2_ms:.1%} of the bound")
    return records


MOMENTS_RECORD = "row_moments"
# the kernel's per-row sums against the plain version's pairwise tree, the
# same f32 values added in two orders: within 1e-5 of the row-channel's
# sum of |x| (Σx) or of Σx² (an order's rounding grows as √n·2^-24 of it,
# n ≤ 12288 terms a row-channel at these shapes)
MOMENTS_RTOL = 1e-5


def moments_check(torch, x, bands=()):
    """The row-moments kernel on x [B, R, ..., C] against its plain
    version (``MOMENTS_RTOL``), the partials of the rows split evenly in
    each of ``bands`` counts bit for bit the whole map's; returns (max
    |kernel − plain|, ms, plain ms, ms of torch's per-row sum pair, bound
    ms)."""
    from posfeat_tpu_torch.ops import moments as mo

    s1, s2 = mo.row_moments(x)
    torch.cuda.synchronize()
    p1, p2 = mo.row_moments_plain(x)
    a1 = mo.row_moments_plain(x.abs())[0]
    err = max((s1 - p1).abs().max().item(), (s2 - p2).abs().max().item())
    assert ((s1 - p1).abs() <= MOMENTS_RTOL * a1 + 1e-6).all(), ((s1 - p1).abs() / a1).max().item()
    assert ((s2 - p2).abs() <= MOMENTS_RTOL * p2 + 1e-6).all(), ((s2 - p2).abs() / p2).max().item()
    del p1, p2, a1
    R = x.shape[1]
    for k in bands:
        cuts = [R * i // k for i in range(k)] + [R]
        parts = [mo.row_moments(x[:, a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        assert torch.equal(torch.cat([p[0] for p in parts], 1), s1), k
        assert torch.equal(torch.cat([p[1] for p in parts], 1), s2), k
    inner = tuple(range(2, x.ndim - 1))

    def sum_pair():
        xf = x.float()
        return xf.sum(dim=inner), (xf * xf).sum(dim=inner)

    ms = _time_ms(lambda: mo.row_moments(x), n=10, warmup=2)
    plain = _time_ms(lambda: mo.row_moments_plain(x), n=2, warmup=1)
    lib = _time_ms(sum_pair, n=10, warmup=2)
    nbytes = x.numel() * x.element_size() + 2 * s1.numel() * 4
    return err, ms, plain, lib, _bound(0.0, PEAK_F32, nbytes)[0]


def moments_record(torch, x, tag):
    """The row-moments kernel's record for the kernels line, at x (the
    main path's trunk norm); launches filled in by the main path."""
    err, ms, plain, lib, bound = moments_check(torch, x, bands=(2, 3))
    print(f"{tag} row moments on {tuple(x.shape)} {str(x.dtype)[6:]}: max |kernel - plain| {err:.3g} (limit "
          f"{MOMENTS_RTOL:g} of each row-channel's sum of |x| or x^2), partials of 2 and 3 row splits bit for bit "
          f"the whole map's")
    return {"name": MOMENTS_RECORD, "route": "cuda", "source": "posfeat_tpu_torch/csrc/moments.cu",
            "replaces": "posfeat_tpu/models/keypoint_det.py:38", "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}


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


def flagship_extractor(tmp, rng, output_root="smoke", head_mode=None, dtype="bfloat16", head_dataflow=None,
                       fast_mode=False, desc_tail=""):
    """An Extractor at the flagship model (batch 16, 8192 points; bf16 and
    the fused head unless ``dtype``, and ``head_dataflow`` where given, say
    otherwise; the fused head in its v3 dataflow unless ``head_mode`` says
    "v1"; ``fast_mode: False`` unless ``fast_mode``; ``desc_tail`` in the
    backbone's config), writing npz under ``tmp``, after one warm-up batch
    of seeded images (cuDNN autotuning, allocator). Set ``.dataset`` and
    call ``.extract()`` to drive the main path."""
    import torch
    from posfeat_tpu_torch.extract import Extractor

    cfg = {
        "output_root": output_root, "postfix": "npz", "load_path": None,
        "loss_distance": "cos", "output_desc": True, "output_img": False,
        "compute_dtype": dtype, "model": "PoSFeat", "fast_mode": fast_mode,
        "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
        "data": "HPatch_SIFT", "data_config_extract": {"batch_size": BATCH, "workers": 4},
        "use_sift": False, "detector": "generate_kpts_single",
        "detector_config": {"num_pts": NUM_PTS, "stable": True, "use_nms": True,
                            "nms_radius": 1, "thr": 0.9, "thr_mod": "abs"},
    }
    if head_mode is not None:
        cfg["head_mode"] = head_mode
    if head_dataflow is not None:
        cfg["head_dataflow"] = head_dataflow
    if desc_tail:
        cfg["model_config"]["backbone_config"]["desc_tail"] = desc_tail
    ex = Extractor(cfg, ckpt_root=tmp, dataset=_images(rng, BATCH, "warm"))
    fused = dtype == "bfloat16" if head_dataflow is None else head_dataflow == "pallas"
    assert (ex.config["model_config"]["localheader_config"].get("fused_upsample") == "pallas") is fused
    assert ex.model.localheader.fused_head_mode == (head_mode or "v3")
    ex.extract()
    torch.cuda.synchronize()
    return ex


def _zero_counts(fh):
    """Every fused-head kernel's launch count to 0, bf16 and f32 instances
    and the f32 instances' split, and the row-moments kernel's."""
    from posfeat_tpu_torch.ops.moments import row_moments

    row_moments.launches = 0
    fh.conv_phase.launches = fh.conv_phase.launches_f32 = fh.split_conv_operands.launches = 0
    fh.head_tail.launches = fh.head_tail.launches_f32 = 0
    fh.conv_phase_img.launches = dict.fromkeys(fh.IMG_LAYOUTS, 0)
    fh.conv_phase_img.launches_f32 = dict.fromkeys(fh.IMG_LAYOUTS, 0)


def _read_counts(fh, suffix=""):
    """The bf16 instances' launch counts, or with suffix " f32" the f32
    instances', by kernel record name."""
    f32 = bool(suffix)
    img = fh.conv_phase_img.launches_f32 if f32 else fh.conv_phase_img.launches
    counts = {"K1 conv_phase": fh.conv_phase.launches_f32 if f32 else fh.conv_phase.launches,
              "K2 head_tail": fh.head_tail.launches_f32 if f32 else fh.head_tail.launches,
              "K3 conv_phase_img": img["full"], "T1 conv_phase_img": img["none"], "T2 conv_phase_img": img["phase"]}
    return {k + suffix: v for k, v in counts.items()}


def drive_extraction(torch, fh, rng, n_images, head_mode=None, dtype="bfloat16", head_dataflow=None):
    """The flagship Extractor over ``n_images`` seeded images after a
    warm-up batch, every npz checked; returns (images, seconds, peak
    bytes, launches of the bf16 and the f32 instances, keypoints per
    image)."""
    data = _images(rng, n_images, "main")
    with tempfile.TemporaryDirectory() as tmp:
        ex = flagship_extractor(tmp, rng, head_mode=head_mode, dtype=dtype, head_dataflow=head_dataflow)
        ex.dataset = data
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fh)
        t0 = time.perf_counter()
        n, _ = ex.extract()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {**_read_counts(fh), **_read_counts(fh, " f32")}
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
    from posfeat_tpu_torch.ops.moments import row_moments

    n, dt, peak, launches, counts = drive_extraction(torch, fh, rng, N_IMAGES)
    launches[MOMENTS_RECORD] = row_moments.launches  # the head's trunk norm, counted from the same 0
    for r in records:
        r["launches"] = launches[r["name"]]
        assert r["launches"] > 0, f"{r['name']} was not launched on the main path"
    print(f"[5] main path: {n} images {H}x{W} bf16 in {n // BATCH} batches of {BATCH} after a warm-up batch, "
          f"{NUM_PTS} pts: {n / dt:.2f} im/s ({dt:.3f} s, one pipeline fill and drain included), "
          f"peak memory {peak / 2**30:.2f} GiB, keypoints/image min {min(counts)} max {max(counts)}, "
          f"launches {launches}")
    return n / dt


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
    kernel's launches read around it: the path of T1, T2 and T3 (K2
    timed alone, whose record it appends to ``records``)."""
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
    # T3: K2 timed alone on the bench's inputs, held against its plain version there
    inp = bench.make_inputs(torch)
    hd = inp["head"]
    args = (inp["z"], inp["mu"], inp["sc"], hd["prelu_a"], hd["w3"].reshape(bench.COUT, bench.OUT_CH), hd["b3"])
    u, ur = fh.head_tail(*args)[0], fh.head_tail_plain(*args)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
    _, plain, lib, _, bound = _k2_times(torch, fh, *args)
    records.append({
        "name": "T3 head_tail (head bench)", "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head.cu",
        "replaces": "tools/bench_fused_parts.py:289", "launches": launches["K2 head_tail"],
        "max_abs_err": (u - ur).abs().max().item(), "ms": res["K2"] * bench.B, "plain_ms": plain,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
    })
    del inp, u, ur


def _unit(torch, x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


# the reduction's keyword arguments on the training path (configs/train_kp.yaml: T = 60, reward_thr 2)
REDUCTION_KW = dict(temperature=60.0, thr=2.0, good_reward=1.0, bad_reward=-0.25)


def reduction_problem(torch, rng, D=128):
    """The reduction's inputs at the training path's shapes (B=6,
    m=n=4800, D=128 or as given) on the card: seeded unit descriptors with
    planted matches, half of them on each other's epipolar lines. Returns
    (f1, f2, line1, c2h, line2, c1h, accept1, accept2)."""
    from posfeat_tpu_torch.ops.coords import homogenize
    from posfeat_tpu_torch.ops.epipolar import epipolar_lines

    dev = torch.device("cuda")
    B, m = TRAIN_BATCH, (H // GRID) * (W // GRID)
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


# phase 6's error model of K6's s0 against its plain version on the same
# inputs (the plain log-sum-exps). Per pair, lp = 2 aff - row_lse - col_lse
# with aff = T dot - T; both sides round their dot, aff and lp, the kernel
# its exp2 and W, and both sum W lp in their own orders:
# - the dot: the kernel's 3xTF32 leaves S0_C_DOT_K units of S0_EPS = 2^-22
#   of sum|x y| (= 1 at most for unit rows): 3 from the split (each lo
#   rounded to TF32, lo.lo dropped), 5.5 from the tensor cores' truncating
#   adds inside an 8-deep step (11 adds at 2^-23), D / 32 from the D / 8
#   rounded f32 adds of the steps (2^-24 each; 4 at D = 128: 12.5 in all).
#   Beyond D = 128 (f1 streamed) a rounded add takes a 16-deep chunk, two
#   steps in one truncating chain: the first step's 11 adds are bounded by
#   its own sum|x y| and the second's by the chunk's, so 2 x 5.5 = 11 units
#   at most, and the D / 16 rounded adds give D / 64 (18 in all at D = 256);
#   the plain f32 product up to S0_C_DOT_P = D 2^-24 = D / 4 units (32 at
#   D = 128), its sequential worst case;
# - aff and lp: up to 2u (T + 3|aff| + |aff - row_lse| + |aff - col_lse| + |lp|),
#   u = 2^-24, on both sides;
# - p and W: ex2.approx's 2 ulp (2^-22), lp log2(e)'s rounding (u |lp|
#   relative in p) and W's three products (6u on both sides);
# - the sums: S0_K_SUM u sum|W lp| (the kernel's fmaf chains of 64 per tile,
#   its 38 column tiles, shuffles and 38 row tiles, and the plain reduction);
# - a pair within 8u sum|l c| of the reward threshold may flip between the
#   good and the bad reward: its whole |good - bad| p |lp| counts.
# So |d s0| <= sum |W| ((1 + |lp|) d_lp + |lp| e_p) + S0_K_SUM u sum|W lp| + flips,
# d_lp = 2 T (S0_C_DOT_K + S0_C_DOT_P) S0_EPS + 2u (...), e_p = 2^-22 + 6u + u |lp|.
S0_EPS, S0_U = 2.0 ** -22, 2.0 ** -24
S0_K_SUM = 512


def s0_dot_units(D):
    """(S0_C_DOT_K, S0_C_DOT_P) at descriptor width D: (12.5, 32) at 128,
    (18, 64) at 256 (a rounded add per 16-deep chunk beyond 128)."""
    if D <= 128:
        return 8.5 + D / 32, D / 4
    return 14 + D / 64, D / 4


def s0_bound_note(D=128):
    ck, cp = s0_dot_units(D)
    return (f"sum|W|((1+|lp|) d_lp + |lp| e_p) + {S0_K_SUM}u sum|W lp| + flips at thr, d_lp = 2T "
            f"({ck:g}+{cp:g}) 2^-22 + 2u(T + 3|aff| + |aff-rl| + |aff-cl| + |lp|)")


def s0_bound(torch, args, row_lse, col_lse, kw):
    """The error-model bound [B] on |s0(kernel) - s0(plain)| for the
    reward pass on the same inputs (see S0_EPS above), from the dense
    terms of the plain run, one batch element at a time."""
    f1, f2, line1, c2h, line2, c1h, a1, a2 = args
    T, thr, u = kw["temperature"], kw["thr"], S0_U
    c_dot = sum(s0_dot_units(f1.shape[-1]))
    out = []
    for b in range(f1.shape[0]):
        aff = T * (f1[b] @ f2[b].T) - T
        arl, acl = aff - row_lse[b, :, None], aff - col_lse[b, None, :]
        lp = arl + acl
        alp = lp.abs()
        p = torch.exp(lp)

        def dist(a, c):  # |a . c| and sum |a_k c_k|, [m, n]
            prods = a[:, None, :] * c[None, :, :]
            return prods.sum(-1).abs(), prods.abs().sum(-1)

        d1, m1 = dist(line1[b], c2h[b])
        d2, m2 = dist(c1h[b], line2[b])
        good = (d1 < thr) & (d2 < thr)
        near = ((d1 - thr).abs() <= 8 * u * m1) | ((d2 - thr).abs() <= 8 * u * m2)
        acc = a1[b, :, None] * a2[b, None, :]
        w = acc * torch.where(good, kw["good_reward"], kw["bad_reward"]) * p
        d_lp = 2 * T * c_dot * S0_EPS + 2 * u * (T + 3 * aff.abs() + arl.abs() + acl.abs() + alp)
        e_p = S0_EPS + 6 * u + u * alp
        flip = (near * acc * abs(kw["good_reward"] - kw["bad_reward"]) * p * alp).sum()
        out.append((w.abs() * ((1 + alp) * d_lp + alp * e_p)).sum() + S0_K_SUM * u * (w * lp).abs().sum() + flip)
    return torch.stack(out)


def reward_same_inputs(torch, rf, args, row_lse, col_lse, kw, tiles=None):
    """K6 against its plain version on the same inputs: rowW, colW, the
    p sums and max at rtol 2e-4 / atol 1e-5, the flipped decisions at
    most 1e-3 of the good pairs, s0 within its error-model bound (a draw
    over it is a kernel fault). Returns (kernel outputs, plain outputs,
    (max |d s0| / bound, min bound / |s0|), flips)."""
    out = rf.reward_pass(*args, row_lse, col_lse, **kw, tiles=tiles)
    torch.cuda.synchronize()
    ref = rf.reward_pass_plain(*args, row_lse, col_lse, **kw)
    for o, r in zip(out[1:7], ref[1:7]):
        torch.testing.assert_close(o, r, rtol=2e-4, atol=1e-5)
    flip = (out[7] - ref[7]).abs().sum().item()
    assert flip <= 1e-3 * ref[7].sum().item(), (flip, ref[7].sum().item())
    bound = s0_bound(torch, args, row_lse, col_lse, kw)
    ratio = ((out[0] - ref[0]).abs() / bound).max().item()
    assert ratio <= 1.0, f"K6's s0 is {ratio:.4g} x its error-model bound: a kernel fault"
    return out, ref, (ratio, (bound / ref[0].abs()).min().item()), flip


def former_order_stream():
    """The random stream that tools/compare_torch_trees.py's former phase
    order handed phase_reduction: numpy's Generator of SEED after the
    draws of phase_kernels and phase_v1_kernels (their shapes, in their
    order), replayed on the host in chunks; no card work."""
    rng = np.random.default_rng(SEED)
    B, h, w, C, cout, out_ch, KP = BATCH, H // 4, W // 4, 192, 128, 1, 192
    N = 16 * cout
    shapes = [
        # phase_kernels: K1, K2, then the whole fused head
        (B, h + 2, w + 2, C), (9, C, N), (B, h, w, KP), (B, KP, N), (B, N), (cout, out_ch), (out_ch,),
        (B, h, w, C), (B, 4 * h, 4 * w, 3), (3, 3, 3, 64), (64,), (3, 3, C, cout), (3, 3, 64, cout), (cout,),
        (1, 1, cout, out_ch), (out_ch,),
        # phase_v1_kernels: the trunk, kph, b2, K3's z_img, T2's z_img
        (B, h + 2, w + 2, C), (9, C, N), (N,), (B, H, W, cout), (B, h, w, N),
    ]
    for shape in shapes:
        n = int(np.prod(shape))
        while n:  # a chunked draw continues the stream as one draw would
            k = min(n, 1 << 24)
            rng.standard_normal(k, dtype=np.float32)
            n -= k
    return rng


def phase_reduction(torch, rng, extra_draws=()):
    """The lse and reward passes against their plain versions at the
    training path's shapes, plus times; returns their kernel records.
    ``extra_draws``: (name, numpy Generator) pairs of further problems on
    which the reward pass is held to its plain version."""
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
    assert torch.equal(tiles[0], rf._split_plain(f1, rf.f1_resident(D))) and torch.equal(
        tiles[1], rf._split_plain(f2, False))
    rl, cl = rf.lse_pass(f1, f2, T)
    torch.cuda.synchronize()
    rlp, clp = rf.lse_pass_plain(f1, f2, T)
    err_lse = max(close(rl, rlp), close(cl, clp))
    # the reward kernel against its plain version on the same inputs (the
    # plain log-sum-exps) over several draws: this one, the one that
    # tools/compare_torch_trees.py's former phase order gave, and three
    # more; s0 to its error-model bound, the other outputs at rtol 2e-4
    draws = [("main", args)] + [(name, reduction_problem(torch, g)) for name, g in extra_draws]
    s0_ratios, flips = [], []
    for name, a in draws:
        rl_d, cl_d = (rlp, clp) if a is args else rf.lse_pass_plain(a[0], a[1], T)
        out, ref_d, ratio, flip = reward_same_inputs(torch, rf, a, rl_d, cl_d, kw, tiles if a is args else None)
        s0_ratios.append((name, ratio))
        flips.append(flip)
        if a is args:
            ref, err_rw = ref_d, max((o - r).abs().max().item() for o, r in zip(out[:7], ref_d[:7]))
        del out, ref_d
    n_good = ref[7].sum().item()
    worst = max(s0_ratios, key=lambda x: x[1][0])
    print(f"[6] reward pass vs plain on the same inputs, {len(draws)} draws: |d s0| / bound (bound / |s0|) "
          + ", ".join(f"{n} {r[0]:.4g} ({r[1]:.4g})" for n, r in s0_ratios)
          + f"; worst {worst[1][0]:.4g} ({worst[0]}); flipped "
          + ", ".join(f"{f:g}" for f in flips) + f" (bound: {s0_bound_note()})")
    # then the kernel as the reduction runs it, on the lse kernel's outputs,
    # against the same plain run (its 3xTF32 dots' error partly cancels in
    # lp there): all seven outputs at rtol 2e-4
    out = rf.reward_pass(*args, rl, cl, **kw, tiles=tiles)
    torch.cuda.synchronize()
    err_fed = max(close(o, r) for o, r in zip(out[:7], ref[:7]))
    s0_fed = ((out[0] - ref[0]).abs() / ref[0].abs()).max().item()
    flips.append((out[7] - ref[7]).abs().sum().item())
    assert flips[-1] <= 1e-3 * n_good, (flips, n_good)
    del out
    # the planted good matches carry the good reward: a column whose
    # match is good and accepted has colW near good_reward * p
    assert ref[2].amax().item() > 0.5 * kw["good_reward"], ref[2].amax().item()
    whole = rf.reinforce_reduction(*args, **kw)
    torch.cuda.synchronize()
    whole_ref = rf.reinforce_reduction_plain(*args, **kw)
    err_whole = max(close(o, r) for o, r in zip(whole, whole_ref))
    print(f"[6] reduction at B={B} m={m} n={n} D={D} T={T:g} thr={kw['thr']:g}: lse max|err| {err_lse:.3g}, "
          f"reward outputs max|err| {err_rw:.3g} on the plain lse (s0 to its bound, above), {err_fed:.3g} on "
          f"the lse kernel's (s0 rel {s0_fed:.3g}), "
          f"whole reduction max|err| {err_whole:.3g}; good pairs "
          f"{int(n_good)} of {B * m * n}, flipped {flips[0]:g} / {flips[-1]:g}; max colW {ref[2].amax().item():.4g}, "
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


def train_config(fine_out_ch=128):
    """configs/train_kp.yaml as shipped, with the flagship model in f32
    (its descriptor ``fine_out_ch`` wide, the head's inputs with it),
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
    mc = cfg["model_config"]
    mc["localheader_config"]["in_channels"] += fine_out_ch - mc["backbone_config"]["fine_out_ch"]
    mc["backbone_config"]["fine_out_ch"] = fine_out_ch
    assert cfg["data_config_train"]["batch_size"] == TRAIN_BATCH
    assert cfg["DiskLoss_config"]["grid_size"] == GRID
    return cfg


def phase_training(torch, records, fine_out_ch=128, tag="[7]", suffix=""):
    """Stage-2 training at the flagship width (descriptors ``fine_out_ch``
    wide) through Trainer; the reduction's launches go to the records
    named with ``suffix``."""
    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.losses import DiskLoss
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.ops.moments import row_moments
    from posfeat_tpu_torch.train import Trainer

    cfg = train_config(fine_out_ch)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp, device="cuda")
        assert tr.device.type == "cuda"
        head, backbone = tr.model.localheader, tr.model.backbone
        head0 = {k: v.clone() for k, v in head.state_dict().items()}
        bb0 = {k: v.clone() for k, v in backbone.state_dict().items()}

        # one step's loss and head gradient: kernels against the dense DiskLoss
        batch = tr.to_device(collate([tr.train_dataset[i] for i in range(TRAIN_BATCH)]))
        name, weight, loss_k = tr.loss_fns[0]
        assert loss_k._use_streamed()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.no_grad():
            out = tr.model(batch)
            draws = tuple(loss_k.draw(out[p]["local_point"], gen) for p in ("preds1", "preds2"))
        assert out["preds1"]["local_map"].shape[-1] == fine_out_ch

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
        print(f"{tag} one step at D = {fine_out_ch}, kernels vs dense DiskLoss on the same draws: loss {l_k:.6g} vs {l_d:.6g}, "
              f"head grad |d|/|g| {g_rel:.3g}, max|d| {g_err:.3g} (max|grad| {g_max:.4g}); reinforce {c_k['reinforce']:.6g} vs {c_d['reinforce']:.6g}, "
              f"n_pairs {c_k['n_pairs']:.5g} vs {c_d['n_pairs']:.5g}")

        # the main path: Trainer.train, as the CLI runs it; the dense loss
        # (the only caller of the constant reward) never runs
        dense_calls = []

        def dense_reward(*a, **k):
            dense_calls.append(1)
            return DiskLoss.constant_reward(loss_k, *a, **k)

        loss_k.constant_reward = dense_reward
        row_moments.launches = 0
        rf.lse_pass.launches = 0
        rf.reward_pass.launches = 0
        rf._split_operands.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        norms = row_moments.launches
        launches = {"K4+K5 lse_pass" + suffix: rf.lse_pass.launches, "K6 reward_pass" + suffix: rf.reward_pass.launches}
        # one split of f1 and f2 per reduction, shared by its two passes, one reduction a step
        assert rf._split_operands.launches == rf.lse_pass.launches == rf.reward_pass.launches == TRAIN_STEPS, (
            rf._split_operands.launches, launches)
        assert not dense_calls, f"the dense loss ran {len(dense_calls)} times"
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
    print(f"{tag} training: {TRAIN_STEPS} Trainer steps at {H}x{W}, D = {fine_out_ch}, batch {TRAIN_BATCH} pairs, f32, "
          f"m = n = {(H // GRID) * (W // GRID)}: warm-up {steps[0]['step_time_s']:.4f} s, then "
          f"{s_step:.4f} s/step over {len(timed)} steps (min {min(timed):.4f}, max {max(timed):.4f}), "
          f"{TRAIN_BATCH / s_step:.3f} pairs/s; wall {wall:.3f} s with checkpoints; peak memory "
          f"{peak / 2**30:.2f} GiB; {moved} head tensors moved, backbone unchanged; loss "
          f"{metrics[0]['total_loss']:.5g} -> {metrics[-1]['total_loss']:.5g}; launches {launches}; row moments "
          f"{norms} launches ({norms / TRAIN_STEPS:g} a step)")
    return s_step


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


@contextlib.contextmanager
def _kept_on_success():
    """A temporary directory that is removed if its block raises and kept
    otherwise (its owner removes it)."""
    work = tempfile.mkdtemp()
    try:
        yield work
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def phase_probe(torch, smi):
    """The bf16 ΔMMA probe on trained weights (phase 13)."""
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.ops.matchers import mnn_matcher

    probe = _load_tool("selection_stability_torch")
    t_phase = time.perf_counter()
    mma3_fused, f32_arms = {}, {}
    with _kept_on_success() as work:
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
            mma3_fused[(h, w)] = rec["mma3_bf16"]
            f32_arms[(h, w)] = (point, num_pts, rec["mma3_f32"])
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
    if failed:
        shutil.rmtree(work, ignore_errors=True)
    assert not failed, f"the probe missed: {failed}"
    # phase 15 scores the refiners on the trained weights and the 480x640
    # fixture, phase 22 the fast-path gates at both points; main removes it
    return {"work": work, "ckpt": ckpt, "point": f"{work}/p{H}x{W}", "mma3_avg3": mma3_fused[(H, W)],
            "f32_arms": f32_arms}


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


# slice F (phase 15): images per refiner, training steps with the levers, HR images
N_REFINE_IMAGES, LEVER_STEPS, N_HR_IMAGES = 32, 3, 32
LEVERS = {"loc_weight": 10, "reward_at_refined": True}
SLICE_F_BUDGET_S = 90.0


def _check_npz(path, n_max, width=128, margin=0):
    """One npz feature file: f32 keypoints in the frame (or within
    ``margin`` px of it), unit descriptors."""
    f = np.load(path)
    kp, sc, de = f["keypoints"], f["scores"], f["descriptors"]
    assert kp.dtype == sc.dtype == de.dtype == np.float32, path
    assert kp.ndim == 2 and kp.shape[1] == 2 and 0 < kp.shape[0] <= n_max, (path, kp.shape)
    assert sc.shape == (kp.shape[0], 1) and de.shape == (kp.shape[0], width), path
    assert np.isfinite(kp).all() and np.isfinite(sc).all() and np.isfinite(de).all(), path
    assert ((kp >= -margin) & (kp <= [W - 1 + margin, H - 1 + margin])).all(), path
    assert np.abs(np.linalg.norm(de, axis=1) - 1).max() < 1e-3, path
    return kp, sc, de


def _slates_equal(got, ref, atol=1e-5):
    """The card's detector output against the CPU's on the same score map:
    valid counts equal, every slot's keypoint within atol (normalized) in
    the same order, scores within rtol 1e-6. Returns the max |d| of the
    keypoints."""
    import torch

    (kg, sg, vg), (kr, sr, vr) = ([t.cpu() for t in x] for x in (got, ref))
    assert torch.equal(vg, vr), (vg, vr)
    d = (kg - kr).abs().max().item()
    assert d <= atol, d
    assert ((sg - sr).abs() <= 1e-6 * sr.abs() + 1e-12).all()
    return d


def slice_f_refiners(torch, fh, ex, data):
    """(a) Each refiner in the flagship bf16 extraction through K1 + K2:
    im/s over the images, the detector's ms per batch of 16 (CUDA events)
    on the head's score map, its output against the CPU's on that map."""
    from functools import partial

    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.ops.detect import DETECTORS, REFINERS

    ims = torch.from_numpy(np.stack([d["im1_ori"] for d in data[:BATCH]])).cuda()
    mean, std = (torch.as_tensor(x, device="cuda") for x in (IMAGENET_MEAN, IMAGENET_STD))
    smap = ex.model.extract((ims.float() / 255.0 - mean) / std)["local_point"]
    assert smap.shape == (BATCH, H, W, 1) and smap.dtype == torch.float32, (smap.shape, smap.dtype)
    smap_cpu = smap.cpu()
    det_cfg = ex.config["detector_config"]
    rows = {}
    for refine in REFINERS:
        det = partial(DETECTORS["generate_kpts_single"], **{**det_cfg, "refine": refine})
        d = _slates_equal(det(smap), det(smap_cpu))
        det_ms = _time_ms(lambda: det(smap), n=10, warmup=2)
        det_cfg["refine"] = refine
        ex._programs.clear()
        ex.dataset = data
        _zero_counts(fh)
        t0 = time.perf_counter()
        n, _ = ex.extract()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _read_counts(fh)
        assert n == len(data) and launches["K1 conv_phase"] > 0 and launches["K2 head_tail"] > 0, launches
        for it in data:
            # soft5's window reaches 2 px from a candidate on the interior's edge: 1 px beyond the frame
            _check_npz(f"{ex.desc_root}/{it['name1']}.npz", NUM_PTS, margin=1 if refine == "soft5" else 0)
        rows[refine] = (n / dt, det_ms, d, launches["K1 conv_phase"], launches["K2 head_tail"])
    det_cfg["refine"] = "avg3"
    ex._programs.clear()
    print(f"[15] (a) refiners in the bf16 extraction at {H}x{W}, batch {BATCH}, {NUM_PTS} points, "
          f"{len(data)} images each: "
          + "; ".join(f"{r} {v[0]:.2f} im/s, detector {v[1]:.4f} ms/batch, card vs CPU max|d| {v[2]:.3g}, "
                      f"K1/K2 {v[3]}/{v[4]}" for r, v in rows.items()))


def slice_f_probe_mma(probe_state):
    """(b) MMA@3 of each refiner on phase 13's trained weights and its
    480x640 fixture, in the fused bf16 arm."""
    from posfeat_tpu_torch.ops.detect import REFINERS

    probe = _load_tool("selection_stability_torch")
    point, data_root = probe_state["point"], f"{probe_state['point']}/hpatches"
    mma3 = {"avg3": probe_state["mma3_avg3"]}
    for refine in REFINERS[1:]:
        _, mma3[refine], launches = probe.run_arm(f"bf16_{refine}", probe_state["ckpt"], point, data_root,
                                                  "bfloat16", "pallas", NUM_PTS, "cuda", refine=refine)
        assert launches["K1"] > 0 and launches["K2"] > 0, (refine, launches)
    print(f"[15] (b) MMA@3 per refiner, fused bf16 arm on phase 13's trained weights at {H}x{W}, "
          f"{NUM_PTS} points: " + ", ".join(f"{r} {v:.6g}" for r, v in mma3.items()))


def slice_f_levers(torch):
    """(c) Stage 2 with DiskLoss's levers (loc_weight 10, reward_at_refined)
    on configs/train_kp.yaml at 480x640, batch 6, in f32 and bf16: the
    dense loss (K4-K6 never launched), finite loss and loc_pen, the head
    moved and the backbone not."""
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.train import Trainer

    out = []
    for dtype in ("float32", "bfloat16"):
        cfg = train_config()
        cfg.update(checkpoint_name=f"levers_{dtype}", compute_dtype=dtype, epoch_step=LEVER_STEPS)
        cfg["DiskLoss_config"].update(LEVERS)
        with tempfile.TemporaryDirectory() as tmp:
            tr = Trainer(cfg, ckpt_root=tmp, device="cuda")
            loss_fn = tr.loss_fns[0][2]
            assert not loss_fn._use_streamed()
            head0 = {k: v.clone() for k, v in tr.model.localheader.state_dict().items()}
            bb0 = {k: v.clone() for k, v in tr.model.backbone.state_dict().items()}
            rf.lse_pass.launches = rf.reward_pass.launches = rf._split_operands.launches = 0
            torch.cuda.reset_peak_memory_stats()
            tr.train()
            torch.cuda.synchronize()
            launches = (rf._split_operands.launches, rf.lse_pass.launches, rf.reward_pass.launches)
            assert launches == (0, 0, 0), launches
            run = f"{tmp}/{cfg['checkpoint_name']}"
            steps = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
            metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
            assert len(steps) == len(metrics) == LEVER_STEPS, (len(steps), len(metrics))
            loc = [next(v for k, v in r.items() if k.endswith("loc_pen")) for r in metrics]
            assert all(np.isfinite(r["total_loss"]) for r in metrics) and all(np.isfinite(loc)), (metrics, loc)
            assert not [f for f in os.listdir(run) if f.startswith("error_step")]
            moved = sum(not torch.equal(v, head0[k]) for k, v in tr.model.localheader.state_dict().items())
            assert moved > 0, "the head did not move"
            assert all(torch.equal(v, bb0[k]) for k, v in tr.model.backbone.state_dict().items()), "backbone moved"
            s_step = float(np.mean([x["step_time_s"] for x in steps[1:]]))
            out.append(f"{dtype} {s_step:.4f} s/step (warm-up {steps[0]['step_time_s']:.4f}), peak "
                       f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {metrics[0]['total_loss']:.5g} "
                       f"-> {metrics[-1]['total_loss']:.5g}, loc_pen {loc[0]:.5g} -> {loc[-1]:.5g}, "
                       f"{moved} head tensors moved")
            del tr
    print(f"[15] (c) stage 2 with {LEVERS} at {H}x{W}, batch {TRAIN_BATCH}, {LEVER_STEPS} steps, dense loss "
          f"(K4-K6 launched 0 times): " + "; ".join(out))


def slice_f_hr(torch, fh, data):
    """(d) ResUNetHR extraction in f32 and bf16: its H/2 local map takes
    the head's reference dataflow, as the JAX head does; K1/K2 never."""
    from posfeat_tpu_torch.extract import Extractor

    out = []
    for dtype in ("float32", "bfloat16"):
        mc = copy.deepcopy(FLAGSHIP_MODEL_CONFIG)
        mc["backbone"] = "ResUNetHR"
        cfg = {
            "output_root": f"hr_{dtype}", "postfix": "npz", "load_path": None, "loss_distance": "cos",
            "output_desc": True, "output_img": False, "compute_dtype": dtype, "model": "PoSFeat",
            "fast_mode": False, "model_config": mc, "data": "HPatch_SIFT", "data_config_extract": {"batch_size": BATCH, "workers": 4},
            "use_sift": False, "detector": "generate_kpts_single",
            "detector_config": {"num_pts": NUM_PTS, "stable": True, "use_nms": True, "nms_radius": 1,
                                "thr": 0.9, "thr_mod": "abs"},
        }
        with tempfile.TemporaryDirectory() as tmp:
            ex = Extractor(cfg, ckpt_root=tmp, dataset=data[:BATCH])
            dataflow = ex.config["model_config"]["localheader_config"].get("fused_upsample", True)
            assert dataflow == (False if dtype == "bfloat16" else True), dataflow
            ex.extract()  # warm-up batch
            ex.dataset = data
            _zero_counts(fh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            n, _ = ex.extract()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _read_counts(fh)
            assert not any(launches.values()), launches
            for it in data:
                _check_npz(f"{ex.desc_root}/{it['name1']}.npz", NUM_PTS)
            out.append(f"{dtype} {n / dt:.2f} im/s, head dataflow {dataflow!r}, peak "
                       f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del ex
    print(f"[15] (d) ResUNetHR extraction at {H}x{W}, batch {BATCH}, {len(data)} images, local map at H/2, "
          f"K1/K2 launched 0 times: " + "; ".join(out))


def slice_f_writers(torch, rng):
    """(e) The SIFT passthrough, the h5 writers and the image dumps on a
    small HPatches-layout fixture (2 sequences x 2 images at 240x320), the
    files checked."""
    from posfeat_tpu_torch.data.utils import sift_keypoints
    from posfeat_tpu_torch.extract import Extractor

    probe = _load_tool("selection_stability_torch")
    try:
        import h5py
    except ImportError:
        h5py = None
        print("[15] (e) h5py is not installed on this machine: save_h5 is checked by "
              "tests/test_torch_extract_remainders.py on the CPU only")
    with tempfile.TemporaryDirectory() as tmp:
        names = []
        for seq in ("i_a", "v_b"):
            os.makedirs(f"{tmp}/hp/{seq}")
            for i in (1, 2):
                im = _images(rng, 1, "w")[0]["im1_ori"][:240, :320]
                probe.write_ppm(f"{tmp}/hp/{seq}/{i}.ppm", im)
                names.append((f"{seq}/{i}.ppm", im))
        base = {
            "postfix": "npz", "load_path": None, "loss_distance": "cos", "output_desc": True,
            "output_img": True, "save_h5": h5py is not None, "compute_dtype": "bfloat16", "model": "PoSFeat",
            "fast_mode": False, "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG), "data": "HPatch_SIFT",
            "data_config_extract": {"data_path": f"{tmp}/hp", "batch_size": 2, "workers": 2},
            "detector": "generate_kpts_single", "local_thr": 0.99,
            "detector_config": {"num_pts": 512, "stable": True, "use_nms": True, "nms_radius": 1, "thr": False,
                                "refine": "quad"},
        }
        counts = {}
        for tag, sift in (("sift", True), ("learned", False)):
            ex = Extractor({**base, "output_root": tag, "use_sift": sift}, ckpt_root=tmp)
            ex.extract()
            for name, im in names:
                kp, sc, _ = _check_npz(f"{ex.desc_root}/{name}.npz", 10 ** 6)
                if sift:
                    assert np.array_equal(kp, sift_keypoints(im)) and (sc == 1).all(), name
                stem = f"{ex.img_root}/{name.split('.')[0]}"
                assert os.path.isfile(f"{stem}_image_with_kp.jpg"), stem
                assert os.path.isfile(f"{stem}_score_map.jpg") == (not sift), stem
                counts.setdefault(tag, []).append(kp.shape[0])
                if h5py is not None:
                    seq, stem_name = name.split(".")[0].split("/")
                    for fname in ("keypoints", "descriptors", "scores", "scales"):
                        with h5py.File(f"{ex.desc_root}h5/{seq}/{fname}.h5", "r") as f:
                            assert f[stem_name].shape[0] == kp.shape[0], (fname, name)
                    with h5py.File(f"{ex.desc_root}h5/feat.h5", "r") as f:
                        assert list(f[name]["image_size"][()]) == [320, 240], name
                        assert f[name]["keypoints"].shape == kp.shape
            del ex
    print(f"[15] (e) writers at 240x320, bf16: SIFT passthrough keypoints {counts['sift']} (host SIFT, unit "
          f"scores), learned with refine quad {counts['learned']}; npz, image dumps"
          + (", h5 and feat.h5 checked" if h5py is not None else " checked (no h5py)"))


def phase_slice_f(torch, fh, rng, smi, probe_state):
    """Slice F (phase 15): the refiners in the bf16 extraction, their MMA@3
    on phase 13's trained weights, stage 2 with DiskLoss's levers,
    ResUNetHR extraction, the SIFT passthrough and the writers."""
    t_phase = time.perf_counter()
    data = _images(rng, max(N_REFINE_IMAGES, N_HR_IMAGES), "slice_f")
    with tempfile.TemporaryDirectory() as tmp:
        ex = flagship_extractor(tmp, rng, output_root="refine")
        slice_f_refiners(torch, fh, ex, data[:N_REFINE_IMAGES])
        del ex
    if probe_state is not None:
        slice_f_probe_mma(probe_state)
    slice_f_levers(torch)
    slice_f_hr(torch, fh, data[:N_HR_IMAGES])
    slice_f_writers(torch, rng)
    seconds = time.perf_counter() - t_phase
    print(f"[15] slice F: {seconds:.1f} s (budget {SLICE_F_BUDGET_S:g} s); {smi}")


# slice G (phase 16): ranks and processes on the one card, their timeout,
# the two-rank stage-2 steps after the step check, stage 1's global batch and
# steps, and the images the two extraction processes share
G_WORLD, G_TIMEOUT_S, G_KP_STEPS, G_DESC_BATCH, G_DESC_STEPS, G_IMAGES = 2, 300, 3, 8, 1, 128
SLICE_G_BUDGET_S = 150.0


def _close(got, want, what, rtol=1e-3, atol=2e-4):
    """The worst |got - want| and its share of the tolerance; fails beyond it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    share = float((err / (atol + rtol * np.abs(want))).max()) if err.size else 0.0
    assert share <= 1.0, f"{what}: max |d| {err.max():.3g} is {share:.3g} of rtol {rtol} / atol {atol}"
    return float(err.max()) if err.size else 0.0, share


def _launched(spec, outs, rcs):
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0 and f"RANK_OK {r}" in out, f"rank {r} of {spec['jobs'][0]['name']} failed ({rc}):\n{out[-6000:]}"


def _rank_record(out_dir, name, r):
    with open(f"{out_dir}/{name}.rank{r}.json") as f:
        return json.load(f)


def slice_g_training(torch, tmp, mh, s_step_main):
    """(a) and (b): two ranks of stage 2, then of stage 1, on the one card."""
    from posfeat_tpu_torch.models.keypoint_det import KeypointDet
    from posfeat_tpu_torch.train import Trainer

    kp, desc = train_config(), desc_config(batch=G_DESC_BATCH, steps=G_DESC_STEPS)
    out = f"{tmp}/ranks"
    spec = {"world": G_WORLD, "device": "cuda", "backend": "gloo", "timeout_s": 120, "out": out,
            "jobs": [{"kind": "step", "name": "kp", "config": kp, "train_steps": G_KP_STEPS},
                     {"kind": "step", "name": "desc", "config": desc, "train_steps": G_DESC_STEPS}]}
    gc.collect()  # tensors of earlier phases held only by reference cycles
    torch.cuda.empty_cache()  # the ranks share the card with this process
    rcs, outs, wall = mh.launch(spec, G_TIMEOUT_S)
    _launched(spec, outs, rcs)
    res = {n: [dict(np.load(f"{out}/{n}.rank{r}.npz")) for r in range(G_WORLD)] for n in ("kp", "desc")}
    recs = {n: [_rank_record(out, n, r) for r in range(G_WORLD)] for n in ("kp", "desc")}
    for r in range(G_WORLD):
        lk = recs["kp"][r]["launches"]
        assert lk["K4+K5 lse_pass"] > 0 and lk["K6 reward_pass"] > 0, (r, lk)
        assert recs["desc"][r]["launches"]["K6 reward_pass"] == 0, recs["desc"][r]
    print(f"[16] (a,b) two ranks over gloo on the one card: {wall:.1f} s for both runs; K4-K6 launches per rank "
          f"(stage 2, 1 + {G_KP_STEPS} steps): {[recs['kp'][r]['launches'] for r in range(G_WORLD)]}")

    def reference(cfg, name):
        """The one-process step on the ranks' batches in rank order, with its own draws."""
        cfg = {**cfg, "checkpoint_name": f"{cfg['checkpoint_name']}_one"}
        tr = Trainer(cfg, ckpt_root=tmp, device="cuda")
        batch = {k[6:]: np.concatenate([res[name][r][k] for r in range(G_WORLD)])
                 for k in res[name][0] if k.startswith("batch/")}
        total, comps, gn, finite = tr.train_step(tr.to_device(batch), 1)
        assert finite
        return tr, float(total)

    tr, loss = reference(kp, "kp")
    head = tr.model.localheader
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    per_param = {}
    for r in range(G_WORLD):
        got = res["kp"][r]
        worst["loss"] = max(worst["loss"], _close(got["loss"], loss, "stage-2 loss")[1])
        for n, p in head.named_parameters():
            g = p.grad.cpu().numpy()
            d = float(np.abs(got[f"grad/localheader/{n}"] - g).max())
            per_param[n] = (f"{d:.3g}", f"{float(np.abs(g).max()):.3g}")
        for n, p in head.named_parameters():
            worst["grad"] = max(worst["grad"], _close(got[f"grad/localheader/{n}"], p.grad.cpu(), f"grad {n} "
                                                      f"(max |d|, max |g| per tensor: {per_param})")[1])
        for k, v in head.state_dict().items():
            worst["param"] = max(worst["param"], _close(got[f"state/localheader/{k}"], v.cpu(), f"param {k}")[1])
    del tr
    run = f"{out}/ckpts/{kp['checkpoint_name']}"
    names = set(os.listdir(run))
    assert {"000", "001", "config.yaml", "metrics.jsonl", "logging_file.proc1.txt"} <= names, names
    assert sorted(os.listdir(f"{run}/001")) == ["backbone.pth", "localheader.pth", "opt_state.pth"]
    metrics = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    assert [m["global_step"] for m in metrics] == list(range(1, G_KP_STEPS + 1)), metrics
    saved = torch.load(f"{run}/001/localheader.pth", weights_only=True)
    ref_names = set(KeypointDet(**FLAGSHIP_MODEL_CONFIG["localheader_config"]).state_dict())
    assert set(saved) == ref_names, sorted(set(saved) ^ ref_names)  # import_keypoint_det's names
    times = [json.loads(x) for x in open(f"{run}/step_times.jsonl")]
    per_rank = {r: [t["step_time_s"] for t in times if t["rank"] == r][1:] for r in range(G_WORLD)}
    print(f"[16] (a) stage 2, global batch {TRAIN_BATCH} ({TRAIN_BATCH // G_WORLD} per rank): step 1 against the "
          f"one-process step on the same batch and draws, worst share of rtol 1e-3 / atol 2e-4: loss "
          f"{worst['loss']:.3g}, head grad {worst['grad']:.3g} (max |d|, max |g| per tensor: {per_param}), "
          f"updated head {worst['param']:.3g}; s/step per rank "
          + ", ".join(f"{np.mean(v):.4f}" for v in per_rank.values())
          + f" (after a warm-up step) beside phase 7's one-process {s_step_main:.4f}; rank 0 alone wrote "
          f"{sorted(n for n in names if not n.startswith('events'))}")

    # the shipped loss (std weights, the line search's argmax at T = 60) moves
    # where rounding flips a near-tie, as phase 12 found: its loss and
    # gradient are printed, not held; the forward's BatchNorm statistics and
    # the update are held
    tr, loss = reference(desc, "desc")
    worst = {"stats": 0.0, "param": 0.0}
    g_one = torch.cat([p.grad.flatten().cpu() for p in tr.model.backbone.parameters()]).double()
    losses, g_rel = [], []
    for r in range(G_WORLD):
        got = res["desc"][r]
        losses.append(float(got["loss"]))
        g_mh = torch.cat([torch.from_numpy(got[f"grad/backbone/{n}"]).flatten()
                          for n, _ in tr.model.backbone.named_parameters()]).double()
        g_rel.append(float((g_mh - g_one).norm() / g_one.norm()))
        for k, v in tr.model.backbone.state_dict().items():
            if "num_batches" in k:
                assert int(got[f"state/backbone/{k}"]) == int(v), k
                continue
            key = "stats" if "running" in k else "param"
            worst[key] = max(worst[key], _close(got[f"state/backbone/{k}"], v.cpu(), f"backbone {k}")[1])
    del tr
    print(f"[16] (b) stage 1, global batch {G_DESC_BATCH} ({G_DESC_BATCH // G_WORLD} per rank), synchronised "
          f"BatchNorm: step 1 against the one-process step, worst share of rtol 1e-3 / atol 2e-4: running "
          f"statistics {worst['stats']:.3g}, backbone after Adam's first step {worst['param']:.3g} (an entry whose "
          f"gradient changes sign moves by up to 2 lr = atol); not held: loss {losses} vs {loss:.6g}, backbone "
          f"gradient |d|/|g| per rank {[f'{x:.3g}' for x in g_rel]}; "
          f"the ranks' stage-1 runs took {[round(recs['desc'][r]['seconds'], 2) for r in range(G_WORLD)]} s")


def _write_ppm(path, im):
    with open(path, "wb") as f:
        f.write(f"P6\n{im.shape[1]} {im.shape[0]}\n255\n".encode() + np.ascontiguousarray(im).tobytes())


def slice_g_extraction(torch, tmp, mh, rng, ims_main):
    """(c) two extraction processes sharing 128 images."""
    data = _images(rng, G_IMAGES, "g")
    names = []
    for i, it in enumerate(data):
        seq = f"{tmp}/hp/s{i // 8:02d}"
        os.makedirs(seq, exist_ok=True)
        _write_ppm(f"{seq}/{i % 8}.ppm", it["im1_ori"])
        names.append(f"s{i // 8:02d}/{i % 8}.ppm")
    cfg = {
        "output_root": "g_shards", "postfix": "npz", "load_path": None, "loss_distance": "cos",
        "output_desc": True, "output_img": False, "compute_dtype": "bfloat16", "model": "PoSFeat", "fast_mode": False,
        "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG), "data": "HPatch_SIFT",
        "data_config_extract": {"data_path": f"{tmp}/hp", "batch_size": BATCH, "workers": 4},
        "use_sift": False, "detector": "generate_kpts_single",
        "detector_config": {"num_pts": NUM_PTS, "stable": True, "use_nms": True, "nms_radius": 1,
                            "thr": 0.9, "thr_mod": "abs"},
    }
    out = f"{tmp}/shards"
    spec = {"world": G_WORLD, "device": "cuda", "out": out,
            "jobs": [{"kind": "extract", "name": "ex", "config": cfg, "warmup": BATCH}]}
    torch.cuda.empty_cache()
    rcs, outs, wall = mh.launch(spec, G_TIMEOUT_S)
    _launched(spec, outs, rcs)
    recs = [_rank_record(out, "ex", r) for r in range(G_WORLD)]
    root = f"{out}/ckpts/g_shards"
    lists = []
    for r in range(G_WORLD):
        with open(f"{root}/image/name_list.shard{r}.txt") as f:
            lists.append([line.split(" ", 1)[1].strip() for line in f if line.strip()])
        assert lists[r] == sorted(names)[r::G_WORLD], r
        lk = recs[r]["launches"]
        assert recs[r]["images"] == G_IMAGES // G_WORLD and lk["K1 conv_phase"] > 0 and lk["K2 head_tail"] > 0, recs[r]
    assert sorted(lists[0] + lists[1]) == sorted(names)
    written = sorted(os.path.relpath(os.path.join(d, f), f"{root}/desc") for d, _, fs in os.walk(f"{root}/desc")
                     for f in fs)
    assert written == sorted(n + ".npz" for n in names), written[:4]
    window = max(r["t_end"] for r in recs) - min(r["t_extract"] for r in recs)
    print(f"[16] (c) two extraction processes, {G_IMAGES} images {H}x{W} bf16 ({G_IMAGES // G_WORLD} each, after a "
          f"warm-up batch of {BATCH} of them and a barrier), disjoint complete shard lists, each npz once; K1/K2 "
          f"launches per process in the timed run "
          f"{[(r['launches']['K1 conv_phase'], r['launches']['K2 head_tail']) for r in recs]}; aggregate "
          f"{G_IMAGES / window:.2f} im/s over the timed runs ({window:.3f} s from the first start to the last end; "
          f"each {[round(r['t_end'] - r['t_extract'], 3) for r in recs]} s) beside phase 5's one process "
          f"{ims_main:.2f} im/s (also warm); {G_IMAGES / wall:.2f} im/s over the whole wall ({wall:.2f} s: process "
          f"starts, model builds and warm-ups included)")


def slice_g_trace(torch, tmp):
    """(d) profile_trace_dir over two stage-2 steps."""
    from posfeat_tpu_torch.train import Trainer

    cfg = {**train_config(), "checkpoint_name": "g_trace", "epoch_step": 2, "profile_trace_dir": f"{tmp}/trace"}
    Trainer(cfg, ckpt_root=tmp, device="cuda").train()
    files = [f for f in os.listdir(f"{tmp}/trace") if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(f"{tmp}/trace/{files[0]}") as f:
        text = f.read()
    assert '"cat": "kernel"' in text, "the trace holds no CUDA kernel activity (CUPTI gave none)"
    found = {k: text.count(f"{k}") for k in ("lse_pass_kernel", "reward_pass_kernel")}
    assert all(found.values()), found
    print(f"[16] (d) profile_trace_dir: {files[0]} ({len(text) / 2**20:.1f} MiB) over 2 stage-2 steps names "
          f"{found} (occurrences)")


def slice_g_native_and_repairs(torch, tmp, rng):
    """(e) the native library; (f) save_npz False and spatial_shard auto."""
    from posfeat_tpu_torch.data import native
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.extract import Extractor

    assert native.native_available(), "the native preprocessing library did not build"
    im = _images(rng, 1, "n")[0]["im1_ori"][:H - 5, :W - 7]
    got = native.normalize_crop16(im)
    want = (im[:H - 16, :W - 16].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    err = _close(got, want, "native normalize", rtol=1e-5, atol=1e-6)
    print(f"[16] (e) native preprocessing: {native.library_path().name} built with g++, normalize_crop16 of a "
          f"{im.shape[0]}x{im.shape[1]} image against numpy: max |d| {err[0]:.3g} ({err[1]:.3g} of rtol 1e-5 / atol 1e-6)")

    data = _images(rng, BATCH, "f")
    base = {
        "postfix": "npz", "load_path": None, "loss_distance": "cos", "output_desc": True, "output_img": False,
        "compute_dtype": "bfloat16", "model": "PoSFeat", "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
        "fast_mode": False, "data": "HPatch_SIFT", "data_config_extract": {"batch_size": BATCH, "workers": 4},
        "use_sift": False,
        "detector": "generate_kpts_single",
        "detector_config": {"num_pts": NUM_PTS, "stable": True, "use_nms": True, "nms_radius": 1, "thr": 0.9,
                            "thr_mod": "abs"},
    }
    roots = {}
    for tag, extra in (("plain", {}), ("auto", {"spatial_shard": "auto"}), ("nonpz", {"save_npz": False})):
        ex = Extractor({**copy.deepcopy(base), "output_root": f"g_{tag}", **extra}, ckpt_root=tmp, device="cuda",
                       dataset=data)
        assert ex.extract()[0] == BATCH
        roots[tag] = ex.desc_root
    assert not [f for _, _, fs in os.walk(roots["nonpz"]) for f in fs], "save_npz: False wrote files"
    for it in data:
        a, b = (np.load(f"{roots[t]}/{it['name1']}.npz") for t in ("plain", "auto"))
        for k in ("keypoints", "scores", "descriptors"):
            assert np.array_equal(a[k], b[k]), (it["name1"], k)
    print(f"[16] (f) save_npz: False wrote no npz; spatial_shard: auto on {torch.cuda.device_count()} card ran "
          f"unsharded, its {BATCH} npz bit for bit the plain run's")


def phase_slice_g(torch, rng, smi, ims_main, s_step_main):
    """Slice G (phase 16): ranks, shards, the trace, the native library and the repairs."""
    t_phase = time.perf_counter()
    mh = _load_tool("multihost_torch")
    with tempfile.TemporaryDirectory() as tmp:
        slice_g_training(torch, tmp, mh, s_step_main)
        slice_g_extraction(torch, tmp, mh, rng, ims_main)
        slice_g_trace(torch, tmp)
        slice_g_native_and_repairs(torch, tmp, rng)
    seconds = time.perf_counter() - t_phase
    print(f"[16] slice G: {seconds:.1f} s (budget {SLICE_G_BUDGET_S:g} s); {smi}")


SLICE_H_BUDGET_S = 120.0
# the f32 conv and K2 instances against their plain f32 versions (f32
# FMAs in another order, z not rounded): z within 1e-5 x max|z|, the
# moments within rtol 1e-5 of the sums of |z| and z^2
F32_Z_TOL, F32_MOMENT_RTOL = 1e-5, 1e-5
# the head's tolerance in the JAX fused-head tests (test_pallas_fused_head.py:80-97)
HEAD_RTOL, HEAD_ATOL = 2e-3, 2e-4


def _f32_conv_check(torch, z, s, q, zr, sr, qr):
    """An f32 conv kernel's outputs against its plain version's; returns
    max |dz|."""
    err = (z - zr).abs().max().item()
    assert z.dtype == torch.float32 and err <= F32_Z_TOL * zr.abs().max().item(), (err, zr.abs().max().item())
    zabs = zr.abs().sum((1, 2))  # [B, N]: the scale of the column sums
    torch.testing.assert_close(s.sum(1), sr.sum(1), rtol=F32_MOMENT_RTOL, atol=F32_MOMENT_RTOL * zabs.max().item())
    torch.testing.assert_close(q.sum(1), qr.sum(1), rtol=F32_MOMENT_RTOL, atol=0)
    return err


def slice_h_kernels(torch, fh, rng):
    """(a) The f32 conv kernels (K1, K3, and the T1/T2 instances the body
    gives) and K2's f32 instance against their plain f32 versions at
    phases 3 and 8's shapes, with times; returns the records of K1, K3 and
    K2 at f32."""
    dev, f32 = torch.device("cuda"), torch.float32
    B, h, w, C, cout, out_ch, KP = BATCH, H // 4, W // 4, 192, 128, 1, 192
    N, kk = 16 * cout, 16

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    tp, kph = g(B, h + 2, w + 2, C), g(9, C, N, scale=0.03)
    kph4 = kph.reshape(3, 3, C, N).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    tp_nchw = tp.permute(0, 3, 1, 2)  # channels_last view
    # cuDNN's f32 conv of the trunk half, allow_tf32 off (resolve_device)
    assert not torch.backends.cudnn.allow_tf32
    lib_conv = _time_ms(lambda: torch.nn.functional.conv2d(tp_nchw, kph4), n=10)
    trunk_ops = 2.0 * B * h * w * N * 9 * C
    records, lines = [], []

    def conv_record(name, replaces, ops, nbytes, err, ms, plain, lib):
        bound = _bound(3 * ops, PEAK_TF32, nbytes)  # the kernel's 3xTF32 products on the tensor cores
        ffma_ms = ops / PEAK_F32 * 1e3
        lines.append(f"[17] (a) {name}: z max|err| {err:.4g}; {ms:.4f} ms per B={B} launch (bound {bound[0]:.4f} ms "
                     f"by {bound[1]}: 3xTF32; as f32 FMAs {ffma_ms:.4f} ms), plain {plain:.4f} ms, cuDNN f32 trunk "
                     f"conv {lib:.4f} ms; {ops / (ms * 1e-3) * 1e-12:.2f} TFLOP/s achieved "
                     f"({ops * 1e-12:.4g} TFLOP per launch), {bound[0] / ms:.1%} of the bound, "
                     f"{ffma_ms / ms:.1%} of the f32 FMA peak's time")
        return {"name": name, "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head_f32.cu",
                "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}

    # the split of K1's operands into TF32 hi and lo, bit for bit its plain version's
    pat, wm, b2b = g(B, h, w, KP), g(B, KP, N, scale=0.03), g(B, N, scale=0.1)
    split = fh.split_conv_operands(tp, kph, pat, wm)
    torch.cuda.synchronize()
    for got, want in zip(split, fh.split_conv_operands_plain(tp, kph, pat, wm), strict=True):
        assert torch.equal(got, want)
    del split
    split_ms = _time_ms(lambda: fh.split_conv_operands(tp, kph, pat, wm), n=5, warmup=1)
    lines.append(f"[17] (a) split of K1's operands (tp, kph, pat, wm) into TF32 hi and lo: bit for bit the plain "
                 f"split; {split_ms:.4f} ms per B={B} launch, inside K1's time below")

    # K1 at f32
    z, s, q = fh.conv_phase(tp, kph, pat, wm, b2b)
    torch.cuda.synchronize()
    zr, sr, qr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)
    err = _f32_conv_check(torch, z, s, q, zr, sr, qr)
    del zr, sr, qr
    ms = _time_ms(lambda: fh.conv_phase(tp, kph, pat, wm, b2b), n=5, warmup=1)
    plain = _time_ms(lambda: fh.conv_phase_plain(tp, kph, pat, wm, b2b), n=3, warmup=1)
    nbytes = 4 * (tp.numel() + kph.numel() + pat.numel() + wm.numel() + z.numel() + b2b.numel() + s.numel() + q.numel())
    k1 = conv_record("K1 conv_phase f32", "posfeat_tpu/ops/pallas/fused_head.py:148",
                     2.0 * B * h * w * N * (9 * C + KP), nbytes, err, ms, plain, lib_conv)
    del pat, wm, b2b

    # K2 at f32 on K1's z with the pooled IN1 statistics, as the head feeds it
    s1, s2 = s.sum(1).reshape(B, kk, cout).sum(1), q.sum(1).reshape(B, kk, cout).sum(1)
    mu = s1 / (h * w * kk)
    sc = torch.rsqrt(torch.clamp(s2 / (h * w * kk) - mu * mu, min=0.0) + 1e-5)
    a, w3, b3 = torch.tensor([0.25], device=dev), g(cout, out_ch, scale=0.1), g(out_ch, scale=0.1)
    u, us, uq = fh.head_tail(z, mu, sc, a, w3, b3)
    torch.cuda.synchronize()
    ur, usr, uqr = fh.head_tail_plain(z, mu, sc, a, w3, b3)
    err2 = (u - ur).abs().max().item()
    torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(us.sum(1), usr.sum(1), rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(uq.sum(1), uqr.sum(1), rtol=1e-3, atol=1e-2)
    k2_ms = _time_ms(lambda: fh.head_tail(z, mu, sc, a, w3, b3))
    k2_plain = _time_ms(lambda: fh.head_tail_plain(z, mu, sc, a, w3, b3), n=3)
    zb, w3t = z.view(B, -1, kk, cout), w3.t().contiguous()
    k2_lib = _time_ms(lambda: torch.nn.functional.linear(
        torch.nn.functional.prelu((zb - mu[:, None, None]) * sc[:, None, None], a), w3t, b3), n=5)
    k2_bytes = 4 * (z.numel() + mu.numel() + sc.numel() + 1 + w3.numel() + b3.numel() + u.numel() + us.numel()
                    + uq.numel())
    k2_bound = _bound(z.numel() * (3.0 + 2 * out_ch), PEAK_F32, k2_bytes)
    k2 = {"name": "K2 head_tail f32", "route": "cuda", "source": "posfeat_tpu_torch/csrc/fused_head.cu",
          "replaces": "posfeat_tpu/ops/pallas/fused_head.py:284", "launches": 0, "max_abs_err": err2, "ms": k2_ms,
          "plain_ms": k2_plain, "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": k2_lib}
    lines.append(f"[17] (a) K2 head_tail f32: u max|err| {err2:.3g}; {k2_ms:.4f} ms per B={B} launch (bound "
                 f"{k2_bound[0]:.4f} ms by {k2_bound[1]}), plain {k2_plain:.4f} ms, f32 linear(prelu) {k2_lib:.4f} ms; "
                 f"{k2_bytes / (k2_ms * 1e-3) * 1e-12:.3f} TB/s achieved ({k2_bytes * 1e-9:.4g} GB per launch), "
                 f"{k2_bound[0] / k2_ms:.1%} of the bound")
    del z, s, q, u, ur, zb

    # K3, T1, T2 at f32
    b2 = g(N, scale=0.1)
    k3 = None
    for layout, zimg in (("full", g(B, H, W, cout)), ("none", None), ("phase", g(B, h, w, N))):
        name = f"{fh.IMG_KERNELS[layout]} conv_phase_img f32"
        z, s, q = fh.conv_phase_img(tp, kph, zimg, b2, layout)
        torch.cuda.synchronize()
        zr, sr, qr = fh.conv_phase_img_plain(tp, kph, zimg, b2, layout)
        err = _f32_conv_check(torch, z, s, q, zr, sr, qr)
        del zr, sr, qr
        ms = _time_ms(lambda: fh.conv_phase_img(tp, kph, zimg, b2, layout), n=5, warmup=1)
        plain = _time_ms(lambda: fh.conv_phase_img_plain(tp, kph, zimg, b2, layout), n=3, warmup=1)
        nbytes = 4 * (tp.numel() + kph.numel() + z.numel() + (0 if zimg is None else zimg.numel()) + b2.numel()
                      + s.numel() + q.numel())
        rec = conv_record(name, {"full": "posfeat_tpu/ops/pallas/fused_head.py:70",
                                 "none": "tools/bench_fused_parts.py:105",
                                 "phase": "tools/bench_fused_parts.py:154"}[layout],
                          trunk_ops, nbytes, err, ms, plain, lib_conv)
        if layout == "full":
            k3 = rec  # T1 and T2 run on no path at f32: checked and timed here, not in the kernels line
        del z, s, q, zimg
    for line in lines:
        print(line)
    return [k1, k3, k2]


def slice_h_heads(torch, fh):
    """(b) The f32 "pallas" head against the f32 reference dataflow at
    480x640, v3 and v1, at the JAX fused-head tests' tolerance; the f32
    kernels launched, the bf16 ones not."""
    from posfeat_tpu_torch.models import KeypointDet, init_parameters

    dev, rng, out = torch.device("cuda"), np.random.default_rng(SEED + 17), []
    for mode in ("v3", "v1"):
        kw = dict(in_channels=192, out_channels=1, prior="identity", act="Softplus")
        fused = KeypointDet(**kw, fused_upsample="pallas", fused_head_mode=mode, dtype=torch.float32)
        init_parameters(fused, torch.Generator().manual_seed(SEED))
        ref = KeypointDet(**kw, fused_upsample=False)
        ref.load_state_dict(fused.state_dict())
        fused, ref = fused.to(dev), ref.to(dev)
        fm = torch.from_numpy(rng.random((2, H // 4, W // 4, 192), dtype=np.float32)).to(dev)
        img = torch.from_numpy(rng.standard_normal((2, H, W, 3), dtype=np.float32)).to(dev)
        _zero_counts(fh)
        with torch.no_grad():
            s_f = fused(fm, img)
            s_r = ref(fm, img)
        torch.cuda.synchronize()
        f32n, bf16n = _read_counts(fh, " f32"), _read_counts(fh)
        conv = "K1 conv_phase f32" if mode == "v3" else "K3 conv_phase_img f32"
        assert f32n[conv] == 1 and f32n["K2 head_tail f32"] == 1 and not any(bf16n.values()), (f32n, bf16n)
        assert s_f.dtype == torch.float32 and s_f.shape == s_r.shape == (2, H, W, 1) and torch.isfinite(s_f).all()
        torch.testing.assert_close(s_f, s_r, rtol=HEAD_RTOL, atol=HEAD_ATOL)
        d = (s_f - s_r).abs()
        out.append(f"{mode} max|d| {d.max().item():.4g} (worst share of the tolerance "
                   f"{(d / (HEAD_ATOL + HEAD_RTOL * s_r.abs())).max().item():.3g}), mean|d| {d.mean().item():.4g}, "
                   f"mean|score| {s_r.abs().mean().item():.4g}")
        del fused, ref, s_f, s_r
    print(f"[17] (b) f32 pallas head vs f32 reference dataflow at {H}x{W}, batch 2 (rtol {HEAD_RTOL:g} / atol "
          f"{HEAD_ATOL:g}): " + "; ".join(out))


def slice_h_extraction(torch, fh, rng, records):
    """(c) The f32 extraction with ``head_dataflow: pallas``, v3 and v1, 64
    images after a warm-up batch, with its kernels' launches; beside it the
    f32 extraction as the shipped f32 config runs it (the reference
    dataflow, no kernels)."""
    out = []
    for label, mode, dataflow in (("pallas v3", "v3", "pallas"), ("pallas v1", "v1", "pallas"),
                                  ("shipped f32 (reference dataflow)", None, None)):
        n, dt, peak, launches, counts = drive_extraction(torch, fh, rng, N_IMAGES_V1, head_mode=mode,
                                                         dtype="float32", head_dataflow=dataflow)
        f32n = {k: v for k, v in launches.items() if k.endswith(" f32")}
        bf16n = {k: v for k, v in launches.items() if not k.endswith(" f32")}
        assert not any(bf16n.values()), bf16n
        if dataflow is None:
            assert not any(f32n.values()), f32n
        else:
            conv = "K1 conv_phase f32" if mode == "v3" else "K3 conv_phase_img f32"
            other = "K3 conv_phase_img f32" if mode == "v3" else "K1 conv_phase f32"
            assert f32n[conv] > 0 and f32n["K2 head_tail f32"] > 0 and f32n[other] == 0, f32n
            assert fh.split_conv_operands.launches == f32n[conv], (fh.split_conv_operands.launches, f32n)
            for r in records:
                if r["name"] == conv or (mode == "v3" and r["name"] == "K2 head_tail f32"):
                    r["launches"] = f32n[r["name"]]
        out.append(f"{label}: {n / dt:.2f} im/s ({dt:.3f} s), peak {peak / 2**30:.2f} GiB, keypoints/image "
                   f"{min(counts)}-{max(counts)}, launches {{{', '.join(f'{k}: {v}' for k, v in f32n.items() if v)}}}")
    print(f"[17] (c) f32 extraction, {N_IMAGES_V1} images {H}x{W} in batches of {BATCH} after a warm-up batch, "
          f"{NUM_PTS} pts (bf16 instances 0 launches): " + "; ".join(out))


def slice_h_reduction(torch, rng):
    """(d) The reduction at D = 256 and D = 200 (beyond the resident f1
    tile; 200 not a multiple of 16) against its plain versions with phase
    6's checks, plus times; returns the D = 256 passes' records."""
    from posfeat_tpu_torch.ops import reinforce as rf

    kw, T = REDUCTION_KW, REDUCTION_KW["temperature"]
    records = []
    for D in (256, 200):
        args = reduction_problem(torch, rng, D=D)
        f1, f2 = args[:2]
        (B, m, _), n = f1.shape, f2.shape[1]
        assert not rf.f1_resident(D)
        tiles = rf._split_operands(f1, f2)
        torch.cuda.synchronize()
        assert torch.equal(tiles[0], rf._split_plain(f1, False)) and torch.equal(tiles[1], rf._split_plain(f2, False))
        rl, cl = rf.lse_pass(f1, f2, T, tiles=tiles)
        torch.cuda.synchronize()
        rlp, clp = rf.lse_pass_plain(f1, f2, T)
        torch.testing.assert_close(rl, rlp, rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(cl, clp, rtol=2e-4, atol=1e-5)
        err_lse = max((rl - rlp).abs().max().item(), (cl - clp).abs().max().item())
        out, ref, (ratio, rel_bound), flip = reward_same_inputs(torch, rf, args, rlp, clp, kw, tiles)
        err_rw = max((o - r).abs().max().item() for o, r in zip(out[:7], ref[:7]))
        fed = rf.reward_pass(*args, rl, cl, **kw, tiles=tiles)
        torch.cuda.synchronize()
        for o, r in zip(fed[:7], ref[:7]):
            torch.testing.assert_close(o, r, rtol=2e-4, atol=1e-5)
        n_good = ref[7].sum().item()
        flip_fed = (fed[7] - ref[7]).abs().sum().item()
        assert flip_fed <= 1e-3 * n_good, (flip_fed, n_good)
        whole = rf.reinforce_reduction(*args, **kw)
        whole_ref = rf.reinforce_reduction_plain(*args, **kw)
        for o, r in zip(whole, whole_ref):
            torch.testing.assert_close(o, r, rtol=2e-4, atol=1e-5)
        del out, fed, whole
        lse_ms = _time_ms(lambda: rf.lse_pass(f1, f2, T, tiles=tiles))
        rw_ms = _time_ms(lambda: rf.reward_pass(*args, rl, cl, **kw, tiles=tiles))
        lse_plain = _time_ms(lambda: rf.lse_pass_plain(f1, f2, T), n=3)
        rw_plain = _time_ms(lambda: rf.reward_pass_plain(*args, rl, cl, **kw), n=3)

        def lse_library():
            aff = T * torch.bmm(f1, f2.mT) - T
            return torch.logsumexp(aff, -1), torch.logsumexp(aff, 1)

        lse_lib = _time_ms(lse_library, n=5)
        product = 2.0 * B * m * n * D
        lse_bound = _bound(3 * product, PEAK_TF32, 4 * (f1.numel() + f2.numel() + rl.numel() + cl.numel()))
        rw_bytes = 4 * (sum(a.numel() for a in args) + rl.numel() + cl.numel() + 2 * m * B + 2 * n * B + 3 * B)
        rw_bound = _bound(3 * product, PEAK_TF32, rw_bytes)
        print(f"[17] (d) reduction at B={B} m={m} n={n} D={D} (f1 streamed): split bit for bit; lse max|err| "
              f"{err_lse:.3g}; reward on the plain lse max|err| {err_rw:.3g}, |d s0| / bound {ratio:.4g} (bound / |s0| "
              f"{rel_bound:.4g}; {s0_bound_note(D)}), flipped {flip:g} / {flip_fed:g} of {int(n_good)} good pairs; "
              f"fed the lse kernel's outputs and the whole reduction within rtol 2e-4; lse {lse_ms:.4f} ms (bound "
              f"{lse_bound[0]:.4f} by {lse_bound[1]}, {product / (lse_ms * 1e-3) * 1e-12:.2f} TFLOP/s of the product, "
              f"{lse_bound[0] / lse_ms:.1%} of the bound; plain {lse_plain:.4f}, logsumexp {lse_lib:.4f}), reward "
              f"{rw_ms:.4f} ms (bound {rw_bound[0]:.4f}, {product / (rw_ms * 1e-3) * 1e-12:.2f} TFLOP/s, "
              f"{rw_bound[0] / rw_ms:.1%}; plain {rw_plain:.4f})")
        if D == 256:
            records += [
                {"name": "K4+K5 lse_pass D=256", "route": "cuda", "source": "posfeat_tpu_torch/csrc/reinforce.cu",
                 "replaces": "posfeat_tpu/ops/pallas/reinforce.py:66", "launches": 0, "max_abs_err": err_lse,
                 "ms": lse_ms, "plain_ms": lse_plain, "bound_ms": lse_bound[0], "bound_by": lse_bound[1],
                 "library_ms": lse_lib},
                {"name": "K6 reward_pass D=256", "route": "cuda", "source": "posfeat_tpu_torch/csrc/reinforce.cu",
                 "replaces": "posfeat_tpu/ops/pallas/reinforce.py:110", "launches": 0, "max_abs_err": err_rw,
                 "ms": rw_ms, "plain_ms": rw_plain, "bound_ms": rw_bound[0], "bound_by": rw_bound[1],
                 "library_ms": None},
            ]
        del args, f1, f2, tiles, ref, whole_ref
    return records


def phase_slice_h(torch, fh, rng, smi):
    """Phase 17: slice H, the fused head's f32 kernels and the reduction
    at any descriptor width; returns the new kernel records."""
    t_phase = time.perf_counter()
    records = slice_h_kernels(torch, fh, rng)
    slice_h_heads(torch, fh)
    slice_h_extraction(torch, fh, rng, records)
    reduction = slice_h_reduction(torch, rng)
    phase_training(torch, reduction, fine_out_ch=256, tag="[17] (e)", suffix=" D=256")
    records += reduction
    for r in records:
        assert r["launches"] > 0, f"{r['name']} was not launched on its path"
    seconds = time.perf_counter() - t_phase
    print(f"[17] slice H: {seconds:.1f} s (budget {SLICE_H_BUDGET_S:g} s); {smi}")
    return records


SLICE_K_BUDGET_S = 60.0
# an Aachen-class frame (6.3 Mpx, above the 4 Mpx default spatial_threshold_px)
# and the Aachen detector (configs/extract_aachen.yaml:33-39)
SLICE_K_H, SLICE_K_W = 2048, 3072
AACHEN_DET = {"num_pts": 20480, "stable": True, "use_nms": True, "nms_radius": 3, "thr": 0.5, "thr_mod": "abs"}
# banded against unsharded: valid_count within 1e-3 of it, at most 1e-3 of the
# slate without a partner at the same pixel, matched f32 scores rtol 1e-3 and
# descriptors atol 1e-4, matched bf16 scores within 2e-2 x mean|score|
SLICE_K_VALID_RTOL, SLICE_K_UNMATCHED, SLICE_K_BF16_SCORE = 1e-3, 1e-3, 2e-2


def _frame(rng, h, w):
    """One seeded uint8 frame: smooth blobs plus noise, as ``_images``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.08, size=(3, 2))
    ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
    base = np.stack([np.sin(f[c, 0] * yy + ph[c, 0]) * np.cos(f[c, 1] * xx + ph[c, 1]) for c in range(3)], -1)
    return np.clip(127.5 + 80 * base + rng.normal(0, 20, size=(h, w, 3)), 0, 255).astype(np.uint8)


def slice_k_program(torch, model, mesh, detector="generate_kpts_single", det=AACHEN_DET):
    """uint8 [1, H, W, 3] on the card -> (pixel coords, scores, descriptors,
    valid): the Extractor's device program with ``detector`` on ``det``,
    unsharded (``mesh`` None) or banded over ``mesh``."""
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.ops.coords import denormalize_coords
    from posfeat_tpu_torch.ops.detect import DETECTORS
    from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord
    from posfeat_tpu_torch.parallel import detect, sample_feat_by_coord as banded_sample, spatial_extract

    dev0 = mesh.devices[0] if mesh is not None else next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev0)
    std = torch.as_tensor(IMAGENET_STD, device=dev0)

    def banded_post(o):
        coord_n, score, valid = detect(o["local_point"], detector, **det)
        return coord_n, score, banded_sample(o["local_map"], coord_n, True), valid

    forward = None if mesh is None else spatial_extract(model, mesh, banded_post)

    @torch.inference_mode()
    def run(im_u8, scale=None):
        im = (im_u8.to(dev0).float() / 255.0 - mean) / std
        if scale is not None:  # the normalized input times ``scale``
            im = im * scale
        if forward is None:
            o = model.extract(im)
            coord_n, score, valid = DETECTORS[detector](o["local_point"], **det)
            feat = sample_feat_by_coord(o["local_map"], coord_n, True)
        else:
            coord_n, score, feat, valid = forward(im)
        return denormalize_coords(coord_n, *im_u8.shape[1:3]), score, feat, valid

    return run


def _timed_slate(torch, run, im_u8, devices, reps=3, num_pts=AACHEN_DET["num_pts"]):
    """(host slate trimmed to the reference's count, ms per image over
    ``reps`` runs after a warm-up, peak bytes per device): CUDA events on
    the first device, every device synchronized."""
    run(im_u8)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = run(im_u8)
    t1.record()
    for d in devices:
        torch.cuda.synchronize(d)
    return _trim(out, num_pts), t0.elapsed_time(t1) / reps, [torch.cuda.max_memory_allocated(d) for d in devices]


def _trim(out, num_pts=AACHEN_DET["num_pts"]):
    """A device program's output as the host slate, trimmed to the
    reference's count max(min(num_pts, valid), 128)."""
    coords, score, feat, valid = (t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy() for t in out)
    n = int(max(min(num_pts, int(valid[0])), 128))
    return coords[0, :n], score[0, :n, 0], feat[0, :n], int(valid[0])


def _pair_slates(got, ref):
    """Each point of ``got`` paired with the point of ``ref`` in its pixel
    (the nearest within 0.5 px; NMS winners are more than 3 px apart).
    Returns (share of ``got`` unpaired, pairs as index arrays)."""
    kg, kr = got[0], ref[0]
    table = {}
    for j, (x, y) in enumerate(np.rint(kr).astype(np.int64)):
        table.setdefault((x, y), []).append(j)
    gi, ri = [], []
    for i, (x, y) in enumerate(np.rint(kg).astype(np.int64)):
        near = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1) for j in table.get((x + dx, y + dy), ())]
        if near:
            j = min(near, key=lambda j: float(np.abs(kr[j] - kg[i]).max()))
            if np.abs(kr[j] - kg[i]).max() <= 0.5:
                gi.append(i)
                ri.append(j)
    return 1.0 - len(gi) / max(len(kg), 1), np.array(gi, np.int64), np.array(ri, np.int64)


def slice_k_compare(got, ref, f32, exact=False):
    """Banded slate against the unsharded one of the same dataflow; returns
    the printed figures. Raises past the limits above, or, ``exact``,
    unless valid_count and the keypoints, scores and descriptors are the
    unsharded ones bit for bit."""
    if exact:
        assert got[3] == ref[3], ("valid", got[3], ref[3])
        for name, g, r in zip(("keypoints", "scores", "descriptors"), got, ref):
            assert g.shape == r.shape and np.array_equal(g, r), name
        return f"valid {got[3]} (Δvalid 0), unmatched 0, keypoints, scores and descriptors bit for bit"
    unmatched, gi, ri = _pair_slates(got, ref)
    dv = abs(got[3] - ref[3])
    ds = np.abs(got[1][gi] - ref[1][ri])
    dd = np.abs(got[2][gi] - ref[2][ri]).max() if len(gi) else 0.0
    assert dv <= SLICE_K_VALID_RTOL * ref[3], (got[3], ref[3])
    assert unmatched <= SLICE_K_UNMATCHED, unmatched
    if f32:
        assert (ds <= 1e-3 * np.abs(ref[1][ri]) + 1e-5).all(), ds.max()
        assert dd <= 1e-4, dd
    else:
        assert ds.max() <= SLICE_K_BF16_SCORE * np.abs(ref[1]).mean(), (ds.max(), np.abs(ref[1]).mean())
    return (f"valid {got[3]} (|d| {dv}), unmatched {unmatched:.6f}, scores max |d| {ds.max():.3e} "
            f"(rel {np.max(ds / np.abs(ref[1][ri])):.3e}), descriptors max |d| {dd:.3e}")


def slice_k_extractor(torch, tmp, frame, slate):
    """The Extractor's own sharded route in bf16 (``spatial_shard: 2`` with
    the visible devices seen as two, as the CPU test patches them; on one
    card the mesh lists cuda:0 twice): its fused head swapped for "phase"
    in the banded program only, and its npz equal to ``slate``, the banded
    bf16 "phase" program's slate on the same weights and image."""
    ex = _banded_extractor(torch, tmp, "slice_k", 2, {"fast_mode": False, "head_dataflow": None})
    ex.dataset = [_frame_item(frame, "k/frame.png")]
    assert ex._use_spatial(frame.shape[:2])
    ex.extract()
    assert ex.model.localheader.fused_upsample == "pallas"
    f = np.load(f"{ex.desc_root}/k/frame.png.npz")
    assert ("spatial", frame.shape[:2], "detector_config") in ex._programs
    assert np.array_equal(f["keypoints"], slate[0]) and np.array_equal(f["scores"][:, 0], slate[1])
    assert np.array_equal(f["descriptors"], slate[2])
    return len(f["keypoints"])


def _frame_item(frame, name):
    """One frame as an extraction dataset's sample."""
    return {"im1": None, "im1_ori": frame, "coord1": np.zeros((0, 2), np.float32), "name1": name,
            "pad1": (0, 0, 0, 0)}


def _banded_extractor(torch, tmp, tag, bands, extra):
    """A bf16 flagship Extractor on cuda:0 with ``spatial_shard: bands``
    (the visible devices seen as ``bands``, the mesh listing cuda:0 that
    many times where the machine has fewer cards), the Aachen detector and
    the 'phase' head, the banded program's; ``extra`` overrides config
    keys (``head_dataflow: None`` keeps the card's default head)."""
    from posfeat_tpu_torch.extract import Extractor
    from posfeat_tpu_torch.extract import extractor as ex_mod

    saved = ex_mod._visible_devices, ex_mod.spatial_mesh
    ex_mod._visible_devices = lambda device: bands
    if torch.cuda.device_count() < bands:
        ex_mod.spatial_mesh = lambda devices: saved[1]([torch.device("cuda", 0)] * len(devices))
    try:
        cfg = {
            "output_root": tag, "postfix": "npz", "load_path": None, "loss_distance": "cos",
            "output_desc": True, "output_img": False, "compute_dtype": "bfloat16", "model": "PoSFeat",
            "head_dataflow": "phase", "model_config": copy.deepcopy(FLAGSHIP_MODEL_CONFIG),
            "data": "HPatch_SIFT", "data_config_extract": {"batch_size": 1, "workers": 1}, "use_sift": False,
            "detector": "generate_kpts_single", "detector_config": dict(AACHEN_DET), "spatial_shard": bands,
            **extra,
        }
        ex = Extractor(cfg, ckpt_root=tmp, dataset=[], seed=SEED)
    finally:
        ex_mod._visible_devices, ex_mod.spatial_mesh = saved
    assert len(ex._spatial_mesh.devices) == bands
    return ex


def phase_slice_k(torch, fh, rng, smi):
    """Phase 18: slice K, extraction of one Aachen-class frame banded over
    the spatial mesh."""
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.ops.moments import row_moments
    from posfeat_tpu_torch.parallel import spatial_mesh

    t_phase = time.perf_counter()
    frame = _frame(rng, SLICE_K_H, SLICE_K_W)
    im_u8 = torch.from_numpy(frame)[None].cuda()
    card = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    meshes = [(f"{k} bands on cuda:0", spatial_mesh([card] * k)) for k in (2, 4)]
    meshes += [(f"{k} bands on cuda:0-{k - 1}", spatial_mesh([torch.device("cuda", i) for i in range(k)]))
               for k in (2, 4) if k <= n_cards]
    slates = {}
    for dtype, label, dataflow in ((torch.float32, "f32 reference", False), (torch.bfloat16, "bf16 phase", "phase")):
        cfg = copy.deepcopy(FLAGSHIP_MODEL_CONFIG)
        cfg["localheader_config"]["fused_upsample"] = dataflow
        model = PoSFeat(cfg, dtype=dtype, device=card, seed=SEED)
        ref, ms_ref, peak_ref = _timed_slate(torch, slice_k_program(torch, model, None), im_u8, [card])
        print(f"[18] {label}, unsharded: {ms_ref:.4f} ms/image, peak {peak_ref[0] / 2**30:.2f} GiB, "
              f"valid {ref[3]}, slate {len(ref[0])}")
        for name, mesh in meshes:
            devs = sorted(set(mesh.devices), key=str)
            _zero_counts(fh)
            got, ms, peaks = _timed_slate(torch, slice_k_program(torch, model, mesh), im_u8, devs)
            launches = {**_read_counts(fh), **_read_counts(fh, " f32")}
            assert not any(launches.values()), launches  # no fused-head kernel lies on the banded path
            assert row_moments.launches > 0  # the head's norms' row moments do
            per = ", ".join(f"{d}: {p / 2**30:.2f}" for d, p in zip(devs, peaks))
            # the banded program computes the unsharded one's function bit for bit
            print(f"[18] {label}, {name}: {ms:.4f} ms/image ({ms / ms_ref:.3f}x unsharded), peak GiB {per} "
                  f"(total {sum(peaks) / 2**30:.2f}); row moments {row_moments.launches} launches; "
                  f"{slice_k_compare(got, ref, dtype == torch.float32, exact=True)}")
            slates[(label, name)] = got
        if dtype == torch.bfloat16:
            model.localheader.fused_upsample = "pallas"
            fused, ms_fused, _ = _timed_slate(torch, slice_k_program(torch, model, None), im_u8, [card])
            for name, _ in meshes:
                overlap = 1.0 - _pair_slates(slates[(label, name)], fused)[0]
                print(f"[18] bf16 {name} against the unsharded fused head ('pallas', {ms_fused:.4f} ms/image): "
                      f"top-k overlap {overlap:.4f}")
        del model
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        n = slice_k_extractor(torch, tmp, frame, slates[("bf16 phase", "2 bands on cuda:0")])
    print(f"[18] Extractor, spatial_shard: 2 (bf16, its fused head swapped for 'phase' in the banded program): "
          f"the {SLICE_K_H}x{SLICE_K_W} frame ran banded, its npz ({n} keypoints) equal to spatial_extract's slate")
    seconds = time.perf_counter() - t_phase
    print(f"[18] slice K: {seconds:.1f} s (budget {SLICE_K_BUDGET_S:g} s); {smi}")

# slice L: a 12 MP phone photo (4032x3024, H x W = 3024 x 4032) unsharded,
# above the 2^31 output elements of one channels-last resize that the
# reference head's x4 resize of its 192-channel trunk reaches near 11 Mpx
SLICE_L_H, SLICE_L_W = 3024, 4032
SLICE_L_12MP_BUDGET_S = 90.0
SLICE_L_LAUNCH_BUDGET_S = 150.0
SLICE_L_BANDS_BUDGET_S = 90.0
SLICE_L_STEPS = 3
# the lifted spatial_shard configurations on phase 18's frame: (label, backbone, detector, its config)
SLICE_L_CONFIGS = (
    ("ResUNetHR, generate_kpts_single", "ResUNetHR", "generate_kpts_single", AACHEN_DET),
    ("generate_kpts_single_noavg", "ResUNet", "generate_kpts_single_noavg", AACHEN_DET),
    # configs/train_kp.yaml's grid (8), stable
    ("generate_kpts_regular_grid_single", "ResUNet", "generate_kpts_regular_grid_single",
     {"grid_size": 8, "num_pts": AACHEN_DET["num_pts"], "nms_radius": 3, "stable": True}),
    ("generate_kpts_single, stride 2", "ResUNet", "generate_kpts_single", {**AACHEN_DET, "stride": 2}),
)
# Gumbel selection on the bands against the unsharded detector with the same noise
SLICE_L_GUMBEL = (256, 256, 512)


def slice_l_12mp(torch, fh, rng, smi):
    """(0 b) One seeded 3024x4032 frame unsharded, flagship model, Aachen
    detector: f32 with the reference dataflow (its x4 resize of the
    192-channel trunk writes 2.34e9 elements, in row blocks below
    ``resize.BLOCK_ELEMENTS``) and bf16 with the "phase" dataflow, each
    against the frame banded over 4 bands on cuda:0, bit for bit;
    then the bf16 fused head ("pallas": K1 and K2 on the 756x1008 trunk),
    its score map against the "phase" head's within phase 4's limits
    (mean |d| 2e-2, max |d| 1e-1 x mean|score|) and its slate's overlap
    with the banded one printed."""
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.ops import resize
    from posfeat_tpu_torch.parallel import spatial_mesh

    t_phase = time.perf_counter()
    frame = _frame(rng, SLICE_L_H, SLICE_L_W)
    im_u8 = torch.from_numpy(frame)[None].cuda()
    card = torch.device("cuda", 0)
    mesh = spatial_mesh([card] * 4)
    cin = FLAGSHIP_MODEL_CONFIG["localheader_config"]["in_channels"]
    elems = SLICE_L_H * SLICE_L_W * cin
    rows = resize.BLOCK_ELEMENTS // (cin * 4 * SLICE_L_W) - 2
    print(f"[19] slice L (0 b): a {SLICE_L_H}x{SLICE_L_W} frame ({SLICE_L_H * SLICE_L_W / 1e6:.2f} Mpx); the "
          f"reference head's x4 resize writes {elems:.4g} elements (one call takes < 2^31 = {2**31:.4g}): "
          f"{-(-SLICE_L_H // 4 // rows)} row blocks of {rows} trunk rows")
    slates = {}
    for dtype, label, dataflow in ((torch.float32, "f32 reference", False), (torch.bfloat16, "bf16 phase", "phase")):
        cfg = copy.deepcopy(FLAGSHIP_MODEL_CONFIG)
        cfg["localheader_config"]["fused_upsample"] = dataflow
        model = PoSFeat(cfg, dtype=dtype, device=card, seed=SEED)
        torch.cuda.empty_cache()
        ref = None
        try:
            ref, ms_ref, peak_ref = _timed_slate(torch, slice_k_program(torch, model, None), im_u8, [card], reps=2)
            print(f"[19] {label}, unsharded: {ms_ref:.4f} ms/image, peak {peak_ref[0] / 2**30:.2f} GiB, "
                  f"valid {ref[3]}, slate {len(ref[0])}")
        except torch.cuda.OutOfMemoryError as e:
            if dtype != torch.float32:
                raise
            print(f"[19] {label}, unsharded: does not fit on one card ({torch.cuda.max_memory_allocated(card) / 2**30:.2f} "
                  f"GiB allocated at the peak): {str(e).splitlines()[0]}")
        torch.cuda.empty_cache()
        got, ms, peaks = _timed_slate(torch, slice_k_program(torch, model, mesh), im_u8, [card], reps=2)
        assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all() and np.isfinite(got[2]).all()
        norms = np.linalg.norm(got[2], axis=1)
        assert np.abs(norms - 1).max() < 1e-3, norms
        # the convs whose algorithm cuDNN picks by the map's height at this
        # size (bf16: the encoder's at H/8, the decoder's) run in the same row
        # tiles in both programs, so the banded slate is the unsharded one
        # bit for bit
        cmp = (slice_k_compare(got, ref, dtype == torch.float32, exact=True) if ref is not None
               else "no unsharded run to hold it to")
        print(f"[19] {label}, 4 bands on cuda:0 (first rows {mesh.plan(SLICE_L_H)}): {ms:.4f} ms/image "
              f"({ms / ms_ref:.3f}x unsharded), peak {peaks[0] / 2**30:.2f} GiB; {cmp}" if ref is not None else
              f"[19] {label}, 4 bands on cuda:0: {ms:.4f} ms/image, peak {peaks[0] / 2**30:.2f} GiB; {cmp}")
        slates[label] = got
        if dtype == torch.bfloat16:
            with torch.inference_mode():
                im = im_u8.float() / 255.0  # any normalisation: both heads see the same input
                phase_map = model.extract(im)["local_point"].float()
                model.localheader.fused_upsample = "pallas"
                _zero_counts(fh)
                fused_map = model.extract(im)["local_point"].float()
                counts = _read_counts(fh)
            assert counts["K1 conv_phase"] == 1 and counts["K2 head_tail"] == 1, counts
            d = (fused_map - phase_map).abs()
            err, err_mean, scale = float(d.max()), float(d.mean()), float(phase_map.abs().mean())
            # phase 4's limits on a bf16 head: the mean within 2e-2 and the max within 1e-1 of mean|score|
            assert err_mean < 2e-2 * scale and err < 1e-1 * scale, (err_mean, err, scale)
            del phase_map, fused_map, d
            torch.cuda.empty_cache()
            fused, ms_fused, peak_fused = _timed_slate(torch, slice_k_program(torch, model, None), im_u8, [card], reps=2)
            overlap = 1.0 - _pair_slates(got, fused)[0]
            print(f"[19] bf16 fused head ('pallas', unsharded; K1 and K2 on the {SLICE_L_H // 4}x{SLICE_L_W // 4} "
                  f"trunk, launches {counts['K1 conv_phase']} / {counts['K2 head_tail']} in one forward): "
                  f"{ms_fused:.4f} ms/image, peak {peak_fused[0] / 2**30:.2f} GiB; score map against the 'phase' "
                  f"head's: mean |d| {err_mean:.4g}, max |d| {err:.4g} (limits 2e-2 / 1e-1 x mean|score| {scale:.4g}, "
                  f"phase 4's); top-k overlap with the 4-band bf16 slate {overlap:.4f}")
        del model
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    assert seconds <= SLICE_L_12MP_BUDGET_S, seconds
    print(f"[19] slice L (0 b): {seconds:.1f} s (budget {SLICE_L_12MP_BUDGET_S:g} s); {smi}")


def _per_rank_s_step(run_dir):
    times = [json.loads(x) for x in open(f"{run_dir}/step_times.jsonl")]
    ranks = sorted({t.get("rank", 0) for t in times})
    return [float(np.mean([t["step_time_s"] for t in times if t.get("rank", 0) == r][1:])) for r in ranks]


def slice_l_launcher(torch, smi, s_step_main):
    """(a) The launcher (``python -m posfeat_tpu_torch.train``'s path) on
    configs/train_kp.yaml, flagship model, f32, SyntheticPairs 480x640,
    batch 6, SLICE_L_STEPS steps: two ranks on cuda:0 over gloo (and over
    every card on NCCL where there are several), each fed its rows of the
    launcher's one loader; the trained head against the one-process run
    on the card (rtol 1e-3 / atol 2e-4, phase 16 (a)'s), the split, K4+K5
    and K6 launched once a step on every rank, s/step per rank."""
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.train import Trainer
    from posfeat_tpu_torch.train.launch import kernel_launches, launch

    t_phase = time.perf_counter()
    cfg = train_config()
    cfg.update(checkpoint_name="smoke_launch", epoch_step=SLICE_L_STEPS)
    runs = [("two ranks on cuda:0", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        runs.append((f"ranks over cuda:0-{torch.cuda.device_count() - 1}", None))
    with tempfile.TemporaryDirectory() as tmp:
        before = kernel_launches()
        Trainer(cfg, ckpt_root=f"{tmp}/one", device="cuda").train()
        one = {k: v - before[k] for k, v in kernel_launches().items()}
        assert one["K4+K5 lse_pass"] == one["K6 reward_pass"] == SLICE_L_STEPS, one
        want = torch.load(f"{tmp}/one/smoke_launch/001/localheader.pth", weights_only=True)
        s_one = _per_rank_s_step(f"{tmp}/one/smoke_launch")[0]
        for i, (label, devices) in enumerate(runs):
            # the ranks share the card with this process: free what the
            # one-process Trainer's reference cycles still hold, then the cache
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[20] slice L (a) launcher, {label}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
                  f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved at the launch")
            plan = launch(cfg, devices=devices, ckpt_root=f"{tmp}/run{i}")
            assert len(plan["ranks"]) == len(plan["devices"]) > 1, plan
            for rec in plan["ranks"]:
                assert rec["launches"]["K4+K5 lse_pass"] == rec["launches"]["K6 reward_pass"] == SLICE_L_STEPS, rec
            got = torch.load(f"{tmp}/run{i}/smoke_launch/001/localheader.pth", weights_only=True)
            worst = max(_close(got[k].cpu(), want[k].cpu(), f"launched head {k}")[1] for k in want)
            s_ranks = _per_rank_s_step(f"{tmp}/run{i}/smoke_launch")
            print(f"[20] slice L (a) launcher, {label} ({plan['backend']}, {len(plan['devices'])} of {plan['of']} "
                  f"devices, global batch {TRAIN_BATCH}): head after {SLICE_L_STEPS} steps against the one-process "
                  f"run, worst share of rtol 1e-3 / atol 2e-4 {worst:.3g}; launches per rank "
                  f"{[rec['launches'] for rec in plan['ranks']]}; s/step per rank "
                  + ", ".join(f"{x:.4f}" for x in s_ranks)
                  + f" (after the first step) beside the one-process run's {s_one:.4f} (phase 7's {s_step_main:.4f}); "
                  f"rank seconds {[round(rec['seconds'], 1) for rec in plan['ranks']]}")
    seconds = time.perf_counter() - t_phase
    assert seconds <= SLICE_L_LAUNCH_BUDGET_S, seconds
    print(f"[20] slice L (a): {seconds:.1f} s (budget {SLICE_L_LAUNCH_BUDGET_S:g} s); {smi}")


def _finite_rows(slate):
    """The slate's points with finite coordinates (a stride above 1 leaves
    NaN slots past its strided grids, as JAX's gather fills them) and the
    count of the others."""
    ok = np.isfinite(slate[0]).all(axis=1)
    return (slate[0][ok], slate[1][ok], slate[2][ok], slate[3]), int((~ok).sum())


def slice_l_bands(torch, fh, rng, smi, frame):
    """(b) Phase 18's frame over 2 bands on cuda:0 in bf16 ("phase") for
    each lifted configuration (ResUNetHR; generate_kpts_single_noavg;
    the grid detector; a stride of 2) against the unsharded run of the
    same configuration, with phase 18's limits; then Gumbel selection on
    bands against the unsharded detector with the same noise, bit for
    bit."""
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.ops.detect import generate_kpts_single
    from posfeat_tpu_torch.parallel import detect, spatial_extract, spatial_mesh

    t_phase = time.perf_counter()
    im_u8 = torch.from_numpy(frame)[None].cuda()
    card = torch.device("cuda", 0)
    mesh = spatial_mesh([card] * 2)
    for label, backbone, detector, det in SLICE_L_CONFIGS:
        cfg = copy.deepcopy(FLAGSHIP_MODEL_CONFIG)
        cfg["backbone"] = backbone
        cfg["localheader_config"]["fused_upsample"] = "phase"
        model = PoSFeat(cfg, dtype=torch.bfloat16, device=card, seed=SEED)
        n_pts = det["num_pts"]
        _zero_counts(fh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # ResUNetHR's H/2 trunk takes the reference dataflow, with a warning
            ref, ms_ref, peak_ref = _timed_slate(torch, slice_k_program(torch, model, None, detector, det), im_u8,
                                                 [card], num_pts=n_pts)
            got, ms, peaks = _timed_slate(torch, slice_k_program(torch, model, mesh, detector, det), im_u8, [card],
                                          num_pts=n_pts)
        launches = _read_counts(fh)
        assert not any(launches.values()), launches
        (got_f, n_nan), (ref_f, n_nan_ref) = _finite_rows(got), _finite_rows(ref)
        assert abs(n_nan - n_nan_ref) <= SLICE_K_UNMATCHED * len(ref[0]), (n_nan, n_nan_ref)
        print(f"[21] slice L (b) bf16 phase, {label}: unsharded {ms_ref:.4f} ms/image (peak {peak_ref[0] / 2**30:.2f} "
              f"GiB), 2 bands on cuda:0 {ms:.4f} ms/image ({ms / ms_ref:.3f}x, peak {peaks[0] / 2**30:.2f} GiB); "
              f"{slice_k_compare(got_f, ref_f, False)}" + (f"; NaN slots {n_nan} / {n_nan_ref}" if n_nan_ref else ""))
        del model
        torch.cuda.empty_cache()

    gh, gw, gpts = SLICE_L_GUMBEL
    model = PoSFeat(copy.deepcopy(FLAGSHIP_MODEL_CONFIG), dtype=torch.float32, device=card, seed=SEED)
    im = torch.from_numpy(_frame(rng, gh, gw))[None].cuda().float() / 255.0
    kp_bands = spatial_extract(model, mesh)(im)["local_point"]
    gum = dict(num_pts=gpts, nms_radius=1, stable=False, temperature=0.05)
    gen = lambda: torch.Generator(device=card).manual_seed(SEED)
    got = detect(kp_bands, "generate_kpts_single", generator=gen(), **gum)
    want = generate_kpts_single(kp_bands.concat(), generator=gen(), **gum)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    print(f"[21] slice L (b) Gumbel selection ({gh}x{gw}, {gpts} points, one seeded generator) on 2 bands: slate "
          f"equal to the unsharded detector's with the same noise, bit for bit")
    seconds = time.perf_counter() - t_phase
    assert seconds <= SLICE_L_BANDS_BUDGET_S, seconds
    print(f"[21] slice L (b): {seconds:.1f} s (budget {SLICE_L_BANDS_BUDGET_S:g} s); {smi}")


def phase_slice_l(torch, fh, rng, smi, s_step_main):
    """Phases 19-21: slice L (the 12 Mpx frame unsharded, the launcher, the
    lifted spatial_shard configurations)."""
    slice_l_12mp(torch, fh, rng, smi)
    slice_l_launcher(torch, smi, s_step_main)
    slice_l_bands(torch, fh, rng, smi, _frame(rng, SLICE_K_H, SLICE_K_W))


# slice M (phase 22): the JAX package's bf16 extraction as it ships it. Its
# budget in seconds, the busy share's batches, the tail variants timed
SLICE_M_BUDGET_S = 90.0
SLICE_M_PROFILE_BATCHES = 2
TAIL_TIMED = ("", "up2", "split3", "iconv2", "split2", "split3w")


def slice_m_kernels(torch, fh, rng):
    """(a) K1, K2 and K3 on the ring-skip dataflow's operands (a zero
    halo in place of the edge clamp) at the flagship shapes, each against
    its plain version at phases 3 / 8's limits and timed; then the whole
    ring-skip head (v3 with im2col, and v1) with kernels against plain
    versions, one K1 (or K3) and one K2 launch a call."""
    import torch.nn.functional as F

    dev, bf = torch.device("cuda"), torch.bfloat16
    B, h, w, C, cout, cy = BATCH, H // 4, W // 4, 192, 128, 64
    N = 16 * cout

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    trunk, img_s = g(B, h, w, C).to(bf), g(B, H, W, 3).to(bf)
    k1, b1 = g(3, 3, 3, cy, scale=0.2), g(cy, scale=0.1)
    k2t, k2i, b2 = g(3, 3, C, cout, scale=0.03), g(3, 3, cy, cout, scale=0.05), g(cout, scale=0.1)
    img_y = (F.conv2d(img_s.permute(0, 3, 1, 2).float(), k1.permute(3, 2, 0, 1), b1, padding=1)
             .permute(0, 2, 3, 1).to(bf))
    tp = F.pad(trunk, (0, 0, 1, 1, 1, 1)).contiguous()  # the zero halo
    kph = fh._phase_kernel(k2t, 4).to(bf).reshape(9, C, N).contiguous()
    pat, wm, b2b = fh._v3_image_operands(img_s, k1, b1, k2i, b2, h, w, 4, 1e-5, bf)[:3]
    z_img = fh._v1_z_img(img_y, k2i, 1e-5, bf)
    b2ph = b2.float().repeat(16).contiguous()
    rows = {}
    for name, run, plain in (
        ("K1 conv_phase", lambda: fh.conv_phase(tp, kph, pat, wm, b2b),
         lambda: fh.conv_phase_plain(tp, kph, pat, wm, b2b)),
        ("K3 conv_phase_img", lambda: fh.conv_phase_img(tp, kph, z_img, b2ph, "full"),
         lambda: fh.conv_phase_img_plain(tp, kph, z_img, b2ph, "full")),
    ):
        z, s_, q = run()
        torch.cuda.synchronize()
        zr, sr, qr = plain()
        err = (z.float() - zr.float()).abs().max().item()
        torch.testing.assert_close(z.float(), zr.float(), rtol=2 ** -7, atol=1e-2)
        for got, ref in ((s_.sum(1), sr.sum(1)), (q.sum(1), qr.sum(1))):
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * ref.abs().mean().item())
        del zr, sr, qr
        rows[name] = (err, _time_ms(run, n=10, warmup=2))
        if name == "K1 conv_phase":
            s1 = s_.sum(1).reshape(B, 16, cout).sum(1) / (h * w * 16)
            s2 = q.sum(1).reshape(B, 16, cout).sum(1) / (h * w * 16)
            mu, sc = s1, torch.rsqrt(torch.clamp(s2 - s1 * s1, min=0.0) + 1e-5)
            a, w3, b3 = torch.tensor([0.25], device=dev), g(cout, 1, scale=0.1), g(1, scale=0.1)
            u, _, _ = fh.head_tail(z, mu, sc, a, w3, b3)
            torch.cuda.synchronize()
            ur = fh.head_tail_plain(z, mu, sc, a, w3, b3)[0]
            torch.testing.assert_close(u, ur, rtol=1e-4, atol=1e-4)
            rows["K2 head_tail"] = ((u - ur).abs().max().item(),
                                    _time_ms(lambda: fh.head_tail(z, mu, sc, a, w3, b3), n=10, warmup=2))
        del z, s_, q
    head = dict(k1_img=k1, b1_img=b1, k2_trunk=k2t, k2_img=k2i, b2=b2, w3=g(1, 1, cout, 1, scale=0.1),
                b3=g(1, scale=0.1), prelu_a=torch.tensor([0.25], device=dev), act="Softplus", ring=False)
    heads = []
    for mode, y, conv, plain_conv in (("v3", None, fh.conv_phase, fh.conv_phase_plain),
                                      ("v1", img_y, fh.conv_phase_img, fh.conv_phase_img_plain)):
        _zero_counts(fh)
        score = fh.fused_head_tail(trunk, img_s, y, mode=mode, im2col=mode == "v3", **head)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _read_counts(fh).items() if v}
        ref = fh._fused_head_tail(plain_conv, fh.head_tail_plain, trunk, img_s, y, mode=mode, **head)
        d = (score - ref).abs()
        mean = ref.abs().mean().item()
        assert torch.isfinite(score).all() and d.max().item() < 2e-2 * mean, (mode, d.max().item(), mean)
        want = {"K1 conv_phase" if mode == "v3" else "K3 conv_phase_img": 1, "K2 head_tail": 1}
        assert launches == want, (mode, launches)
        heads.append(f"{mode}: max|d| {d.max().item():.3g}, mean {d.mean().item():.3g} (mean|score| {mean:.4g}), "
                     f"launches {launches}")
    print(f"[22] (a) ring-skip operands (zero halo) at B={B} h={h} w={w} Cin={C} Cout={cout}: "
          + "; ".join(f"{k} max|err| {e:.4g}, {ms:.4f} ms per launch" for k, (e, ms) in rows.items())
          + "; ring-skip head, kernels vs plain versions, " + "; ".join(heads))
    return rows


def _profiled_busy(torch, run):
    """The card's busy share of ``run()``'s host-clock window: the union
    of the kernel intervals of a torch.profiler trace over the window, as
    tools/profile_torch_extract.py reads it; None where the trace holds
    no kernel."""
    from torch.profiler import ProfilerActivity, profile

    prof_tool = _load_tool("profile_torch_extract")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel" and "dur" in e]
    return prof_tool._busy_us(spans) / wall_us if spans else None


@contextlib.contextmanager
def _convimg_calls(out):
    """Counts the head's full-resolution convimg convs (3 -> 64 channels)
    in ``out['n']`` while the block runs."""
    from posfeat_tpu_torch.models import keypoint_det as kd

    conv = kd._conv

    def counting(x, weight, *a, **k):
        out["n"] += tuple(weight.shape[:2]) == (64, 3)
        return conv(x, weight, *a, **k)

    out["n"] = 0
    kd._conv = counting
    try:
        yield out
    finally:
        kd._conv = conv


def slice_m_extraction(torch, fh, rng):
    """(b) The flagship bf16 extraction through ``Extractor`` with
    ``fast_mode: False``, the default (the lite set on the card) and ship
    (lite plus ``desc_tail: split3``), one Extractor each, timed over 128
    images in turns (F, L, S, S, L, F; the host moves a single run by a
    fifth): im/s of each run, peak memory, K1/K2 launches, the
    full-resolution convimg's calls, and the card's busy share over a
    profiled run of a few batches."""
    data = _images(rng, N_IMAGES, "slice_m")
    arms = {"fast_mode False": (False, ""), "lite": (True, ""), "ship": (True, "split3")}
    runs = {arm: [] for arm in arms}
    peaks = dict.fromkeys(arms, 0)
    with tempfile.TemporaryDirectory() as tmp:
        exs = {}
        for i, (arm, (fast, tail)) in enumerate(arms.items()):
            ex = flagship_extractor(tmp, rng, output_root=f"m{i}", fast_mode=fast, desc_tail=tail)
            assert ex.config["fast_gates"]["head_ring"] is (not fast), ex.config["fast_gates"]
            assert ex.model.backbone.desc_tail == tail
            ex.dataset = data
            exs[arm] = ex
        for arm in (*arms, *reversed(arms)):
            ex = exs[arm]
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(fh)
            with _convimg_calls({}) as convimg:
                t0 = time.perf_counter()
                n, _ = ex.extract()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launches = {k: v for k, v in _read_counts(fh).items() if v}
            assert n == N_IMAGES and launches == {"K1 conv_phase": n // BATCH, "K2 head_tail": n // BATCH}, launches
            assert (convimg["n"] == 0) is arms[arm][0], (arm, convimg)  # no y_img under the ring-skip v3 head
            runs[arm].append(n / dt)
            peaks[arm] = max(peaks[arm], torch.cuda.max_memory_allocated())
        for arm, ex in exs.items():
            for it in data[:BATCH]:
                _check_npz(f"{ex.desc_root}/{it['name1']}.npz", NUM_PTS)
            ex.dataset = data[:BATCH * SLICE_M_PROFILE_BATCHES]
            busy = _profiled_busy(torch, ex.extract)
            print(f"[22] (b) {arm}: {N_IMAGES} images {H}x{W} bf16, batch {BATCH}, {NUM_PTS} points: "
                  f"{' / '.join(f'{r:.2f}' for r in runs[arm])} im/s (mean {np.mean(runs[arm]):.2f}), peak "
                  f"{peaks[arm] / 2**30:.2f} GiB, launches {launches} a run, full-resolution convimg calls "
                  f"{0 if arms[arm][0] else n // BATCH} a run, card busy "
                  f"{'not measured' if busy is None else f'{busy:.1%}'} over {SLICE_M_PROFILE_BATCHES} profiled "
                  f"batches; gates {ex.config['fast_gates']}")
        del exs, ex
    return {arm: float(np.mean(r)) for arm, r in runs.items()}


def slice_m_probe(probe_state):
    """(c) The lite and ship arms on phase 13's trained weights at both of
    its points, against its f32 arm, held to its limits. Returns the
    misses."""
    probe = _load_tool("selection_stability_torch")
    failed = []
    for (h, w), (point, num_pts, mma3_f32) in probe_state["f32_arms"].items():
        rec = probe.gate_arms(probe_state["ckpt"], point, f"{point}/ckpts/hp/f32/desc", mma3_f32, num_pts, "cuda")
        print(f"[22] (c) probe at {h}x{w}, {num_pts} points: {json.dumps(rec)}")
        for arm in probe.GATE_ARMS:
            assert rec[f"launches_{arm}"]["K1"] > 0 and rec[f"launches_{arm}"]["K2"] > 0, rec
            checks = {
                f"|delta_mma3_{arm}| ({arm} - f32)": (abs(rec[f"delta_mma3_{arm}"]), "<=", MAX_DELTA_MMA3),
                f"topk_overlap_mean_{arm}": (rec[f"topk_overlap_mean_{arm}"], ">=", MIN_TOPK_OVERLAP),
                f"match_agreement_mean_{arm}": (rec[f"match_agreement_mean_{arm}"], ">=", MIN_MATCH_AGREEMENT),
            }
            for name, (value, op, limit) in checks.items():
                ok = value <= limit if op == "<=" else value >= limit
                print(f"[22]   {h}x{w}: {name} {value:.6g} {op} {limit}: {'ok' if ok else 'MISSED'}")
                if not ok:
                    failed.append(f"{h}x{w} {name} {value:.6g}")
    return failed


def slice_m_tails(torch, rng):
    """(d) The flagship backbone at bf16, B = 16, 480x640: split3's local
    map against up2's (the true-f32 tail JAX validates split3 against),
    and each variant's ms per batch beside the concat dataflow's (the
    training plan with BatchNorm in eval mode) to price the concat-free
    iconvs."""
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.models import ResUNet, init_parameters

    dev = torch.device("cuda")
    ims = torch.from_numpy(np.stack([d["im1_ori"] for d in _images(rng, BATCH, "tails")])).to(dev)
    mean, std = (torch.as_tensor(x, device=dev) for x in (IMAGENET_MEAN, IMAGENET_STD))
    x = (ims.float() / 255.0 - mean) / std
    net = ResUNet(**FLAGSHIP_MODEL_CONFIG["backbone_config"], dtype=torch.bfloat16)
    init_parameters(net, torch.Generator().manual_seed(SEED))
    net = net.to(dev).eval()
    maps, ms = {}, {}
    with torch.no_grad():
        for tail in TAIL_TIMED:
            net.desc_tail = tail
            maps[tail] = net(x)["local_map"].float()
            ms[tail] = _time_ms(lambda: net(x), n=5, warmup=2)
        net.desc_tail = ""
        plan = net.plan
        net.plan = lambda training: plan(True)  # the concat dataflow, BatchNorm still in eval mode
        concat = net(x)["local_map"].float()
        ms["concat"] = _time_ms(lambda: net(x), n=5, warmup=2)
        del net.plan
    d = (maps["split3"] - maps["up2"]).abs()
    scale = maps["up2"].abs().mean().item()
    dc = (maps[""] - concat).abs()
    assert torch.isfinite(maps["split3"]).all() and maps["split3"].dtype == torch.float32
    print(f"[22] (d) backbone bf16 at B={BATCH} {H}x{W}: split3 vs up2 local_map max|d| {d.max().item():.4g}, "
          f"mean {d.mean().item():.4g}, max over mean|up2| {d.max().item() / scale:.4g} (mean|up2| {scale:.4g}); "
          f"concat-free vs concat iconvs max|d| {dc.max().item():.4g}; ms per batch of {BATCH}: "
          + ", ".join(f"{t or 'default (concat-free)'} {v:.4f}" for t, v in ms.items())
          + f"; the concat-free iconvs cost {(ms[''] - ms['concat']) / BATCH:.4f} ms/image")
    return ms


def phase_slice_m(torch, fh, rng, smi, probe_state, ims_main):
    """Phase 22: slice M, bf16 extraction as the JAX package ships it."""
    t_phase = time.perf_counter()
    slice_m_kernels(torch, fh, rng)
    rates = slice_m_extraction(torch, fh, rng)
    failed = slice_m_probe(probe_state)
    slice_m_tails(torch, rng)
    seconds = time.perf_counter() - t_phase
    print(f"[22] slice M: {seconds:.1f} s (budget {SLICE_M_BUDGET_S:g} s); im/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()) + f" (phase 5: {ims_main:.2f}); {smi}")
    assert not failed, f"the gate arms missed: {failed}"


# slice N (phase 23): the fused head's img_stats="xla", and the
# fast gates on the banded program. Its budget in seconds
SLICE_N_BUDGET_S = 60.0


def slice_n_kernels(torch, fh, rng):
    """(a) K1 and K2 through ``fused_head_tail(img_stats="xla")`` and the
    default ("gram") at phase 3's shapes (B=16, 120x160, Cin 192,
    Cout 128, bf16, the exact ring): K1 on each option's operands against
    its plain version (z within one bf16 ulp, moments at rtol 1e-3), the
    whole head with kernels against plain versions (2e-2 x mean|score|,
    one K1 and one K2 launch a call), gram against xla within 2e-2 x
    mean|score| (tests/test_pallas_fused_head.py:211-227's bf16 limit);
    ms of K1 a launch and of the head a call."""
    import torch.nn.functional as F

    dev, bf = torch.device("cuda"), torch.bfloat16
    B, h, w, C, cout, cy = BATCH, H // 4, W // 4, 192, 128, 64
    N = 16 * cout

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    trunk, img_s = g(B, h, w, C).to(bf), g(B, H, W, 3).to(bf)
    k1, b1 = g(3, 3, 3, cy, scale=0.2), g(cy, scale=0.1)
    k2t, k2i, b2 = g(3, 3, C, cout, scale=0.03), g(3, 3, cy, cout, scale=0.05), g(cout, scale=0.1)
    img_y = (F.conv2d(img_s.permute(0, 3, 1, 2).float(), k1.permute(3, 2, 0, 1), b1, padding=1)
             .permute(0, 2, 3, 1).to(bf))
    tp = fh._edge_pad1(trunk).contiguous()  # the exact ring's halo (Cin = 192 needs no channel pad)
    kph = fh._phase_kernel(k2t, 4).to(bf).reshape(9, C, N).contiguous()
    head = dict(k1_img=k1, b1_img=b1, k2_trunk=k2t, k2_img=k2i, b2=b2, w3=g(1, 1, cout, 1, scale=0.1),
                b3=g(1, scale=0.1), prelu_a=torch.tensor([0.25], device=dev), act="Softplus")
    rows, scores = [], {}
    for label, kw in (("img_stats='xla'", {"img_stats": "xla"}), ("gram", {})):
        xla = kw.get("img_stats") == "xla"
        pat, wm, b2b = fh._v3_image_operands(img_s, k1, b1, k2i, b2, h, w, 4, 1e-5, bf, img_y if xla else None)[:3]
        z, s_, q = fh.conv_phase(tp, kph, pat, wm, b2b)
        torch.cuda.synchronize()
        zr, sr, qr = fh.conv_phase_plain(tp, kph, pat, wm, b2b)
        err = (z.float() - zr.float()).abs().max().item()
        torch.testing.assert_close(z.float(), zr.float(), rtol=2 ** -7, atol=1e-2)
        for got, ref in ((s_.sum(1), sr.sum(1)), (q.sum(1), qr.sum(1))):
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * ref.abs().mean().item())
        k1_ms = _time_ms(lambda: fh.conv_phase(tp, kph, pat, wm, b2b), n=10, warmup=2)
        del z, s_, q, zr, sr, qr
        _zero_counts(fh)
        score = fh.fused_head_tail(trunk, img_s, img_y, **head, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _read_counts(fh).items() if v}
        assert launches == {"K1 conv_phase": 1, "K2 head_tail": 1}, (label, launches)
        ref = fh._fused_head_tail(fh.conv_phase_plain, fh.head_tail_plain, trunk, img_s, img_y,
                                  img_stats=kw.get("img_stats", "gram"), **head)
        d = (score - ref).abs()
        mean = ref.abs().mean().item()
        assert torch.isfinite(score).all() and d.max().item() < 2e-2 * mean, (label, d.max().item(), mean)
        head_ms = _time_ms(lambda: fh.fused_head_tail(trunk, img_s, img_y, **head, **kw), n=5, warmup=1)
        scores[label] = score
        rows.append(f"{label}: K1 z max|err| {err:.4g}, {k1_ms:.4f} ms a launch; head with kernels vs plain "
                    f"versions max|d| {d.max().item():.3g} (mean|score| {mean:.4g}), launches {launches} a call, "
                    f"{head_ms:.4f} ms a call")
        del ref, d
    d = (scores["gram"] - scores["img_stats='xla'"]).abs().max().item()
    scale = scores["img_stats='xla'"].abs().mean().item()
    assert d < 2e-2 * scale, (d, scale)
    print(f"[23] (a) fused_head_tail options at B={B} h={h} w={w} Cin={C} Cout={cout}, bf16, exact ring: "
          + "; ".join(rows) + f"; gram against xla max|d| {d:.3g} (limit 2e-2 x mean|score| {scale:.4g})")


def slice_n_maps(torch, ex, im_u8):
    """The banded detector (packed top-k) and the banded quad and pair
    samplers on the unsharded program's own maps of the frame, split into
    2 and 4 bands on cuda:0, against the unsharded detector and samplers:
    the slate, valid_count and both samplers' descriptors bit for bit."""
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.ops.detect import generate_kpts_single
    from posfeat_tpu_torch.ops.grid_sample import sample_feat_by_coord
    from posfeat_tpu_torch.parallel import detect, sample_feat_by_coord as banded_sample, spatial_mesh
    from posfeat_tpu_torch.parallel.banded_ops import split_rows

    dev = im_u8.device
    mean, std = torch.as_tensor(IMAGENET_MEAN, device=dev), torch.as_tensor(IMAGENET_STD, device=dev)
    with torch.inference_mode():
        o = ex.model.extract((im_u8.float() / 255.0 - mean) / std)
        kp, fmap = o["local_point"], o["local_map"]
        want = generate_kpts_single(kp, topk="approx", **AACHEN_DET)
        feats = {impl: sample_feat_by_coord(fmap, want[0], True, impl) for impl in ("quad", "pair")}
        out = []
        for bands in (2, 4):
            starts = spatial_mesh([dev] * bands).plan(kp.shape[1])
            got = detect(split_rows(kp, [dev] * bands, starts), topk="approx", **AACHEN_DET)
            for g, w in zip(got, want):
                assert torch.equal(g, w), bands
            fb = split_rows(fmap, [dev] * bands, [a // 4 for a in starts])
            for impl, ref in feats.items():
                assert torch.equal(banded_sample(fb, want[0], True, impl), ref), (bands, impl)
            out.append(f"{bands} bands: slate and valid {int(want[2][0])} bit for bit, quad and pair descriptors "
                       f"bit for bit")
    return "; ".join(out)


def slice_n_bands(torch, rng):
    """(b) Phase 18's 2048x3072 frame, flagship model, Aachen detector,
    bf16, through the Extractor's programs with the card's default gates
    (lite: approx top-k, quad sampling; the 'phase' head in both
    programs): unsharded and over 2 and 4 bands on cuda:0, then
    ``fast_gates: {sample_impl: pair}`` over 2 bands against its unsharded
    run. The banded detector and the pair sampler on the unsharded maps
    are the unsharded ones bit for bit, valid_count equal
    (``slice_n_maps``). The whole banded program is the unsharded one bit
    for bit (the head's norms sum their moments row by row, the convs that
    round by the map's height run in shared row tiles), so each banded
    slate is its unsharded one: Δvalid 0, no point unmatched, keypoints,
    scores and descriptors equal; the lite and exact
    2-band slates hold the same valid_count, and the share of the lite
    one that differs from the exact gates' (phase 18's program) is
    printed with no limit; ms/image and peak memory of each run; the lite
    2-band Extractor run end to end writes its program's slate and
    records its gates."""
    frame = _frame(rng, SLICE_K_H, SLICE_K_W)
    im_u8 = torch.from_numpy(frame)[None].cuda()
    card = torch.device("cuda", 0)
    shape = frame.shape[:2]
    arms = {"lite": {}, "pair": {"fast_gates": {"sample_impl": "pair"}}, "exact": {"fast_mode": False}}
    slates, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for arm, bands_list in (("lite", (2, 4)), ("pair", (2,)), ("exact", (2,))):
            ref = None
            for bands in bands_list:
                ex = _banded_extractor(torch, tmp, f"n_{arm}_{bands}", bands, arms[arm])
                gates = ex.config["fast_gates_banded"]
                if ref is None and arm != "exact":
                    ref, ms_ref, peak_ref = _timed_slate(torch, ex._learned_fn(shape, "detector_config"), im_u8,
                                                         [card])
                    lines.append(f"{arm} unsharded: {ms_ref:.4f} ms/image, peak {peak_ref[0] / 2**30:.2f} GiB, "
                                 f"valid {ref[3]}, slate {len(ref[0])}; gates {ex.gates}")
                if arm == "lite" and bands == 2:
                    lines.append(f"lite detector and samplers on the unsharded maps: {slice_n_maps(torch, ex, im_u8)}")
                assert ex._use_spatial(shape)
                got, ms, peaks = _timed_slate(torch, ex._spatial_fn(shape, "detector_config"), im_u8, [card])
                slates[(arm, bands)] = got
                cmp = f"{slice_k_compare(got, ref, False, exact=True)}; " if ref is not None else f"valid {got[3]}; "
                lines.append(f"{arm} {bands} bands on cuda:0: {ms:.4f} ms/image"
                             + (f" ({ms / ms_ref:.3f}x unsharded)" if ref is not None else "")
                             + f", peak {peaks[0] / 2**30:.2f} GiB; {cmp}fast_gates_banded {gates}")
                if arm == "lite" and bands == 2:
                    assert gates == {"head_ring": None, "head_im2col": None, "topk": "approx", "sample_impl": "quad"}
                    ex.dataset = [_frame_item(frame, "n/frame.png")]
                    ex.extract()
                    f = np.load(f"{ex.desc_root}/n/frame.png.npz")
                    assert np.array_equal(f["keypoints"], got[0]) and np.array_equal(f["scores"][:, 0], got[1])
                    assert np.array_equal(f["descriptors"], got[2])
                    lines.append(f"lite Extractor run over 2 bands: its npz ({len(f['keypoints'])} keypoints) "
                                 f"equal to its program's slate")
                del ex
                torch.cuda.empty_cache()
    lite, exact = slates[("lite", 2)], slates[("exact", 2)]
    differs = _pair_slates(lite, exact)[0]
    for line in lines:
        print(f"[23] (b) {line}")
    print(f"[23] (b) the lite 2-band slate against the exact gates' 2-band slate (phase 18's program): valid "
          f"{lite[3]} / {exact[3]}, {differs:.6f} of it unpaired (no limit)")
    assert lite[3] == exact[3], (lite[3], exact[3])


def phase_slice_n(torch, fh, rng, smi):
    """Phase 23: slice N, the fused head's options and the fast gates on
    the banded program."""
    t_phase = time.perf_counter()
    slice_n_kernels(torch, fh, rng)
    slice_n_bands(torch, rng)
    seconds = time.perf_counter() - t_phase
    print(f"[23] slice N: {seconds:.1f} s (budget {SLICE_N_BUDGET_S:g} s); {smi}")
    assert seconds <= SLICE_N_BUDGET_S, seconds


SLICE_O_BUDGET_S = 60.0
# the head's instance norms whose row moments phase 24 (a) checks and times,
# (name, shape, dtype): the main path's trunk norm (phase 3's record); on
# phase 18's 2048x3072 frame the bf16 "phase" head's trunk, convimg,
# phase-layout and score norms and the f32 reference head's full-resolution
# one; at 480x640 the shipped f32 reference head's four (an extraction batch
# of 16) and stage 2's score norm (batch 6)
MOMENTS_NORMS = (
    ("main path trunk", (BATCH, H // 4, W // 4, 192), "bfloat16"),
    ("trunk", (1, SLICE_K_H // 4, SLICE_K_W // 4, 192), "bfloat16"),
    ("convimg", (1, SLICE_K_H, SLICE_K_W, 64), "float32"),
    ("phase", (1, SLICE_K_H // 4, SLICE_K_W // 4, 4, 4, 128), "bfloat16"),
    ("score", (1, SLICE_K_H // 4, 4 * SLICE_K_W, 1), "float32"),
    ("reference conv2", (1, SLICE_K_H, SLICE_K_W, 128), "float32"),
    ("f32 head trunk", (BATCH, H // 4, W // 4, 192), "float32"),
    ("f32 head convimg", (BATCH, H, W, 64), "float32"),
    ("f32 head conv2", (BATCH, H, W, 128), "float32"),
    ("f32 head score", (BATCH, H, W, 1), "float32"),
    ("stage-2 score", (TRAIN_BATCH, H, W, 1), "float32"),
)


def slice_o_norms(torch, rng):
    """(a) The row-moments kernel at ``MOMENTS_NORMS``' shapes, on maps
    drawn on the card from a seed: against its plain version
    (``MOMENTS_RTOL``), each row split over 2 and 4 bands bit for bit the
    whole map's partials; ms a call (CUDA events over back-to-back calls,
    host included) and a launch's device ms (a CUDA graph) beside torch's
    per-row sum pair and the bound by bytes. Then the f32 reference head
    on a batch of 16 at 480x640: its row-moments launches a batch."""
    from posfeat_tpu_torch.models import KeypointDet, init_parameters
    from posfeat_tpu_torch.ops import moments as mo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))  # 1.4e9 draws: on the card
    for name, shape, dt in MOMENTS_NORMS:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(getattr(torch, dt))
        err, ms, plain, lib, bound = moments_check(torch, x, bands=(2, 4))
        device_ms = _graph_ms(lambda: mo.row_moments(x))
        print(f"[24] (a) row moments, {name} norm {shape} {dt}, plan {tuple(mo.plan_of(x))}: max |kernel - plain| "
              f"{err:.3g} (limit {MOMENTS_RTOL:g} of each row-channel's sum of |x| or x^2: the plain version adds "
              f"in a pairwise tree, the kernel in its own order), partials over 2 and 4 bands bit for bit; "
              f"{ms:.4f} ms a call, {device_ms:.4f} ms a launch on the device (bound {bound:.4f} ms by bytes, "
              f"{bound / ms:.1%} a call, {bound / device_ms:.1%} on the device), plain {plain:.4f} ms, torch's "
              f"per-row sum pair {lib:.4f} ms ({lib / ms:.2f}x the call)")
        del x
        torch.cuda.empty_cache()
    head = KeypointDet(in_channels=192, out_channels=1, prior="identity", act="Softplus", fused_upsample=False)
    init_parameters(head, torch.Generator().manual_seed(SEED))
    head = head.to(dev)
    fm = torch.randn((BATCH, H // 4, W // 4, 192), generator=g, device=dev)
    img = torch.randn((BATCH, H, W, 3), generator=g, device=dev)
    with torch.inference_mode():
        mo.row_moments.launches = 0
        score = head(fm, img)
        launches = mo.row_moments.launches
    assert torch.isfinite(score).all() and launches == 4, launches
    print(f"[24] (a) the f32 reference head on a batch of {BATCH} at {H}x{W}: {launches} row-moments launches")
    del head, fm, img, score
    torch.cuda.empty_cache()


def slice_o_maps(torch, rng):
    """(b) Phase 18's frame through the flagship bf16 "phase" model,
    unsharded and banded over 2 and 4 bands on cuda:0 (``spatial_extract``
    without a postprocess): local_map, the score map and global_map
    torch.equal the unsharded ones; the row-moments kernel launched on the
    banded path."""
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.ops.moments import row_moments
    from posfeat_tpu_torch.parallel import spatial_extract, spatial_mesh

    card = torch.device("cuda", 0)
    frame = _frame(rng, SLICE_K_H, SLICE_K_W)
    mean, std = torch.as_tensor(IMAGENET_MEAN, device=card), torch.as_tensor(IMAGENET_STD, device=card)
    im = (torch.from_numpy(frame)[None].to(card).float() / 255.0 - mean) / std
    cfg = copy.deepcopy(FLAGSHIP_MODEL_CONFIG)
    cfg["localheader_config"]["fused_upsample"] = "phase"
    model = PoSFeat(cfg, dtype=torch.bfloat16, device=card, seed=SEED)
    with torch.inference_mode():
        want = model.extract(im)
        lines = []
        for k in (2, 4):
            mesh = spatial_mesh([card] * k)
            row_moments.launches = 0
            got = spatial_extract(model, mesh)(im)
            launches = row_moments.launches
            assert launches == 4 * k, launches  # four norms a band
            for key in ("local_map", "local_point", "global_map"):
                assert torch.equal(got[key].concat(), want[key]), (k, key)
            lines.append(f"{k} bands (first rows {mesh.plan(SLICE_K_H)}): local_map, score map and global_map "
                         f"equal, row moments {launches} launches")
    print(f"[24] (b) {SLICE_K_H}x{SLICE_K_W} bf16 'phase' maps, banded against unsharded: " + "; ".join(lines))
    del model, want, got
    torch.cuda.empty_cache()


def phase_slice_o(torch, rng, smi):
    """Phase 24: slice O, the banded program bit for bit the unsharded
    one (phases 18, 19 and 23 (b) hold its slates)."""
    t_phase = time.perf_counter()
    slice_o_norms(torch, rng)
    slice_o_maps(torch, rng)
    seconds = time.perf_counter() - t_phase
    print(f"[24] slice O: {seconds:.1f} s (budget {SLICE_O_BUDGET_S:g} s); {smi}")
    assert seconds <= SLICE_O_BUDGET_S, seconds


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
    main_k2 = ("head_tail_kernel<16,1>", "head_tail_kernel<f32,16,1>")  # the main paths' instances
    for kname, props in summary.items():
        if kname in CONV_KERNELS:
            # the launch's dynamic shared memory at the flagship point (C = KP = 192)
            props["dynamic_smem"] = lib.posfeat_conv_smem_bytes(192, 192 if kname == "conv_phase_kernel" else 0)
        if kname not in k2 or kname in main_k2:
            print(f"[2]   {kname}: {props}")
    # 24 instances over (Cout / 8, out_ch) for each z dtype, bf16 and f32
    assert len(k2) == 48, sorted(k2)
    for dt, group in (("bf16", [v for k, v in k2.items() if "f32" not in k]),
                      ("f32", [v for k, v in k2.items() if "f32" in k])):
        print(f"[2]   head_tail_kernel, all {len(group)} {dt} instances: registers "
              f"{min(v['regs'] for v in group)}-{max(v['regs'] for v in group)}, stack "
              f"{max(v['stack'] for v in group)} B, spills {sum(v['spill_stores'] + v['spill_loads'] for v in group)} B")
    for kname in (*CONV_KERNELS, *F32_CONV_KERNELS, *F32_SPLIT_KERNELS, *k2, *REDUCTION_KERNELS, *MOMENTS_KERNELS):
        props = summary[kname]
        assert props["spill_stores"] == props["spill_loads"] == 0, (kname, props)
        if kname not in CONV_KERNELS:
            assert props["stack"] == 0, (kname, props)
    # a warpgroup.wait that ptxas injects (C7517, before a read of registers
    # a wgmma defines) serializes the wgmmas of product_tiles and
    # stream_product, the loops the reduction passes run, and of the f32
    # conv kernels, which run the same steps; their first wgmmas of a tile
    # write the accumulators without reading them, and the build has none
    for kname, which in (("lse_pass_kernel", "f1 resident"), ("reward_pass_kernel", "f1 resident"),
                         ("lse_pass_streamed_kernel", "f1 streamed"), ("reward_pass_streamed_kernel", "f1 streamed"),
                         ("conv_phase_f32_kernel", "all four")):
        injected = [x for x in info["log"].splitlines() if "C7517" in x and kname in x]
        print(f"[2]   {kname} ({which}): {len(injected)} warpgroup.wait injected by ptxas (C7517)")
        assert not injected, injected
    # ptxas serializing the wgmmas outright (C7514, C7518: a non-wgmma read
    # of accumulators in flight, or a wait on a divergent path) made the
    # streamed passes 2.5-3x slower while they were built; the build has none
    serialized = [x for x in info["log"].splitlines()
                  if ("C7514" in x or "C7518" in x) and ("lse_pass" in x or "reward_pass" in x)]
    print(f"[2]   lse and reward passes: {len(serialized)} wgmma serializations reported by ptxas (C7514, C7518)")
    assert not serialized, serialized

    rng = np.random.default_rng(SEED)
    # phase 6's reward-pass draw of the former compare order, replayed on a
    # host thread (numpy fills without the GIL) while phases 3-5 run
    with ThreadPoolExecutor(1) as pool:
        former = pool.submit(former_order_stream)
        records = phase_kernels(torch, fh, rng)
        phase_head_vs_reference(torch, rng)
        ims_main = phase_main_path(torch, fh, rng, records)
        extra = [("former compare order", former.result())]
    extra += [(f"seed {SEED + k}", np.random.default_rng(SEED + k)) for k in (1, 2, 3)]
    reduction = phase_reduction(torch, rng, extra)
    s_step_main = phase_training(torch, reduction)
    v1 = phase_v1_kernels(torch, fh, rng)
    phase_head_vs_reference(torch, rng, mode="v1", tag="[9]")
    phase_v1_path(torch, fh, rng, v1)
    phase_head_bench(torch, fh, v1)
    phase_stage1(torch, smi)
    probe_state = phase_probe(torch, smi)
    try:
        phase_shipped(torch, fh, smi)
        phase_slice_f(torch, fh, rng, smi, probe_state)
        phase_slice_g(torch, rng, smi, ims_main, s_step_main)
        slice_h = phase_slice_h(torch, fh, rng, smi)
        phase_slice_k(torch, fh, rng, smi)
        phase_slice_l(torch, fh, rng, smi, s_step_main)
        phase_slice_m(torch, fh, rng, smi, probe_state, ims_main)
        phase_slice_n(torch, fh, rng, smi)
        phase_slice_o(torch, rng, smi)
    finally:
        shutil.rmtree(probe_state["work"], ignore_errors=True)
    records += v1 + reduction + slice_h

    print(f"[total] chip_smoke.py: {time.perf_counter() - t_start:.1f} s, build included")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
