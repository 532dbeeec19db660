#!/usr/bin/env python3
"""Where the time goes in posfeat_tpu_torch's training, on one CUDA card.

    python3 tools/profile_torch_train.py [--stage 1|2] [--probe] [--steps 5] [--trace PATH]

Builds chip_smoke.py's training setup of the stage: 2 (the default),
``chip_smoke.train_config`` (configs/train_kp.yaml with the flagship
model in f32, SyntheticPairs at 480x640, batch 6 pairs); 1,
``chip_smoke.desc_config`` (configs/train_desc.yaml, the same model and
data, batch 8 pairs). ``--probe`` takes the ΔMMA probe's training
instead (tools/selection_stability_torch.py ``train_config``: the
head192 model, SyntheticPairs at 96x128, batch 4 pairs; stage 2 from
random weights). It measures:
  1. the input pipeline alone: seconds per batch of the PrefetchLoader
     and of one sample built on the calling thread;
  2. the step alone: ``Trainer.train_step`` on batches already on the
     card, host clock around synchronized steps; and the head's forward
     alone on one view's maps (CUDA events), which a stage-1 step runs
     twice though its loss reads no score map;
  3. ``Trainer.train`` (a warm-up step, then ``--steps`` steps, loader
     included) under torch.profiler: the device's busy and idle share of
     the window, device time by kernel class (cuDNN's convolutions apart
     from cuBLAS's matmuls, which in stage 1 are mostly the
     correspondence engine's correlations) and the top kernels.
``--trace`` keeps the Chrome trace at PATH.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import DESC_BATCH, TRAIN_BATCH, desc_config, train_config  # noqa: E402
from profile_torch_extract import _busy_us  # noqa: E402

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("K4-K6 split (shared by both passes)", ("lse_split_kernel",)),
    ("K4+K5 lse_pass", ("lse_pass_kernel",)),
    ("K6 reward_pass", ("reward_pass_kernel",)),
    # cuDNN's FFT convolutions run complex GEMMs (cf32) and pointwise complex products
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "cudnn", "cf32",
                      "complex")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90", "sm80")),
    ("batch/instance norm", ("batch_norm", "bn_", "norm")),
    ("upsample / grid_sample", ("upsample", "grid_sampler")),
    ("reduce", ("reduce",)),
    ("copy / cat / pad / index", ("copy", "cat", "pad", "unfold", "im2col", "col2im", "index", "gather",
                                  "scatter")),
)


def _class(name):
    low = name.lower()
    for label, frags in CLASSES:
        if any(f in low for f in frags):
            return label
    return "elementwise / other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.train import Trainer

    p = argparse.ArgumentParser()
    p.add_argument("--stage", type=int, choices=(1, 2), default=2)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None, help="keep the Chrome trace here")
    p.add_argument("--probe", action="store_true", help="the ΔMMA probe's training (96x128, batch 4)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.probe:
        from selection_stability_torch import train_config as probe_config

        cfg = probe_config(None, "desc" if args.stage == 1 else "kp", args.steps)
        batch_size = cfg["data_config_train"]["batch_size"]
    else:
        cfg, batch_size = (desc_config(), DESC_BATCH) if args.stage == 1 else (train_config(), TRAIN_BATCH)
    print(f"stage {args.stage}{' (probe)' if args.probe else ''}: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp)
        ds = tr.train_dataset

        # 1. the input pipeline alone
        t0 = time.perf_counter()
        ds[0]
        one = time.perf_counter() - t0
        it = iter(tr.train_loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            next(it)
        loader_s = (time.perf_counter() - t0) / args.steps
        it.close()
        print(f"input: one sample {one:.4f} s on the calling thread; PrefetchLoader "
              f"{loader_s:.4f} s per batch of {batch_size} ({cfg['data_config_train']['workers']} threads)")

        # 2. the step alone, batches already on the card
        batches = [tr.to_device(collate([ds[i + batch_size * k] for i in range(batch_size)]))
                   for k in range(2)]
        tr.train_step(batches[0], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(args.steps):
            tr.train_step(batches[k % 2], 1)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / args.steps
        print(f"step without the loader: {step_s:.4f} s ({batch_size / step_s:.3f} pairs/s), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        model, im = tr.model, batches[0]["im1"]
        with torch.no_grad():
            feats = model.backbone(im)
            local_input = torch.cat([feats[n] for n in model.local_input_elements], dim=-1)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            model.localheader(local_input, im)
            e0.record()
            for _ in range(args.steps):
                model.localheader(local_input, im)
            e1.record()
            torch.cuda.synchronize()
        head_ms = e0.elapsed_time(e1) / args.steps
        print(f"head forward alone, one view of {batch_size} images: {head_ms:.3f} ms "
              f"(two per step: {2 * head_ms / (step_s * 1e3):.1%} of the step)")

    # 3. Trainer.train under the profiler
    cfg["epoch_step"] = args.steps + 1
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        steps = [json.loads(x) for x in open(os.path.join(tr.save_root, "step_times.jsonl"))]
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device kernels")
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_class[_class(e["name"])] += e["dur"]
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    total = sum(by_class.values())
    n = len(steps)
    print(f"device: {torch.cuda.get_device_name(0)}; Trainer.train, {n} steps (1 warm-up), window "
          f"{wall_us / 1e3:.3f} ms (host clock, checkpoints included); step times "
          f"{[round(s['step_time_s'], 4) for s in steps]}")
    print(f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% of the window; "
          f"idle {100 * (1 - busy / wall_us):.1f}%; kernel time {total / 1e3:.3f} ms in {len(kernels)} launches "
          f"({len(kernels) / n:.0f} per step)")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  {us / n / 1e3:.4f} ms/step")
    print("top kernels:")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms {cnt:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
