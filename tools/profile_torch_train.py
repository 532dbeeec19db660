#!/usr/bin/env python3
"""Where the time goes in posfeat_tpu_torch's stage-2 training, on one CUDA card.

    python3 tools/profile_torch_train.py [--steps 5] [--trace PATH]

Builds chip_smoke.py's training setup (``chip_smoke.train_config``:
configs/train_kp.yaml with the flagship model in f32, SyntheticPairs at
480x640, batch 6 pairs) and measures three things:
  1. the input pipeline alone: seconds per batch of the PrefetchLoader
     (6 worker threads) and of one sample built on the calling thread;
  2. the step alone: ``Trainer.train_step`` on batches already on the
     card, host clock around synchronized steps;
  3. ``Trainer.train`` (a warm-up step, then ``--steps`` steps, loader
     included) under torch.profiler: the device's busy and idle share of
     the window, device time by kernel class and the top kernels.
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

from chip_smoke import TRAIN_BATCH, train_config  # noqa: E402
from profile_torch_extract import _busy_us  # noqa: E402

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("K4-K6 split (shared by both passes)", ("lse_split_kernel",)),
    ("K4+K5 lse_pass", ("lse_pass_kernel",)),
    ("K6 reward_pass", ("reward_pass_kernel",)),
    ("conv / gemm (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "sm90", "sm80", "implicit",
                                     "wgrad", "dgrad")),
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
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None, help="keep the Chrome trace here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = train_config()
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
              f"{loader_s:.4f} s per batch of {TRAIN_BATCH} ({cfg['data_config_train']['workers']} threads)")

        # 2. the step alone, batches already on the card
        batches = [tr.to_device(collate([ds[i + TRAIN_BATCH * k] for i in range(TRAIN_BATCH)]))
                   for k in range(2)]
        tr.train_step(batches[0], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(args.steps):
            tr.train_step(batches[k % 2], 1)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / args.steps
        print(f"step without the loader: {step_s:.4f} s ({TRAIN_BATCH / step_s:.3f} pairs/s), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

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
