#!/usr/bin/env python3
"""Where the time goes in posfeat_tpu_torch's extraction, on one CUDA card.

    python3 tools/profile_torch_extract.py [--batches 8] [--trace PATH]

Runs chip_smoke.py's main path (``chip_smoke.flagship_extractor``:
flagship model, bf16, 480x640, batch 16, 8192 points, fused head, after
a warm-up batch) with torch.profiler around ``Extractor.extract``. From the Kineto trace it prints the device time
of every kernel class, the device's busy and idle share of the window
(host clock), and the top kernels by time. ``--trace`` keeps the
Chrome trace at PATH.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BATCH, SEED, _images, flagship_extractor  # noqa: E402

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("K1 conv_phase", ("conv_phase_kernel",)),
    ("K2 head_tail", ("head_tail_kernel",)),
    ("conv / gemm (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "sm90", "sm80", "implicit")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("grid_sample", ("grid_sampler",)),
    ("batch/instance norm", ("batch_norm", "bn_", "norm")),
    ("reduce", ("reduce",)),
    ("copy / cat / pad", ("copy", "cat", "pad", "unfold", "im2col", "col2im")),
)


def _class(name):
    low = name.lower()
    for label, frags in CLASSES:
        if any(f in low for f in frags):
            return label
    return "elementwise / other"


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--trace", default=None, help="keep the Chrome trace here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(SEED)
    data = _images(rng, BATCH * args.batches, "main")
    with tempfile.TemporaryDirectory() as tmp:
        ex = flagship_extractor(tmp, rng, output_root="profile")
        ex.dataset = data
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n, _ = ex.extract()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
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
    print(f"device: {torch.cuda.get_device_name(0)}; {n} images, batch {BATCH}, window {wall_us / 1e3:.3f} ms "
          f"(host clock, {n / wall_us * 1e6:.2f} im/s under the profiler)")
    print(f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% of the window; "
          f"idle {100 * (1 - busy / wall_us):.1f}%; kernel time {total / 1e3:.3f} ms in {len(kernels)} launches")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  {us / n / 1e3:.4f} ms/image")
    print("top kernels:")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms {cnt:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
