#!/usr/bin/env python3
"""Where the time goes in the unsharded extraction of one large frame, on
one CUDA card.

    python3 tools/profile_torch_frame.py [--height 3024 --width 4032] [--dtype float32|bfloat16] [--top 12]

The device program of chip_smoke.py phases 18-19 (``slice_k_program``:
the flagship model with random weights from seed 0, the Aachen detector,
one seeded frame; f32 with the reference dataflow, bf16 with the "phase"
head), after a warm-up run, once under torch.profiler: the run's time
by CUDA events, the device time of the top kernels and of every kernel
together, and the top operators by their own device time. Prints the
card's name and power limit last.
"""

import argparse
import copy
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=3024)
    ap.add_argument("--width", type=int, default=4032)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.models import PoSFeat

    resolve_device("cuda")
    card = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    cfg = copy.deepcopy(c.FLAGSHIP_MODEL_CONFIG)
    cfg["localheader_config"]["fused_upsample"] = "phase" if dtype == torch.bfloat16 else False
    model = PoSFeat(cfg, dtype=dtype, device=card, seed=c.SEED)
    im_u8 = torch.from_numpy(c._frame(np.random.default_rng(c.SEED), args.height, args.width))[None].to(card)
    run = c.slice_k_program(torch, model, None)
    run(im_u8)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0.record()
        run(im_u8)
        t1.record()
        torch.cuda.synchronize()
    label = f"{args.height}x{args.width} {args.dtype} {'phase' if dtype == torch.bfloat16 else 'reference'}"
    print(f"{label}: {t0.elapsed_time(t1):.4f} ms by CUDA events, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + getattr(ev, "device_time", 0.0) / 1e3
    total = sum(kernels.values())
    print(f"{label}: every kernel {total:.4f} ms of device time, {len(kernels)} kernels")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  kernel {ms:10.4f} ms  {name[:160]}")
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  op {e.self_device_time_total / 1e3:10.4f} ms self device, {e.count} calls  {e.key[:120]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
