#!/usr/bin/env python3
"""Time the kernels and the end-to-end paths of two checkouts of this
repository on one CUDA card, in turns A, B, B, A (``--rounds`` times),
so that a change is compared with its parent on the same card and under
the same conditions, and the host-bound end-to-end numbers get enough
turns to show their spread.

    python3 tools/compare_torch_trees.py PARENT_DIR CHANGE_DIR [--rounds N] [--frame | --moments]

Each turn is a process of its own, started in that checkout: it builds
the checkout's kernels and runs its chip_smoke.py phases in the order
and on the random stream of ``chip_smoke.main`` (so that each check sees
the inputs it sees there): phase_kernels (K1, K2 at B=16, 480x640),
phase_head_vs_reference, phase_main_path (v3 extraction im/s),
phase_reduction (the lse and reward passes at B=6, m=n=4800),
phase_training (stage-2 s/step), phase_v1_kernels (K3, T1, T2), the v1
head against the reference, phase_v1_path (v1 extraction im/s),
phase_stage1 (stage-1 s/step), phase 17 (a)'s slice_h_kernels (the f32
instances of K1, K3 (with T1, T2, printed) and K2, at B=16, 480x640;
each tree's own f32 body), phase 17 (d)'s slice_h_reduction (the lse and
reward passes at D = 256 and 200, f1 streamed; the D = 256 ones timed)
and phase 17 (e) (stage 2 at ``fine_out_ch: 256``, s/step). The kernel
phases check every kernel
against its plain version and time it with CUDA events (ms per launch);
the end-to-end numbers are read from the lines the phases print.

With ``--frame`` a turn times these instead, with nothing but what
both trees have: the unsharded bf16 extraction program of chip_smoke.py
phase 23 (b) (a seeded 2048x3072 frame, the flagship model, the Aachen
detector, the card's lite gates, the "phase" head), ms/image over 5
runs after a warm-up and its peak memory, the same for a 1200x1600
frame (HPatches and ETH images are of this order: below
``spatial_threshold_px``, so never banded, and three 512-row conv tiles
tall); and the flagship bf16 head's
device time per call on a batch of 16 480x640 images (the main path's
fused head, the backbone's maps made once), the sum of its kernels'
durations in a torch.profiler window of 10 calls after 3, and its CUDA
event ms per call.

With ``--moments`` a turn times the row-moments kernel instead, through
the checkout's own ``chip_smoke.moments_check``, at every shape of this
tree's ``chip_smoke.MOMENTS_NORMS`` (the main path's trunk norm, the
head's norms on a 2048x3072 frame, the shipped f32 head's at 480x640,
stage 2's score norm), on maps drawn on the card from a seed: ms a call
(CUDA events over back-to-back calls, host included), the kernel's own
duration in a torch.profiler trace of 10 calls, torch's per-row sum pair
and the bound by bytes; each checkout's check also holds its kernel to
its plain version and its partials over 2 and 4 row splits to the whole
map's.

Prints one JSON line per turn, then
nvidia-smi's name and power limit, and a last JSON line
{"results": {name: {"A": [x, x], "B": [x, x]}}}. Without a CUDA card it
exits 2 and prints no result.
"""

import argparse
import json
import os
import re
import subprocess
import sys

TURN = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import fused_head as fh
resolve_device("cuda")
rng = np.random.default_rng(chip_smoke.SEED)
head = chip_smoke.phase_kernels(torch, fh, rng)
chip_smoke.phase_head_vs_reference(torch, rng)
chip_smoke.phase_main_path(torch, fh, rng, head)
reduction = chip_smoke.phase_reduction(torch, rng)
chip_smoke.phase_training(torch, reduction)
v1 = chip_smoke.phase_v1_kernels(torch, fh, rng)
chip_smoke.phase_head_vs_reference(torch, rng, mode="v1", tag="[9]")
chip_smoke.phase_v1_path(torch, fh, rng, v1)
chip_smoke.phase_stage1(torch, "")
f32 = chip_smoke.slice_h_kernels(torch, fh, rng)
wide = chip_smoke.slice_h_reduction(torch, rng)
chip_smoke.phase_training(torch, wide, fine_out_ch=256, tag="[17] (e)", suffix=" D=256")
print("TURN " + json.dumps({r["name"]: r["ms"] for r in head + v1 + reduction + f32 + wide}), flush=True)
"""
TURN_FRAME = r"""
import json, sys, tempfile
MID = (1200, 1600)
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as c
from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import _build
resolve_device("cuda")
_build.build()
card = torch.device("cuda", 0)
rng = np.random.default_rng(c.SEED)
frame = c._frame(rng, c.SLICE_K_H, c.SLICE_K_W)
im_u8 = torch.from_numpy(frame)[None].to(card)
out = {}
with tempfile.TemporaryDirectory() as tmp:
    ex = c._banded_extractor(torch, tmp, "frame", 2, {})
    _, out["frame ms/image"], peak = c._timed_slate(torch, ex._learned_fn(frame.shape[:2], "detector_config"),
                                                    im_u8, [card], reps=5)
    out["frame peak GiB"] = peak[0] / 2**30
    # an image below spatial_threshold_px of three row tiles (512, 512 and
    # 176 rows), which never runs banded
    mid = c._frame(np.random.default_rng(c.SEED + 1), *MID)
    _, out["mid ms/image"], peak = c._timed_slate(torch, ex._learned_fn(mid.shape[:2], "detector_config"),
                                                  torch.from_numpy(mid)[None].to(card), [card], reps=5)
    out["mid peak GiB"] = peak[0] / 2**30
    del ex
    torch.cuda.empty_cache()
    model = c.flagship_extractor(tmp, rng, output_root="head").model
    im = torch.randn(c.BATCH, c.H, c.W, 3, device=card)
    with torch.inference_mode():
        fm = model.backbone(im)
        x = torch.cat([fm[e] for e in model.local_input_elements], dim=-1)
        head = lambda: model.localheader(x, im)
        out["head ms/batch (events)"] = c._time_ms(head, n=10, warmup=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                head()
            torch.cuda.synchronize()
    prof.export_chrome_trace(f"{tmp}/trace.json")
    with open(f"{tmp}/trace.json") as f:
        kernels = [e["dur"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel" and "dur" in e]
    assert kernels, "the trace holds no device kernels"
    out["head device ms/batch"] = sum(kernels) / 10 / 1e3
print("TURN " + json.dumps(out), flush=True)
"""
TURN_MOMENTS = r"""
import json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as c
from posfeat_tpu_torch import resolve_device
from posfeat_tpu_torch.ops import _build
from posfeat_tpu_torch.ops import moments as mo
resolve_device("cuda")
_build.build()


def kernel_ms(fn, n=10):  # chip_smoke._kernel_ms, which a parent checkout may lack
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            durs = [e["dur"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel" and "row_moments" in e.get("name", "")]
    assert durs, "the trace holds no row-moments kernel"
    return sum(durs) / len(durs) / 1e3  # a trace may miss the window's first launch


g = torch.Generator(device="cuda").manual_seed(c.SEED)
out = {}
for name, shape, dt in json.loads(sys.argv[1]):
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(getattr(torch, dt))
    err, ms, plain, lib, bound = c.moments_check(torch, x, bands=(2, 4))
    out[name + " ms"] = ms
    out[name + " kernel ms"] = kernel_ms(lambda: mo.row_moments(x))
    out[name + " torch pair ms"] = lib
    out[name + " bound ms"] = bound
    del x
    torch.cuda.empty_cache()
print("TURN " + json.dumps(out), flush=True)
"""
# the end-to-end metrics, read from the lines that the phases print
E2E = {
    "v3 extraction im/s": r"^\[5\] main path: .*?: ([0-9.]+) im/s",
    "v1 extraction im/s": r"^\[10\] v1 path: .*?: ([0-9.]+) im/s",
    "stage-2 s/step": r"^\[7\] training: .*? then ([0-9.]+) s/step",
    "stage-1 s/step": r"^\[12\] stage-1 training: .*? then ([0-9.]+) s/step",
    "stage-2 D=256 s/step": r"^\[17\] \(e\) training: .*? then ([0-9.]+) s/step",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="root of the parent's checkout (A)")
    ap.add_argument("change", help="root of the change's checkout (B)")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of turns A, B, B, A")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--frame", action="store_true",
                      help="time the unsharded 2048x3072 bf16 program and the 480x640 head instead")
    mode.add_argument("--moments", action="store_true",
                      help="time the row-moments kernel at the head's norms' shapes instead")
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.parent), "B": os.path.abspath(args.change)}
    cmd = [sys.executable, "-c", TURN]
    if args.frame:
        cmd = [sys.executable, "-c", TURN_FRAME]
    elif args.moments:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import chip_smoke as c

        cmd = [sys.executable, "-c", TURN_MOMENTS, json.dumps(c.MOMENTS_NORMS)]
    results = {}
    for label in ("A", "B", "B", "A") * args.rounds:
        res = subprocess.run(cmd, cwd=trees[label], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        turn = json.loads(next(x for x in res.stdout.splitlines() if x.startswith("TURN "))[5:])
        for name, pattern in () if args.frame or args.moments else E2E.items():
            turn[name] = float(re.search(pattern, res.stdout, re.M).group(1))
        print(json.dumps({"tree": label, "path": trees[label], "results": turn}), flush=True)
        for name, t in turn.items():
            results.setdefault(name, {"A": [], "B": []})[label].append(t)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
