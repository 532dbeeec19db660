#!/usr/bin/env python3
"""Time the kernels and the end-to-end paths of two checkouts of this
repository on one CUDA card, in turns A, B, B, A, so that a change is
compared with its parent on the same card and under the same conditions.

    python3 tools/compare_torch_trees.py PARENT_DIR CHANGE_DIR

Each turn is a process of its own, started in that checkout: it builds
the checkout's kernels and runs its chip_smoke.py phases in the order
and on the random stream of ``chip_smoke.main`` (so that each check sees
the inputs it sees there): phase_kernels (K1, K2 at B=16, 480x640),
phase_head_vs_reference, phase_main_path (v3 extraction im/s),
phase_reduction (the lse and reward passes at B=6, m=n=4800),
phase_training (stage-2 s/step), phase_v1_kernels (K3, T1, T2), the v1
head against the reference, phase_v1_path (v1 extraction im/s) and
phase_stage1 (stage-1 s/step). The kernel phases check every kernel
against its plain version and time it with CUDA events (ms per launch);
the end-to-end numbers are read from the lines the phases print. Prints one JSON line per turn, then
nvidia-smi's name and power limit, and a last JSON line
{"results": {name: {"A": [x, x], "B": [x, x]}}}. Without a CUDA card it
exits 2 and prints no result.
"""

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
print("TURN " + json.dumps({r["name"]: r["ms"] for r in head + v1 + reduction}), flush=True)
"""
# the end-to-end metrics, read from the lines that the phases print
E2E = {
    "v3 extraction im/s": r"^\[5\] main path: .*?: ([0-9.]+) im/s",
    "v1 extraction im/s": r"^\[10\] v1 path: .*?: ([0-9.]+) im/s",
    "stage-2 s/step": r"^\[7\] training: .*? then ([0-9.]+) s/step",
    "stage-1 s/step": r"^\[12\] stage-1 training: .*? then ([0-9.]+) s/step",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    trees = {"A": os.path.abspath(sys.argv[1]), "B": os.path.abspath(sys.argv[2])}
    results = {}
    for label in ("A", "B", "B", "A"):
        res = subprocess.run([sys.executable, "-c", TURN], cwd=trees[label], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        turn = json.loads(next(x for x in res.stdout.splitlines() if x.startswith("TURN "))[5:])
        for name, pattern in E2E.items():
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
