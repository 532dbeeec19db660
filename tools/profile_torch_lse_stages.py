#!/usr/bin/env python3
"""Split the time of posfeat_tpu_torch's two reduction passes, the lse
pass (K4+K5, lse_pass_kernel) and the reward pass (K6,
reward_pass_kernel), both in csrc/reinforce.cu, into their stages on one
CUDA card, by timing copies of the source with a stage cut out, at the
training path's shapes (B=6, m=n=4800, T=60; chip_smoke.py's
reduction_problem) and descriptor width D: up to 128 the instances that
keep f1 resident, beyond it the ones that stream it (their names hold
"streamed").

    python3 tools/profile_torch_lse_stages.py [--D 128]

Builds, each from a copy of csrc/reinforce.cu:
  full      the source as it is;
  no_epi    both passes' epilogues (each between its "epilogue begin" and
            "epilogue end" comments) replaced by a sum of the accumulators
            and a store that the compiler cannot drop: the wgmmas, their
            adds and the staging;
  no_stage  the staging (between "staging begin" and "staging end": the
            f2 ring's bulk copies and the waits for them, and the reward
            pass's column operands' copies and waits) removed as well: the
            wgmmas and their adds on a ring that is never refilled.
The copies' outputs are wrong and are never read. Each pass is timed
through its wrapper on one split of f1 and f2 (the kernels alone, as
``reinforce_reduction`` runs them) with chip_smoke.py's timer (CUDA events
around 20 launches after 3) in the order full, no_epi, no_stage, then once
more in reverse. Prints ptxas' registers and spills per build for the instances that
run at D (and fails where a build has fewer registers than the product
needs: its wgmmas were dropped) and a last JSON line
{"D": D, "ms": {pass: {build: [ms, ms]}}, "device": ..., "power_limit": ...}.
Without a CUDA card it exits 2 and prints no result.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import REDUCTION_KW, SEED, _ptxas_summary, _time_ms, reduction_problem  # noqa: E402

BUILDS = ("full", "no_epi", "no_stage")
PASSES = ("lse_pass", "reward_pass")
# the product's accumulators hold 192 registers: a resident instance (up to
# 255 a thread) must report at least that many; a streamed instance
# reports its launch's 168, which setmaxnreg hands on to the consumers
MIN_REGS = {False: 192, True: 168}
KEEP_ALIVE = """    {  // keeps the accumulators alive: a use the compiler cannot drop
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) x += acc[i];
      if (x == 12345.f) smem[0] = x;
    }
"""


def cut(src: str, stage: str, keep: str = "") -> str:
    """``src`` with every region from a "// {stage} begin" comment's line
    to its "// {stage} end" comment's line replaced by ``keep``."""
    pattern = re.compile(rf"^[ \t]*// {stage} begin.*?^(?=[ \t]*// {stage} end)", re.S | re.M)
    out, n = pattern.subn(lambda _: keep, src)
    assert n, f"no {stage} region"
    return out


def variant(src: str, build: str) -> str:
    """The source with ``build``'s stages cut out."""
    if build in ("no_epi", "no_stage"):
        src = cut(src, "epilogue", KEEP_ALIVE)
    if build == "no_stage":
        src = cut(src, "staging")
    return src


def instance(summary, name, streamed):
    """The ptxas summary's key of pass ``name``'s instance at a width that
    keeps f1 resident (``streamed`` False) or streams it."""
    keys = [k for k in summary if k.startswith(name) and ("streamed" in k) == streamed]
    assert len(keys) == 1, (name, streamed, sorted(summary))
    return keys[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--D", type=int, default=128, help="descriptor width")
    D = ap.parse_args().D
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import reinforce as rf

    resolve_device("cuda")
    streamed = not rf.f1_resident(D)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {}
    for name, (so, log) in _build.build_variants(
            "reinforce.cu", BUILDS, variant, os.path.join(ROOT, "build", "torch_kernels", "lse_stages")).items():
        summary = _ptxas_summary(log)
        for p in PASSES:
            k = instance(summary, p, streamed)
            print(f"{name}: {k} {summary[k]['regs']} regs, stack {summary[k]['stack']} B, spills "
                  f"{summary[k]['spill_stores']}/{summary[k]['spill_loads']} B")
            # the product's three 64-float accumulator sets live in registers:
            # a build with fewer has lost its wgmmas to dead-code elimination
            assert summary[k]["regs"] >= MIN_REGS[streamed], (name, k, summary[k])
        libs[name] = _build.bind(ctypes.CDLL(so))

    args = reduction_problem(torch, np.random.default_rng(SEED), D=D)
    f1, f2 = args[:2]
    kw, T = REDUCTION_KW, REDUCTION_KW["temperature"]
    tiles = rf._split_operands(f1, f2)
    rl, cl = rf.lse_pass_plain(f1, f2, T)
    passes = {
        "lse_pass": lambda: rf.lse_pass(f1, f2, T, tiles=tiles),
        "reward_pass": lambda: rf.reward_pass(*args, rl, cl, **kw, tiles=tiles),
    }
    ms = {p: {} for p in passes}
    for order in (BUILDS, BUILDS[::-1]):
        for name in order:
            _build.load_kernels = lambda lib=libs[name]: lib  # the wrappers load their library per call
            for p, fn in passes.items():
                ms[p].setdefault(name, []).append(_time_ms(fn))
    B = f1.shape[0]
    for p in passes:
        for name in BUILDS:
            print(f"{p} {name}: {' / '.join(f'{t:.4f}' for t in ms[p][name])} ms per B={B} D={D} launch")
    print(smi)
    print(json.dumps({"D": D, "ms": ms, "device": torch.cuda.get_device_name(0), "power_limit": smi.split(", ")[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
