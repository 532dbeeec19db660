#!/usr/bin/env python3
"""The REINFORCE reduction's kernels of two trees on one card, in turns.

    python3 tools/compare_torch_reduction.py PARENT_DIR [--D 128] [--turns 3]

PARENT_DIR holds another checkout (e.g. ``git archive <rev> | tar -x -C
.work/parent``). Both trees' kernel libraries are built (each into its own
``build/torch_kernels/``); then, at chip_smoke.py's reduction problem
(B=6, m=n=4800, T=60) and width D, each turn runs this tree's wrappers on
the parent's library and on this tree's (parent, change, change, parent,
...), timing the lse and reward passes with CUDA events (50 launches
after warm-up). Prints each turn's ms, whether the two libraries' split,
row and column log-sum-exps and reward outputs are equal bit for bit, and
nvidia-smi's name and power limit. Needs a CUDA card; both trees must
share the reduction's C interface and partials layout (posfeat_lse_pass
and posfeat_reward_pass took their column ranges, ``splits``, and wrote
row partials beyond D = 128 from the warp-specialised streamed
instances on: a tree from before them does not compare with one after).
"""

import argparse
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from chip_smoke import REDUCTION_KW, SEED, _time_ms, reduction_problem  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="root of the other checkout")
    ap.add_argument("--D", type=int, default=128, help="descriptor width")
    ap.add_argument("--turns", type=int, default=3, help="pairs of (parent, change) or (change, parent)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import reinforce as rf

    resolve_device("cuda")
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(args.parent, "posfeat_tpu_torch", "ops", "_build.py"))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    libs = {"parent": parent_build.load_kernels(), "change": _build.load_kernels()}

    prob = reduction_problem(torch, np.random.default_rng(SEED), D=args.D)
    f1, f2 = prob[:2]
    kw, T = REDUCTION_KW, REDUCTION_KW["temperature"]
    outs, times = {}, {"parent": [], "change": []}
    order = []
    for turn in range(args.turns):
        order += ["parent", "change"] if turn % 2 == 0 else ["change", "parent"]
    for name in order:
        _build.load_kernels = lambda lib=libs[name]: lib  # the wrappers load their library per call
        tiles = rf._split_operands(f1, f2)
        rl, cl = rf.lse_pass(f1, f2, T, tiles=tiles)
        rw = rf.reward_pass(*prob, rl, cl, **kw, tiles=tiles)
        torch.cuda.synchronize()
        outs.setdefault(name, [*tiles, rl, cl, *rw])
        lse = _time_ms(lambda: rf.lse_pass(f1, f2, T, tiles=tiles), n=50)
        rew = _time_ms(lambda: rf.reward_pass(*prob, rl, cl, **kw, tiles=tiles), n=50)
        times[name].append((lse, rew))
        print(f"{name}: lse {lse:.4f} ms, reward {rew:.4f} ms", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["change"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    B, m, D = f1.shape
    print(f"reduction at B={B} m={m} n={f2.shape[1]} D={D}, in the order {' / '.join(order)}: lse ms "
          + ", ".join(f"{k} {' / '.join(f'{t[0]:.4f}' for t in v)}" for k, v in times.items())
          + "; reward ms " + ", ".join(f"{k} {' / '.join(f'{t[1]:.4f}' for t in v)}" for k, v in times.items())
          + f"; outputs bit for bit equal: {same}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
