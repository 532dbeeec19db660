#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from,
at the cell's own size on the card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 \
        [--seconds 3] [--out FILE]

For each of ``--seeds`` the program takes that seed's weights and
inputs and runs a window of ``--seconds`` at the cell's load (training:
its three checked steps), and the check's numbers are read as a run
reads them. For each of ``--control-seeds`` every control of the job
(the reference at the configuration's control precision in the
program's place; for training also a planted fault) is read the same
way. Prints one JSON line a reading and a summary: per number the lower
reading (the largest of the program's), the upper (the smallest of the
controls') and their ratio. The benchmark's own runs never run this."""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def calibrate(ctx, seeds, control_seeds, seconds, emit=print) -> dict:
    job = harness.job_module(ctx.traffic).Job(ctx)
    ctx.seed = seeds[0]
    job.setup()
    program = []
    for seed in seeds:
        job.reseed(seed)
        job.window(seconds)
        r = job.readings()
        program.append(r)
        emit(json.dumps({"kind": "program", "seed": seed, **r}))
    controls = {}
    for seed in control_seeds:
        job.reseed(seed)
        for name, read in job.controls().items():
            r = read()
            controls.setdefault(name, []).append(r)
            emit(json.dumps({"kind": name, "seed": seed, **r}))
    summary = {}
    for k in program[0]:
        lower = max(r[k] for r in program)
        uppers = {name: min(r[k] for r in rs) for name, rs in controls.items()}
        summary[k] = {"lower": lower, "program": [r[k] for r in program], "upper": uppers,
                      "ratio": {n: (u / lower if lower > 0 else float("inf")) for n, u in uppers.items()},
                      "controls": {name: [r[k] for r in rs] for name, rs in controls.items()}}
    return summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py reads the card; no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    ctx = harness.Context(args.workload, 0, torch.device("cuda", 0), harness.config_of(spec, cell),
                          harness.traffic_of(cell), tempfile.mkdtemp(prefix="bench-cal-"))
    summary = calibrate(ctx, ints(args.seeds), ints(args.control_seeds), args.seconds)
    line = json.dumps({"kind": "summary", "cell": args.workload, "device": torch.cuda.get_device_name(0),
                       "numbers": summary})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
