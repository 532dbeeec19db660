#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: build or load the port's kernel library (at its first launch,
under ``build/torch_kernels/`` in the checkout), make the weights and
inputs on the card from the seed, warm up the cell's own shapes (all of
that is ``setup_s``), measure for ``--seconds``, free the program, check
its outputs against the plain reference, and print one JSON line last
on standard output. ``--trace 1`` runs the window under torch.profiler
and reports the cell's per-layer metrics in place of its end-to-end
ones. Without a CUDA card, or with fewer than the cell asks for, it
exits with code 2 and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def execute(ctx: harness.Context, spec: dict, seconds: float, trace: bool, t_start: float) -> tuple:
    """Set-up, window, check of one run: (result dict, check rows). The
    caller has made sure the device is there."""
    import torch

    from benchmark import trace as tracing

    cell = harness.cell_entry(spec, ctx.cell)
    cuda = ctx.device.type == "cuda"
    job = harness.job_module(ctx.traffic).Job(ctx)
    job.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    if trace:
        handles = [h for layer, m in job.layers().items() for h in tracing.hook_layer(m, layer)]
        window_s = min(seconds, ctx.traffic["trace_seconds"])
        with tracing.Tracer() as tr:
            with tr.window():
                win = job.window(window_s)
        for h in handles:
            h.remove()
    else:
        win = job.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        records = tr.records(win["seconds"], {**job.trace_info(win), "window_peak_bytes": window_peak})

    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    metrics = {}
    if trace:
        device.update(busy_s=records.busy_s, window_s=records.window_s)
        for entry in harness.per_layer_entries(spec, ctx.cell):
            value = harness.metric_module(entry["name"]).read(records)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        produced = {**job.end_to_end(win), "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for name in harness.end_to_end_names(spec, ctx.cell):
            metrics[name] = {"value": produced[name], "unit": units[name]}

    job.release()
    correct, rows = harness.judge(job.check(), harness.limits_of(cell))
    correct = correct and win["failed"] == 0 and win["attempted"] > 0
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = records.breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell['chips']} CUDA card(s); torch sees {have}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="bench-run-")
    try:
        ctx = harness.Context(args.workload, args.seed, torch.device("cuda", 0),
                              harness.config_of(spec, cell), harness.traffic_of(cell), tmp)
        result, rows = execute(ctx, spec, args.seconds, bool(args.trace), T0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"the run holds JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
