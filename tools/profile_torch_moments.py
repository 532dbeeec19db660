#!/usr/bin/env python3
"""The row-moments kernel (``csrc/moments.cu``) in each plan it can take,
at the head's norms' shapes, on one CUDA card: the plan the launch picks,
the lane plan at each of its thread counts and the slot plan at each of
its own, each launched through the C entry point, checked against the
plain version (chip_smoke.py ``MOMENTS_RTOL``) and timed on the device:
the kernel's duration in a torch.profiler trace (10 launches after a
warm-up), beside the bound by bytes. Then the host's µs a call of the wrapper and of
its parts (the output's allocation, the C launch bare and under the map's
device guard, the autograd node) on the 2048x3072 score norm's map. For choosing the lane plan's
threads a row (``ops/moments.py`` ``VECTORS_A_LANE``), the slot plan's
threads a block (``THREADS``) and which rows take which plan.

    python3 tools/profile_torch_moments.py [--only NAME ...]

Shapes: chip_smoke.py ``MOMENTS_NORMS`` (``--only``: those norms alone).
Prints one JSON line a shape, one of the host's µs a call, then
nvidia-smi's name and power limit. Without a CUDA card it exits 2.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def kernel_ms(torch, fn, n=10):
    """Device ms a launch of the row-moments kernels: their mean duration
    in a torch.profiler trace of n calls of ``fn`` after a warm-up (a trace
    may miss the window's first launch)."""
    from torch.profiler import ProfilerActivity, profile

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
    return sum(durs) / len(durs) / 1e3


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="NAME", help="these norms of MOMENTS_NORMS alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import moments as mo
    from posfeat_tpu_torch.ops._build import load_kernels

    resolve_device("cuda")
    lib = load_kernels()
    g = torch.Generator(device="cuda").manual_seed(c.SEED)
    for name, shape, dt in c.MOMENTS_NORMS:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(getattr(torch, dt))
        if args.only and name not in args.only:
            continue
        p1, p2 = mo.row_moments_plain(x)
        a1 = mo.row_moments_plain(x.abs())[0]
        shipped = mo.plan_of(x)
        B, R, E, C = mo._rows(x.shape)
        slots = mo.slot_plan(x.dtype, E, C)
        plans = [shipped]
        if shipped.lane:
            plans += [shipped._replace(threads=n) for n in mo.LANES if n != shipped.threads]
        # the slot plan at each power of two times its least thread count
        # that the kernel takes, and at about 256 threads (the former choice)
        base = math.lcm(C, slots.vec) // slots.vec
        counts = {base << i for i in range(11) if (base << i) <= 1024 and (base << i) * slots.vec <= mo.MAX_SLOTS}
        counts.add(base * max(1, 256 // base))
        plans += [slots._replace(threads=n) for n in sorted(counts)]
        plans = list(dict.fromkeys(plans))
        s = torch.empty((2, B, R, C), dtype=torch.float32, device="cuda")
        bound = (x.numel() * x.element_size() + s.numel() * 4) / c.PEAK_BYTES * 1e3
        times = {}
        for plan in plans:
            def launch(plan=plan):
                rc = lib.posfeat_row_moments(x.data_ptr(), s.data_ptr(), mo._DTYPES[x.dtype], B * R, E, C, *plan,
                                             torch.cuda.current_stream().cuda_stream)
                assert rc == 0, (rc, plan)

            launch()
            torch.cuda.synchronize()
            ok = bool(((s[0] - p1).abs() <= c.MOMENTS_RTOL * a1 + 1e-6).all()
                      and ((s[1] - p2).abs() <= c.MOMENTS_RTOL * p2 + 1e-6).all())
            assert ok, (name, plan)
            kernel = kernel_ms(torch, launch)
            times[str(tuple(plan))] = {"kernel_ms": kernel, "share": bound / kernel}
        print(json.dumps({"norm": name, "shape": shape, "dtype": dt, "bound_ms": bound,
                          "shipped": str(tuple(shipped)), "plans": times}), flush=True)
        del x, p1, p2, a1, s
        torch.cuda.empty_cache()
    # the host's share of a call: µs a call over 2000 back-to-back calls on
    # the 2048x3072 score norm's map (6 µs of device time a launch), and of
    # the call's parts
    x = torch.randn((1, c.SLICE_K_H // 4, 4 * c.SLICE_K_W, 1), generator=g, device="cuda")
    B, R, E, C = mo._rows(x.shape)
    out = (2, B, R, C)
    s = torch.empty(out, dtype=torch.float32, device="cuda")
    plan = mo.plan_of(x)
    stream = torch.cuda.current_stream().cuda_stream

    def guarded():
        with torch.cuda.device(x.device):
            return lib.posfeat_row_moments(x.data_ptr(), s.data_ptr(), 0, B * R, E, C, *plan,
                                           torch.cuda.current_stream(x.device).cuda_stream)

    class Nothing(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g

    parts = {
        "row_moments": lambda: mo.row_moments(x),
        "torch.empty of the output": lambda: torch.empty(out, dtype=torch.float32, device="cuda"),
        "the C launch alone": lambda: lib.posfeat_row_moments(x.data_ptr(), s.data_ptr(), 0, B * R, E, C, *plan,
                                                              stream),
        "the C launch under the map's device guard and stream": guarded,
        "an autograd.Function of no work": lambda: Nothing.apply(x),
        "torch's per-row sum pair": lambda: (x.sum(dim=2), (x * x).sum(dim=2)),
    }
    host = {}
    for name, fn in parts.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t0) / 2000 * 1e6
    print(json.dumps({"host_us_a_call": host}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
