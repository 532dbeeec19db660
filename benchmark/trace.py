"""The traced run: torch.profiler (CPU and CUDA activity) around the
window, ranges opened by forward hooks around the program's layers, and
the reduction of the profiler's Chrome trace to the records the
per-layer metrics read.

The trace file goes to a temporary directory under TMPDIR and is
deleted once read. A trace that holds no device kernel is an error: the
run fails with a message and reports nothing (a missing trace must never
read as an idle device)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd.profiler import record_function

WINDOW = "bench.window"
SPAN = "bench."  # prefix of the layer ranges: bench.<layer>
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class EmptyTrace(RuntimeError):
    pass


def hook_layer(module: torch.nn.Module, layer: str) -> list:
    """Open a ``bench.<layer>`` range for every forward of ``module``
    (forward pre-hook) and close it after (forward hook). Returns the
    hook handles."""
    stack = []

    def enter(_m, _inputs):
        rf = record_function(SPAN + layer)
        rf.__enter__()
        stack.append(rf)

    def leave(_m, _inputs, _out):
        stack.pop().__exit__(None, None, None)

    return [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]


def union_us(intervals) -> float:
    """The length covered by the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


@dataclass
class Records:
    """What the per-layer metrics read. Times in seconds; ``kernels`` are
    (name, start_us, dur_us, layer) of every kernel in the trace, with the
    layer whose range launched it ('' for none); ``spans`` counts each
    layer's ranges; ``info`` is the job's (units in the window, batch,
    shapes, model FLOPs a unit, the configuration's peak, the window's
    peak memory)."""

    kernels: list
    spans: dict
    window_s: float
    busy_s: float
    info: dict
    breakdown: dict = field(default_factory=dict)

    def kernel_time(self, *fragments, layer=None) -> tuple:
        """(seconds, launches) of kernels whose name holds one of ``fragments``."""
        t, n = 0.0, 0
        for name, _ts, dur, lay in self.kernels:
            if any(f in name for f in fragments) and (layer is None or lay == layer):
                t += dur
                n += 1
        return t * 1e-6, n


def _innermost(events, starts, t):
    """The shortest of ``events`` (sorted by start) open at time t."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in reversed(events[max(0, i - 256): i]):
        if e["ts"] + e.get("dur", 0) >= t and (best is None or e["dur"] < best["dur"]):
            best = e
    return best


def reduce_trace(path: str, window_s: float, info: dict) -> Records:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    kern = [e for e in dev if e["cat"] == "kernel"]
    if not kern:
        raise EmptyTrace("torch.profiler recorded no device kernel in the traced window; "
                         "no per-layer metric can be read from this run")
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        raise EmptyTrace(f"the trace holds no {WINDOW} range")
    w0 = wins[0]["ts"]
    w1 = w0 + window_s * 1e6
    main_tid = wins[0]["tid"]
    # each kernel's launch on the host, by correlation id
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], e["ts"])
    spans = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN) and e["name"] != WINDOW:
            spans[(e["tid"], e["name"][len(SPAN):])].append((e["ts"], e["ts"] + e["dur"]))
    by_tid = defaultdict(list)
    for (tid, layer), ivs in spans.items():
        for s, t in ivs:
            by_tid[tid].append((s, t, layer))
    for v in by_tid.values():
        v.sort()
    starts = {tid: [s for s, _, _ in v] for tid, v in by_tid.items()}

    def layer_of(e):
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is None or where[0] not in by_tid:
            return ""
        tid, ts = where
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0:
            s, t, layer = by_tid[tid][i]
            if s <= ts <= t:
                return layer
        return ""

    kernels = [(e["name"], e["ts"], e["dur"], layer_of(e)) for e in kern]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    clipped = [(s, t) for s, t in clipped if t > s]
    busy = union_us(clipped)
    span_counts = defaultdict(int)
    for (_tid, layer), ivs in spans.items():
        span_counts[layer] += len(ivs)
    return Records(kernels, dict(span_counts), window_s, busy * 1e-6, info,
                   _breakdown(events, dev, clipped, w0, w1, main_tid))


def _breakdown(events, dev, clipped, w0, w1, main_tid) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps by the host operation open on the main thread."""
    ops = defaultdict(float)
    for e in dev:
        if w0 <= e["ts"] < w1:
            ops[e["name"][:160]] += e["dur"] * 1e-6
    host = sorted((e for e in events if e.get("tid") == main_tid and e.get("cat") in ("cpu_op", "user_annotation")
                   and "dur" in e and e.get("name") != WINDOW), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps = defaultdict(float)
    edge = w0
    for s, t in sorted(clipped) + [(w1, w1)]:
        if s > edge:
            e = _innermost(host, starts, (edge + s) / 2)
            gaps[e["name"][:160] if e else "(no host op open)"] += (s - edge) * 1e-6
        edge = max(edge, t)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


class Tracer:
    """torch.profiler over the window. ``window()`` is the range whose
    start marks the window in the trace."""

    def __init__(self):
        self._dir = tempfile.mkdtemp(prefix="bench-trace-")
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    @staticmethod
    def window():
        return record_function(WINDOW)

    def records(self, window_s: float, info: dict) -> Records:
        path = os.path.join(self._dir, "trace.json")
        try:
            self._prof.export_chrome_trace(path)
            return reduce_trace(path, window_s, info)
        finally:
            if os.path.exists(path):
                os.remove(path)
            os.rmdir(self._dir)
