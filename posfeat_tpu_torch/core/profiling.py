"""Device traces and wall-clock statistics (posfeat_tpu/core/profiling.py).

  * ``trace(logdir, device)``: a ``torch.profiler`` trace (host activity,
    and the card's kernels on CUDA) written for TensorBoard into
    ``logdir`` when the context closes;
  * ``StepTimer``: rolling step times appended to a jsonl sink. Given a
    CUDA device it synchronizes the device before it reads the clock, so
    a step's time covers the work the step queued, not only its launches;
  * ``device_time(fn, *args)``: the best wall time of a few calls, each
    synchronized with the card.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Trace the body into ``logdir`` (``*.pt.trace.json``, which
    TensorBoard's profiler plugin and chrome://tracing read): CPU activity
    always, CUDA activity when ``device`` is a card."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def device_time(fn: Callable, *args, iters: int = 3) -> float:
    """The best of ``iters`` wall times (seconds) of ``fn(*args)`` after one
    warm-up call; where a CUDA tensor is among ``args``, each call is
    closed by ``torch.cuda.synchronize`` on its card
    (posfeat_tpu/core/profiling.py:73-93)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)

    def sync():
        if device is not None:
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


class StepTimer:
    """Rolling step-time statistics with optional jsonl persistence."""

    def __init__(self, sink_path: Optional[str] = None, window: int = 200, device=None):
        self.sink_path = sink_path
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, **extra) -> float:
        assert self._t0 is not None, "start() not called"
        self._sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if self.sink_path:
            with open(self.sink_path, "a") as f:
                f.write(json.dumps({"step_time_s": dt, **extra}) + "\n")
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.array(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "last_s": float(arr[-1]),
        }
