"""Device traces, host spans and wall-clock statistics
(posfeat_tpu/core/profiling.py).

  * ``trace(logdir, device)``: a ``torch.profiler`` trace (host activity
    with the inputs' shapes, and the card's kernels on CUDA) written for
    TensorBoard into ``logdir`` when the context closes;
  * ``span(name, seq=None)``: a named host range at a layer boundary of
    the program (the Extractor's batch loop, the Trainer's step, the
    model's backbone and head). Tracing is on exactly while a
    ``torch.profiler`` session records on the calling thread: this
    module's ``trace()``, the Trainer's ``profile_trace_dir``, or any
    other session, such as the benchmark's traced run. There is no
    switch of its own. While it is on, a span opens a profiler range of
    its name (a host op of the trace's ``cpu_op`` category, on the
    profiler's clock beside the card's kernels; ``seq``, a batch or step
    number, goes in the range's args where the session records inputs,
    as ``trace()`` does) and adds its host seconds and a count of one to
    an in-memory table, ``span_totals()``, under a lock; it closes and
    counts when its body raises. While it is off, a span is one check of
    torch's profiler flag: no clock, no allocation, no lock;
  * ``StepTimer``: rolling step times appended to a jsonl sink. Given a
    CUDA device it synchronizes the device before it reads the clock, so
    a step's time covers the work the step queued, not only its launches.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Trace the body into ``logdir`` (``*.pt.trace.json``, which
    TensorBoard's profiler plugin and chrome://tracing read): CPU activity
    always, with the inputs' shapes (which carry the spans' ``seq``), CUDA
    activity when ``device`` is a card."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


_OFF = contextlib.nullcontext()  # every span while tracing is off
_totals_lock = threading.Lock()
_totals: Dict[str, List] = {}  # name -> [count, seconds]


class _Span:
    """A span while tracing is on: its profiler range and its host time."""

    __slots__ = ("name", "seq", "_range", "_t0")

    def __init__(self, name: str, seq: Optional[int]):
        self.name, self.seq = name, seq

    def __enter__(self):
        self._range = (_RecordFunctionFast(self.name) if self.seq is None
                       else _RecordFunctionFast(self.name, (), {"seq": int(self.seq)}))
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _totals_lock:
            entry = _totals.setdefault(self.name, [0, 0.0])
            entry[0] += 1
            entry[1] += seconds
        return False


def span(name: str, seq: Optional[int] = None):
    """A context manager over one layer's work: a profiler range named
    ``name`` and a count in ``span_totals()`` while tracing is on (see the
    module docstring), nothing beyond the flag's check while it is off."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, seq)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """{name: (count, host seconds)} of the spans closed while tracing was
    on, since the process started or ``reset_span_totals()``."""
    with _totals_lock:
        return {name: (count, seconds) for name, (count, seconds) in _totals.items()}


def reset_span_totals() -> None:
    with _totals_lock:
        _totals.clear()


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
