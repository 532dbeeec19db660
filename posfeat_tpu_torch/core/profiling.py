"""Per-step wall-clock statistics (posfeat_tpu/core/profiling.py:37-70).

``StepTimer`` keeps rolling step times and appends each to a jsonl sink.
Given a CUDA device it synchronizes the device before it reads the clock,
so a step's time covers the work the step queued, not only its launches.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch


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
