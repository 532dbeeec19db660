"""What every run shares: ``BENCHMARK.json`` and the files it names, the
run's context, the guard against JAX, the limits, and the result line.

A cell is an entry of ``workloads``; its configuration is
``configs/<config>.json``, its traffic mix ``traffic/<traffic>.json``
(whose ``job`` names ``jobs/<job>.py``), its limits
``limits/<cell>.json``. A per-layer metric is ``metrics/<name>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "posfeat_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in spec['workloads']]}")


def config_of(spec: dict, cell: dict, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict) -> dict:
    return _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))


def limits_of(cell: dict) -> dict:
    """{number: limit} of the cell's compared numbers."""
    data = _json(os.path.join(HERE, "limits", cell["name"] + ".json"))
    return {k: v["limit"] for k, v in data["numbers"].items()}


def job_module(traffic: dict):
    return importlib.import_module(f"benchmark.jobs.{traffic['job']}")


def metric_module(name: str):
    """``metrics/<name>.py``, loaded by its file name (names hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def end_to_end_names(spec: dict, cell: str) -> list:
    return [m["name"] for m in spec["end_to_end"] if _applies(m, cell)]


def per_layer_entries(spec: dict, cell: str) -> list:
    """The per-layer metrics a traced run of ``cell`` reports: those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = set(end_to_end_names(spec, cell))
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package in this process, compared by
    whole top-level names (posfeat_tpu_torch is not posfeat_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def stage(what: str, t: float) -> float:
    """Say on standard error how long a part of the set-up took."""
    now = time.perf_counter()
    print(f"setup: {what} {now - t:.3f} s", file=sys.stderr, flush=True)
    return now


@dataclass
class Context:
    """One run: the cell, its seed and device, its configuration and mix,
    and a scratch directory under TMPDIR for the program's logs."""

    cell: str
    seed: int
    device: object
    config: dict
    traffic: dict
    tmp: str


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) of the compared numbers: each at
    or under its limit."""
    rows = [(k, readings[k], limits[k]) for k in limits]
    return all(v <= lim for _k, v, lim in rows), rows
