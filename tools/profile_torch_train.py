#!/usr/bin/env python3
"""Where the time goes in posfeat_tpu_torch's training, on one CUDA card.

    python3 tools/profile_torch_train.py [--stage 1|2] [--probe] [--data synthetic|megadepth]
        [--dtype float32|bfloat16] [--steps 5] [--trace PATH] [--convs [--benchmark-limit N]]

Builds chip_smoke.py's training setup of the stage: 2 (the default),
``chip_smoke.train_config`` (configs/train_kp.yaml with the flagship
model in f32, SyntheticPairs at 480x640, batch 6 pairs); 1,
``chip_smoke.desc_config`` (configs/train_desc.yaml, the same model and
data, batch 8 pairs). ``--probe`` takes the ΔMMA probe's training
instead (tools/selection_stability_torch.py ``train_config``: the
head192 model, SyntheticPairs at 96x128, batch 4 pairs; stage 2 from
random weights). ``--data megadepth`` feeds the same configuration
MegaDepth_SIFT on a MegaDepth-layout fixture at 480x640 written by
tools/make_megadepth_fixture.py (2 scenes x 4 images), with the shipped
config's data section (SIFT query points, colour jitter); ``--dtype``
sets ``compute_dtype``. It measures:
  1. the input pipeline alone: seconds per batch of the PrefetchLoader
     and of one sample built on the calling thread (with ``--data
     megadepth``, SyntheticPairs' PrefetchLoader beside it);
  2. the step alone: ``Trainer.train_step`` on batches already on the
     card, host clock around synchronized steps; and the head's forward
     alone on one view's maps (CUDA events), which a stage-1 step runs
     twice though its loss reads no score map;
  3. ``Trainer.train`` (a warm-up step, then ``--steps`` steps, loader
     included) under torch.profiler: each step's time and its wait for
     the loader, the device's busy and idle share of the window, device
     time by kernel class (cuDNN's convolutions apart from cuBLAS's
     matmuls, which in stage 1 are mostly the correspondence engine's
     correlations) and the top kernels.
``--trace`` keeps the Chrome trace at PATH.

``--convs`` measures instead one row per conv call of a step (the
model's forward and its backward, ``Trainer.loss`` and ``backward()``,
the calls ``train_step`` autotunes), first under cuDNN's heuristic and
then under its autotune as ``train_step`` scopes it (``core/device.py``
``cudnn_autotune``; ``--benchmark-limit N`` times N candidates instead,
0 every one), each in a process of its own, since cuDNN keeps a conv
shape's first choice for the process: the call's module, input and
weight shapes, stride and padding, and under each the kernels it
launched, their device ms, the one that took most of them and the
call's host ms in the first step (where cuDNN picks, and the autotune
times, its algorithm); then each arm's totals, its first step and its
later steps, host clock around synchronized steps.
"""

import argparse
import bisect
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import DESC_BATCH, TRAIN_BATCH, desc_config, train_config  # noqa: E402
from profile_torch_extract import _busy_us  # noqa: E402

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("K4-K6 split (shared by both passes)", ("lse_split_kernel",)),
    ("K4+K5 lse_pass", ("lse_pass_kernel",)),
    ("K6 reward_pass", ("reward_pass_kernel",)),
    # cuDNN's FFT convolutions run complex GEMMs (cf32) and pointwise complex products
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "cudnn", "cf32",
                      "complex")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90", "sm80")),
    ("batch/instance norm", ("batch_norm", "bn_", "norm")),
    ("upsample / grid_sample", ("upsample", "grid_sampler")),
    ("reduce", ("reduce",)),
    ("copy / cat / pad / index", ("copy", "cat", "pad", "unfold", "im2col", "col2im", "index", "gather",
                                  "scatter")),
)


CONV_OPS = ("aten::convolution", "aten::convolution_backward")
CONV_STEP = "convs.step"  # the range around each profiled step of --convs
CONV_STEPS = 2  # profiled steps of --convs
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # cuDNN launches through both


def conv_rows(events, steps: int) -> list:
    """One row per conv call of a step, from a Chrome trace of ``steps``
    steps, each in a ``CONV_STEP`` range: the forward's ``aten::convolution``
    and the backward's ``aten::convolution_backward`` host ops in start
    order, each with the kernels whose launch lies inside it (by
    correlation id, on the op's thread), averaged over the steps. A
    forward call's module is the ``model.backbone`` or ``model.head`` span
    around it; the backward runs on autograd's thread, outside them."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e.get("name") in CONV_OPS and "dur" in e),
                 key=lambda e: e["ts"])
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == CONV_STEP and e.get("cat") == "user_annotation")
    if len(ranges) != steps:
        raise RuntimeError(f"the trace holds {len(ranges)} {CONV_STEP} ranges, not {steps}")
    modules = sorted((e["ts"], e["ts"] + e["dur"], e["tid"], e["name"].split(".")[1]) for e in events
                     if e.get("name") in ("model.backbone", "model.head") and "dur" in e)
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    by_tid = defaultdict(list)
    for i, op in enumerate(ops):
        by_tid[op["tid"]].append(i)
    starts = {tid: [ops[i]["ts"] for i in idx] for tid, idx in by_tid.items()}
    launched = defaultdict(list)
    for e in events:
        k = kernels.get(e.get("args", {}).get("correlation")) if e.get("cat") in LAUNCH_CATS else None
        if k is None or e["tid"] not in by_tid:
            continue
        j = bisect.bisect_right(starts[e["tid"]], e["ts"]) - 1
        if j >= 0 and e["ts"] <= ops[by_tid[e["tid"]][j]]["ts"] + ops[by_tid[e["tid"]][j]]["dur"]:
            launched[by_tid[e["tid"]][j]].append(k)
    per_step = [[i for i, op in enumerate(ops) if s <= op["ts"] <= t] for s, t in ranges]
    if len({len(calls) for calls in per_step}) != 1:
        raise RuntimeError(f"the steps made different numbers of conv calls: {[len(c) for c in per_step]}")
    rows = []
    for calls in zip(*per_step):
        op = ops[calls[0]]
        args = op.get("args", {})
        dims, concrete = args.get("Input Dims", []), args.get("Concrete Inputs", [])
        backward = op["name"] == "aten::convolution_backward"
        first = 1 if backward else 0  # convolution_backward's grad_output comes first
        module = next((m for s, t, tid, m in modules if tid == op["tid"] and s <= op["ts"] <= t), "")
        by_name = defaultdict(float)
        for i in calls:
            for k in launched[i]:
                by_name[k["name"]] += k["dur"]
        top = max(by_name, key=by_name.get, default="")
        rows.append({
            "pass": "bwd" if backward else "fwd", "module": module,
            "input": dims[first] if len(dims) > first else [],
            "weight": dims[first + 1] if len(dims) > first + 1 else [],
            "stride": concrete[first + 3] if len(concrete) > first + 4 else "",
            "padding": concrete[first + 4] if len(concrete) > first + 4 else "",
            "launches": sum(len(launched[i]) for i in calls) / steps,
            "device_ms": sum(by_name.values()) / steps / 1e3,
            "host_ms": sum(ops[i]["dur"] for i in calls) / steps / 1e3,
            "top_kernel": top, "top_share": by_name[top] / sum(by_name.values()) if by_name else 0.0,
        })
    return rows


def _events(prof, tmp: str) -> list:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def conv_arm(cfg, batch_size: int, autotune: bool, steps: int, limit=None) -> dict:
    """The --convs readings of one arm, in this process: the model's
    forward and backward of a step (what ``train_step`` runs between its
    optimizer's zero_grad and its guard) on cuDNN's heuristic, or on its
    autotune as the step scopes it (``cudnn_autotune``; ``limit``: another
    ``benchmark_limit`` inside it). Each row also gets the host ms of
    the call in the first step, where cuDNN picks (and the autotune times)
    the call's algorithm."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from posfeat_tpu_torch.core.device import cudnn_autotune
    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.train import Trainer

    _build.build()  # out of the first step's time
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp)
        ds = tr.train_dataset
        batches = [tr.to_device(collate([ds[(i + batch_size * k) % len(ds)] for i in range(batch_size)]))
                   for k in range(2)]

        def step(batch):
            for opt in tr.optimizers.values():
                opt.zero_grad(set_to_none=True)
            with cudnn_autotune() if autotune else contextlib.nullcontext():
                if limit is not None:
                    torch.backends.cudnn.benchmark_limit = limit
                total, _ = tr.loss(batch, 1)
                total.backward()

        def timed(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(CONV_STEP):
                step(batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            times = [timed(batches[0])]
        first = conv_rows(_events(prof, tmp), 1)
        times += [timed(batches[k % 2]) for k in range(1, 1 + steps)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            for k in range(CONV_STEPS):
                timed(batches[k % 2])
        rows = conv_rows(_events(prof, tmp), CONV_STEPS)
    for r, f in zip(rows, first, strict=True):
        r["first_ms"] = f["host_ms"]
    arm = "heuristic" if not autotune else "autotune" if limit is None else f"autotune{limit}"
    return {"arm": arm, "device": torch.cuda.get_device_name(0),
            "first_step_s": times[0], "step_s": sum(times[1:]) / steps, "rows": rows}


def print_conv_table(arms: list) -> None:
    """The arms' rows side by side (the same model makes the same calls in
    the same order under either), then each arm's totals."""
    names = [a["arm"] for a in arms]
    rows = [a["rows"] for a in arms]
    if len({len(r) for r in rows}) != 1:
        raise RuntimeError(f"the arms made different numbers of conv calls: {[len(r) for r in rows]}")
    print(f"conv calls of one step, {names[0]} | {names[1]}: launches, device ms, the first step's host ms, the "
          "kernel with most of the time (its share)")
    for n, pair in enumerate(zip(*rows)):
        r = pair[0]
        cells = " | ".join(f"{x['launches']:7.1f} {x['device_ms']:8.3f} ms {x['first_ms']:9.1f} first "
                           f"{x['top_kernel'][:70]} ({100 * x['top_share']:.0f}%)" for x in pair)
        print(f"{n:3d} {r['pass']} {r['module']:8s} in {r['input']} w {r['weight']} s {r['stride']} "
              f"p {r['padding']} | {cells}")
    for a in arms:
        for what in ("fwd", "bwd"):
            sel = [r for r in a["rows"] if r["pass"] == what]
            print(f"{a['arm']:9s} {what}: {len(sel)} calls, {sum(r['launches'] for r in sel):.1f} launches, "
                  f"{sum(r['device_ms'] for r in sel):.3f} device ms, {sum(r['host_ms'] for r in sel):.3f} host ms "
                  f"a step; first step {sum(r['first_ms'] for r in sel):.1f} host ms")
        print(f"{a['arm']:9s} first step {a['first_step_s']:.4f} s, later steps {a['step_s']:.4f} s "
              f"(forward and backward, host clock, synchronized) on {a['device']}")


def convs(argv: list) -> int:
    """Run each arm of --convs in a process of its own and print the table."""
    arms = []
    for arm in ("heuristic", "autotune"):
        cmd = [sys.executable, os.path.abspath(__file__)] + [a for a in argv if a != "--convs"] + ["--convs-arm", arm]
        out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, check=True).stdout
        arms.append(json.loads(out.strip().splitlines()[-1]))
    print_conv_table(arms)
    return 0


def _class(name):
    low = name.lower()
    for label, frags in CLASSES:
        if any(f in low for f in frags):
            return label
    return "elementwise / other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from posfeat_tpu_torch.data.loader import collate
    from posfeat_tpu_torch.train import Trainer

    p = argparse.ArgumentParser()
    p.add_argument("--stage", type=int, choices=(1, 2), default=2)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None, help="keep the Chrome trace here")
    p.add_argument("--probe", action="store_true", help="the ΔMMA probe's training (96x128, batch 4)")
    p.add_argument("--data", choices=("synthetic", "megadepth"), default="synthetic")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--convs", action="store_true", help="the per-conv table, heuristic against autotune")
    p.add_argument("--convs-arm", choices=("heuristic", "autotune"), help=argparse.SUPPRESS)
    p.add_argument("--benchmark-limit", type=int, default=None,
                   help="--convs: the autotune's torch.backends.cudnn.benchmark_limit (default: the step's)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.convs:
        return convs(sys.argv[1:])
    if args.probe:
        from selection_stability_torch import train_config as probe_config

        cfg = probe_config(None, "desc" if args.stage == 1 else "kp", args.steps)
        batch_size = cfg["data_config_train"]["batch_size"]
    else:
        cfg, batch_size = (desc_config(), DESC_BATCH) if args.stage == 1 else (train_config(), TRAIN_BATCH)
    cfg["compute_dtype"] = args.dtype
    fixture_dir = tempfile.TemporaryDirectory()
    synthetic = None
    if args.data == "megadepth":
        from make_megadepth_fixture import write_megadepth_fixture

        from posfeat_tpu_torch.core.config import load_config

        synthetic = dict(cfg["data_config_train"])
        shipped = load_config(f"configs/train_{'desc' if args.stage == 1 else 'kp'}.yaml")
        h, w = synthetic["height"], synthetic["width"]
        cfg["data"] = "MegaDepth_SIFT"
        cfg["data_config_train"] = {**shipped["data_config_train"], "batch_size": batch_size,
                                    "data_path": write_megadepth_fixture(fixture_dir.name, 2, 4, h, w)}
    if args.convs_arm:
        print(json.dumps(conv_arm(cfg, batch_size, args.convs_arm == "autotune", args.steps, args.benchmark_limit)))
        fixture_dir.cleanup()
        return 0
    print(f"stage {args.stage}{' (probe)' if args.probe else ''}, {cfg['data']}, {args.dtype}: "
          f"{torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp)
        ds = tr.train_dataset
        if synthetic is not None:
            from posfeat_tpu_torch.data import SyntheticPairs
            from posfeat_tpu_torch.data.loader import PrefetchLoader

            it = iter(PrefetchLoader(SyntheticPairs(synthetic), batch_size=batch_size,
                                     num_workers=synthetic["workers"], infinite=True))
            next(it)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                next(it)
            print(f"input: SyntheticPairs PrefetchLoader {(time.perf_counter() - t0) / args.steps:.4f} s per "
                  f"batch of {batch_size} ({synthetic['workers']} threads)")
            it.close()

        # 1. the input pipeline alone
        t0 = time.perf_counter()
        ds[0]
        one = time.perf_counter() - t0
        it = iter(tr.train_loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            next(it)
        loader_s = (time.perf_counter() - t0) / args.steps
        it.close()
        print(f"input: one sample {one:.4f} s on the calling thread; PrefetchLoader "
              f"{loader_s:.4f} s per batch of {batch_size} ({cfg['data_config_train']['workers']} threads)")

        # 2. the step alone, batches already on the card
        batches = [tr.to_device(collate([ds[(i + batch_size * k) % len(ds)] for i in range(batch_size)]))
                   for k in range(2)]
        tr.train_step(batches[0], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(args.steps):
            tr.train_step(batches[k % 2], 1)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / args.steps
        print(f"step without the loader: {step_s:.4f} s ({batch_size / step_s:.3f} pairs/s), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        model, im = tr.model, batches[0]["im1"]
        with torch.no_grad():
            feats = model.backbone(im)
            local_input = torch.cat([feats[n] for n in model.local_input_elements], dim=-1)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            model.localheader(local_input, im)
            e0.record()
            for _ in range(args.steps):
                model.localheader(local_input, im)
            e1.record()
            torch.cuda.synchronize()
        head_ms = e0.elapsed_time(e1) / args.steps
        print(f"head forward alone, one view of {batch_size} images: {head_ms:.3f} ms "
              f"(two per step: {2 * head_ms / (step_s * 1e3):.1%} of the step)")

    # 3. Trainer.train under the profiler
    cfg["epoch_step"] = args.steps + 1
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, ckpt_root=tmp)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        steps = [json.loads(x) for x in open(os.path.join(tr.save_root, "step_times.jsonl"))]
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device kernels")
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_class[_class(e["name"])] += e["dur"]
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    total = sum(by_class.values())
    n = len(steps)
    fixture_dir.cleanup()
    print(f"device: {torch.cuda.get_device_name(0)}; Trainer.train, {n} steps (1 warm-up), window "
          f"{wall_us / 1e3:.3f} ms (host clock, checkpoints included); step times "
          f"{[round(s['step_time_s'], 4) for s in steps]}; waits for the loader "
          f"{[round(s['data_wait_s'], 4) for s in steps]}; mean after the warm-up "
          f"{sum(s['step_time_s'] for s in steps[1:]) / (n - 1):.4f} s/step, of it "
          f"{sum(s['data_wait_s'] for s in steps[1:]) / (n - 1):.4f} s waiting for the loader")
    print(f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% of the window; "
          f"idle {100 * (1 - busy / wall_us):.1f}%; kernel time {total / 1e3:.3f} ms in {len(kernels)} launches "
          f"({len(kernels) / n:.0f} per step)")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  {us / n / 1e3:.4f} ms/step")
    print("top kernels:")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms {cnt:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
