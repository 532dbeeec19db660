#!/usr/bin/env python3
"""Multi-process runs of posfeat_tpu_torch: one rank's jobs, and the
launcher that starts every rank of a run.

    python3 tools/multihost_torch.py SPEC.json RANK

``SPEC.json``: {"world": n, "port": p, "device": "cpu" | "cuda",
"backend": "gloo" | "nccl" | null, "timeout_s": s, "threads": t,
"out": DIR, "jobs": [...]}; on the CPU each rank takes t // n torch
threads (t: the launcher's torch thread count, else the host's cores).
Each rank runs the jobs in order; those that train join one process
group (``multihost:`` with ``coordinator_address`` localhost:p,
``process_id`` RANK). Job kinds:

  * ``step``: a Trainer on ``config`` takes one ``train_step`` on the
    rank's rows of the global batch in the npz ``batch`` (or its loader's
    first batch) with the rank's rows of the draws in the npz ``draws``
    (or its own). Writes ``<name>.rank<r>.npz``: the local batch
    (``batch/*``), the global loss (``loss``) and components
    (``comp/*``), the summed gradients (``grad/<module>/*``) and the
    optimised modules' state after the step (``state/<module>/*``). Then
    ``train_steps`` > 0 runs ``Trainer.train`` for that many steps.
  * ``train``: ``Trainer.train`` on ``config``; ``nan_rank``'s loss is
    NaN at every step. Writes ``<name>.rank<r>.npz`` with the optimised
    modules' state before (``before/*``) and after (``after/*``).
  * ``loss``: the loss ``loss`` (a name of ``LOSSES``) on the rank's rows
    of the inputs (``in/*``) and preprocess results (``pp/*``) in the npz
    ``inputs``; writes the rank's share (``loss``) and the components.
  * ``extract``: an Extractor on ``config`` with ``shard_index`` RANK of
    ``num_shards`` world. With ``warmup`` n, it first extracts its shard's
    first n images (cuDNN, the allocator, the kernels' library), then
    waits for every process before the timed run over its whole shard;
    its record adds the timed run's images, launches and start and end
    (time.time()), and the process's start.

Every job also writes ``<name>.rank<r>.json``: its seconds and the
launches of the port's kernels during it (K1, K2, the lse and the reward
passes).

Draw files: DiskLoss's ``prop1``, ``acc1``, ``prop2``, ``acc2``;
Line2Window's ``kps1``, ``kps2`` and, where drawn, ``jitter1``,
``jitter2``; each at the global batch's shape.

``launch(spec, timeout)`` writes the spec, starts one process per rank,
waits for each with a timeout (killing all on expiry) and returns
(return codes, outputs, seconds).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T_PROCESS = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def launch(spec: dict, timeout: float):
    """Start every rank of ``spec`` (its "port" filled in when absent) and
    wait for them; returns (return codes, outputs, seconds)."""
    import torch
    from posfeat_tpu_torch.core.distributed import free_port

    spec = {"port": free_port(), "threads": torch.get_num_threads(), **spec}
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(spec["world"])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs += [p.communicate()[0] for p in procs[len(outs):]]
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def _rows(a, rank, world):
    b = a.shape[0] // world
    return a[rank * b:(rank + 1) * b]


def _draws(path, rank, world, device):
    import torch

    if not path:
        return None, None
    d = {k: torch.from_numpy(_rows(v, rank, world)).to(device) for k, v in np.load(path).items()}
    if "prop1" in d:
        return ((d["prop1"].long(), d["acc1"].bool()), (d["prop2"].long(), d["acc2"].bool())), None
    kps = tuple(t.long() if not t.is_floating_point() else t for t in (d["kps1"], d["kps2"]))
    return None, {"kps": kps, "jitter1": d.get("jitter1"), "jitter2": d.get("jitter2")}


def _state(module):
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}


def _trainer(spec, job, rank):
    from posfeat_tpu_torch.train import Trainer

    cfg = dict(job["config"])
    cfg["multihost"] = {
        "coordinator_address": f"localhost:{spec['port']}", "num_processes": spec["world"],
        "process_id": rank, "backend": spec.get("backend"), "timeout_s": spec.get("timeout_s", 600),
        "local_device_ids": [0] if spec["device"] == "cuda" and spec.get("backend") == "gloo" else None,
    }
    return Trainer(cfg, ckpt_root=os.path.join(spec["out"], "ckpts"), device=spec["device"], overwrite=True)


def job_step(spec, job, rank):
    import torch

    tr = _trainer(spec, job, rank)
    if job.get("batch"):
        local = {k: _rows(v, rank, spec["world"]) for k, v in np.load(job["batch"]).items()}
    else:
        it = iter(tr.train_loader)
        local = next(it)
        it.close()
    draws, pp_draws = _draws(job.get("draws"), rank, spec["world"], tr.device)
    total, comps, grad_norms, finite = tr.train_step(tr.to_device(local), 1, draws=draws, preprocess_draws=pp_draws)
    out = {"loss": np.float32(float(total)), "finite": np.bool_(finite)}
    out.update({f"batch/{k}": np.asarray(v) for k, v in local.items() if not isinstance(v, (list, tuple))})
    out.update({f"comp/{k}": np.float32(float(v)) for k, v in comps.items()})
    out.update({f"grad_norm/{m}": np.float32(float(g)) for m, g in grad_norms.items()})
    for m in tr.optimal_modules:
        mod = getattr(tr.model, m)
        out.update({f"grad/{m}/{n}": p.grad.float().cpu().numpy() for n, p in mod.named_parameters()})
        out.update({f"state/{m}/{k}": v for k, v in _state(mod).items()})
    if tr.train_backbone:  # BatchNorm's running statistics
        out.update({f"state/backbone/{k}": v for k, v in _state(tr.model.backbone).items()})
    np.savez(os.path.join(spec["out"], f"{job['name']}.rank{rank}.npz"), **out)
    if job.get("train_steps"):
        tr.config.update(epoch=1, epoch_step=int(job["train_steps"]), log_freq=1)
        tr.steps_per_epoch = int(job["train_steps"])
        if tr.device.type == "cuda":
            torch.cuda.synchronize()
        tr.train()


def job_train(spec, job, rank):
    tr = _trainer(spec, job, rank)
    if job.get("nan_rank") == rank:
        name, weight, fn = tr.loss_fns[0]

        def nan_loss(*args, **kw):
            loss, comps = fn(*args, **kw)
            return loss * float("nan"), comps

        tr.loss_fns = [(name, weight, nan_loss)] + tr.loss_fns[1:]
    out = {f"before/{m}/{k}": v for m in tr.optimal_modules for k, v in _state(getattr(tr.model, m)).items()}
    tr.train()
    out.update({f"after/{m}/{k}": v for m in tr.optimal_modules for k, v in _state(getattr(tr.model, m)).items()})
    np.savez(os.path.join(spec["out"], f"{job['name']}.rank{rank}.npz"), **out)


def job_loss(spec, job, rank):
    import torch

    from posfeat_tpu_torch.core import distributed
    from posfeat_tpu_torch.losses import LOSSES

    distributed.init_multihost({"coordinator_address": f"localhost:{spec['port']}", "num_processes": spec["world"],
                                "process_id": rank, "backend": spec.get("backend"),
                                "timeout_s": spec.get("timeout_s", 600)}, spec["device"])
    data = np.load(job["inputs"])
    rows = {k: torch.from_numpy(_rows(v, rank, spec["world"])).to(spec["device"]) for k, v in data.items()}
    inputs = {k[3:]: v for k, v in rows.items() if k.startswith("in/")}
    processed = {k[3:]: v for k, v in rows.items() if k.startswith("pp/")}
    fn = LOSSES[job["loss"]](job["config"])
    loss, comps = fn(inputs, None, processed)
    comps = distributed.reduce_components(comps, fn.COMPONENT_REDUCTIONS)
    np.savez(os.path.join(spec["out"], f"{job['name']}.rank{rank}.npz"), loss=np.float32(float(loss)),
             **{f"comp/{k}": np.float32(float(v)) for k, v in comps.items()})


def job_extract(spec, job, rank):
    import torch

    from posfeat_tpu_torch.extract import Extractor

    cfg = json.loads(json.dumps(job["config"]))
    cfg["data_config_extract"].update(num_shards=spec["world"], shard_index=rank)
    ex = Extractor(cfg, ckpt_root=os.path.join(spec["out"], "ckpts"), device=spec["device"])
    if job.get("warmup"):
        shard = ex.dataset
        ex.dataset = [shard[i] for i in range(min(int(job["warmup"]), len(shard)))]
        ex.extract()
        ex.dataset = shard
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        _file_barrier(spec, f"{job['name']}.warm", rank)
        _launches(zero=True)
    t0 = time.time()
    n, _ = ex.extract()
    if ex.device.type == "cuda":
        torch.cuda.synchronize()
    return {"images": n, "t_process": T_PROCESS, "t_extract": t0, "t_end": time.time()}


def _file_barrier(spec, name, rank, timeout=120.0):
    """Every rank waits until all have written ``<out>/<name>.<rank>``."""
    open(os.path.join(spec["out"], f"{name}.{rank}"), "w").close()
    deadline = time.time() + timeout
    while not all(os.path.exists(os.path.join(spec["out"], f"{name}.{r}")) for r in range(spec["world"])):
        if time.time() > deadline:
            raise TimeoutError(f"{name}: not every rank arrived within {timeout} s")
        time.sleep(0.01)


def _launches(zero=False):
    from posfeat_tpu_torch.ops import fused_head as fh
    from posfeat_tpu_torch.ops import reinforce as rf
    from posfeat_tpu_torch.train.launch import kernel_launches

    if zero:
        for fn in (fh.conv_phase, fh.head_tail, rf.lse_pass, rf.reward_pass):
            fn.launches = 0
    return kernel_launches()


JOBS = {"step": job_step, "train": job_train, "loss": job_loss, "extract": job_extract}


def main(argv) -> int:
    with open(argv[0]) as f:
        spec = json.load(f)
    rank = int(argv[1])
    if spec["device"] == "cpu":  # the ranks share the launcher's torch threads (or the host's cores)
        import torch

        torch.set_num_threads(max(1, (spec.get("threads") or os.cpu_count() or 1) // spec["world"]))
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        _launches(zero=True)
        rec = JOBS[job["kind"]](spec, job, rank) or {}
        rec.update(seconds=time.perf_counter() - t0, launches=_launches())
        with open(os.path.join(spec["out"], f"{job['name']}.rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        print(f"rank {rank}: {job['kind']} {job['name']} done in {rec['seconds']:.2f} s, "
              f"launches {rec['launches']}", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"RANK_OK {rank}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
