"""Training over every local device from one command: the port's
counterpart of the JAX trainer's single-process data-parallel mesh
(posfeat_tpu/train/trainer.py:99-125).

Without ``multihost:`` the JAX trainer spreads its global batch over the
largest count n of local devices that divides it, with one host loader
whose batches it splits over the devices (posfeat_tpu/core/mesh.py:94-113,
``shard_batch``). ``launch`` does the same with n processes, one per
device, spawned from this one:

- rank r is a ``multihost:`` rank (``core/distributed.py``) on
  ``devices[r]`` over a localhost process group: ``nccl`` where the
  devices are distinct cards, ``gloo`` where the CPU or one card is
  listed more than once;
- this process runs the one ``PrefetchLoader`` of the run (one shard,
  the one-process run's loader) and hands rank r rows r·b/n .. (r+1)·b/n
  of each global batch of b through a shared-memory queue; so the ranks
  take the one-process run's batches even where the dataset filters
  pairs that only decoding finds (``MegaDepth_SIFT``), which no per-rank
  index rule reproduces;
- the ranks draw at the global batch's shape and keep their rows, sum
  their gradients and normalize BatchNorm by the global batch's moments
  (``Trainer``'s ``multihost:`` path), so the run takes the one-process
  run's steps on the global batch, as JAX's n-device mesh does;
- a rank that fails ends the run: the others are stopped and ``launch``
  raises.

At n = 1 the one-process ``Trainer`` runs in this process. Each step's
wait for the loader stays in ``step_times.jsonl`` on every rank (there:
the wait for the queue).
"""

from __future__ import annotations

import queue
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import distributed
from ..core.config import load_config
from ..data.loader import PrefetchLoader, batch_rows
from .trainer import Trainer, make_dataset

# global batches a rank's queue holds ahead of its step
QUEUE_BATCHES = 2
# seconds between the feeder's looks at the ranks while a queue is full
POLL_S = 0.1


def data_parallel_count(batch_size: int, n_devices: int) -> int:
    """The largest device count not above ``n_devices`` that divides
    ``batch_size`` (posfeat_tpu/train/trainer.py:118-122)."""
    n = n_devices
    while batch_size % n:
        n -= 1
    return n


def local_devices(devices: Sequence = None) -> List[torch.device]:
    """``devices`` as torch devices, or every visible card. With no card
    and no devices given it raises: training does not move to the CPU on
    its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible: give the devices (e.g. ['cpu', 'cpu']), or train in one "
                               "process on the CPU with --device cpu")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("launch needs at least one device")
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d for d in devs]


def _shared(batch: Dict) -> Dict:
    """Numeric arrays as tensors, which the queue moves through shared
    memory; names and pads as they are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"
            else v for k, v in batch.items()}


def _queued_batches(q):
    """A rank's batches from its queue, as numpy (what the loader yields)."""
    while True:
        item = q.get()
        yield {k: v.numpy() if torch.is_tensor(v) else v for k, v in item.items()}


def kernel_launches() -> Dict[str, int]:
    """This process's launches of the hand-written kernels a training run
    can reach (the fused head's, the REINFORCE reduction's)."""
    from ..ops import fused_head as fh
    from ..ops import reinforce as rf

    return {"K1 conv_phase": fh.conv_phase.launches, "K2 head_tail": fh.head_tail.launches,
            "K4+K5 lse_pass": rf.lse_pass.launches, "K6 reward_pass": rf.reward_pass.launches}


def _rank(rank: int, world: int, device: str, backend: str, port: int, config: Dict, ckpt_root: str,
          overwrite: bool, q, records, threads: int) -> None:
    """One spawned rank: a ``multihost:`` Trainer fed from ``q``; its
    record (seconds, kernel launches) goes to ``records``. On the CPU it
    takes its share of ``threads``, the launcher's torch thread count."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, threads // world))
    mh = distributed.local_multihost(rank, world, device, port, backend)
    try:
        Trainer(config, ckpt_root=ckpt_root, overwrite=overwrite, device=device, batches=_queued_batches(q),
                multihost=mh).train()
    finally:
        if distributed.is_initialized():
            torch.distributed.destroy_process_group()
    records.put({"rank": rank, "device": device, "seconds": time.perf_counter() - t0,
                 "launches": kernel_launches()})


def launch(config, devices: Sequence = None, ckpt_root: str = "./ckpts", overwrite: bool = False,
           dataset=None) -> Dict:
    """Trains ``config`` (a train config dict or the path of its YAML) over
    the largest count of ``devices`` (every visible card by default) that
    divides its batch. ``dataset`` replaces the configured dataset in the
    launcher's loader, as ``Trainer``'s does. Returns the plan (the
    devices used, their count among those given, the backend) and, over
    several ranks, each rank's record (``ranks``: seconds in its process,
    the kernels' launches)."""
    if isinstance(config, str):
        config = load_config(config)
    if config.get("multihost"):
        raise ValueError("the config has a multihost: block, the multi-host path: start one process per rank "
                         "with it (tools/multihost_torch.py, or the CLI with --device); the launcher starts "
                         "its own ranks on this machine's devices")
    devs = local_devices(devices)
    bs = int(config["data_config_train"]["batch_size"])
    n = data_parallel_count(bs, len(devs))
    plan = {"devices": [str(d) for d in devs[:n]], "of": len(devs),
            "backend": distributed.local_backend(devs[:n]) if n > 1 else None}
    print(f"data-parallel over {n} of {len(devs)} device(s)"
          + (f": {plan['devices']}, backend {plan['backend']}" if n > 1 else f": {plan['devices'][0]}"), flush=True)
    if n == 1:
        Trainer(config, ckpt_root=ckpt_root, overwrite=overwrite, device=devs[0], dataset=dataset).train()
        return plan

    seed = int(config.get("seed", 0))
    dcfg = config["data_config_train"]
    if dataset is None:
        dataset = make_dataset(config["data"], dcfg, True, seed)
    # the one-process run's loader
    loader = PrefetchLoader(dataset, batch_size=bs, shuffle=True, num_workers=dcfg.get("workers", 4), seed=seed,
                            infinite=True)
    ctx = torch.multiprocessing.get_context("spawn")
    queues = [ctx.Queue(QUEUE_BATCHES) for _ in range(n)]
    records = ctx.Queue()
    port = distributed.free_port()
    procs = [ctx.Process(target=_rank, args=(r, n, plan["devices"][r], plan["backend"], port, config, ckpt_root,
                                             overwrite, queues[r], records, torch.get_num_threads()))
             for r in range(n)]
    batches = iter(loader)
    try:
        for p in procs:
            p.start()
        pending = [None] * n  # each rank's rows of the current global batch, until its queue takes them
        while True:
            codes = [p.exitcode for p in procs]
            failed = {r: c for r, c in enumerate(codes) if c not in (None, 0)}
            if failed:
                raise RuntimeError(f"launch: rank(s) {sorted(failed)} failed (exit codes {failed}); "
                                   "the other ranks were stopped")
            if all(c == 0 for c in codes):
                break
            if all(x is None for x in pending):
                batch = next(batches)
                pending = [_shared(batch_rows(batch, r, n)) for r in range(n)]
            for r, p in enumerate(procs):
                if pending[r] is None:
                    continue
                if p.exitcode == 0:  # a rank done with its steps takes no more
                    pending[r] = None
                    continue
                try:
                    queues[r].put(pending[r], timeout=POLL_S)
                    pending[r] = None
                except queue.Full:
                    pass
    finally:
        batches.close()
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join()
        for q in queues:
            q.cancel_join_thread()
    plan["ranks"] = sorted((records.get(timeout=10) for _ in range(n)), key=lambda rec: rec["rank"])
    return plan


__all__ = ["data_parallel_count", "kernel_launches", "launch", "local_devices"]
