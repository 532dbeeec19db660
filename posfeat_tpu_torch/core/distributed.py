"""Multi-process training over ``torch.distributed``: the port's
counterpart of posfeat_tpu/core/mesh.py (``init_multihost``,
``multihost_barrier``) and of the SPMD step's global batch.

One process per card (or, with ``backend: gloo``, several on one card or
on the CPU). The JAX trainer shards the global batch over a mesh and lets
XLA insert the collectives; here each rank holds an equal share of the
global batch, computes its share of the global loss (``mean_share``), and
the trainer sums the gradients (``all_reduce_sum_``). Quantities that JAX
reduces over the global batch are reduced here across ranks:
``global_mean`` for the losses' detached normalisers, ``reduce_components``
for the logged values, ``all_reduce_autograd`` for BatchNorm's moments.

At world size 1 (no process group) every helper returns its input's own
reduction, so a one-process run is bit-equal to a run without this
module.
"""

from __future__ import annotations

import datetime
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

# JAX's coordination barrier waits 600 s (posfeat_tpu/core/mesh.py:52)
DEFAULT_TIMEOUT_S = 600.0
REDUCTIONS = ("sum", "mean", "max", "min")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank_device(cfg: Dict, device: torch.device) -> torch.device:
    """The rank's card: ``cuda:<local_device_ids[0]>``, else
    ``cuda:<process_id % cards>``; a CPU device stays as it is."""
    if device.type != "cuda":
        return device
    ids = cfg.get("local_device_ids")
    index = int(ids[0]) if ids else int(cfg["process_id"]) % torch.cuda.device_count()
    return torch.device("cuda", index)


def free_port() -> int:
    """A free TCP port on localhost (from a bound socket, so two runs of
    one machine do not pick the same)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_backend(devices: List[torch.device]) -> str:
    """The process group's backend for ranks on ``devices``, one each:
    ``nccl`` where they are distinct cards; ``gloo`` where the CPU or one
    card is listed more than once (NCCL refuses two ranks on one card)."""
    cards = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def local_multihost(rank: int, world: int, device, port: int, backend: str,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Dict:
    """The ``multihost:`` block of rank ``rank`` of ``world`` ranks on this
    machine, over a localhost process group at ``port``."""
    device = torch.device(device)
    return {"coordinator_address": f"localhost:{port}", "num_processes": world, "process_id": rank,
            "backend": backend, "timeout_s": timeout_s,
            "local_device_ids": [device.index or 0] if device.type == "cuda" else None}


def init_multihost(cfg: Dict, device) -> int:
    """``torch.distributed.init_process_group`` from a ``multihost:`` block;
    returns this process's rank. Idempotent, as JAX's is (mesh.py:33-50).

    Keys: ``coordinator_address`` ("host:port" of rank 0, as
    ``tcp://host:port``), ``num_processes`` (the world size),
    ``process_id`` (the rank), optional ``local_device_ids`` (the rank's
    card, its first entry), ``backend`` (default ``nccl`` on the card and
    ``gloo`` on the CPU; ``gloo`` puts several ranks on one card, which
    NCCL refuses) and ``timeout_s`` (default 600: a rank whose peer died
    raises after it instead of hanging). The port reads no cluster
    environment, so the first three are required."""
    if is_initialized():
        return dist.get_rank()
    missing = [k for k in ("coordinator_address", "num_processes", "process_id") if cfg.get(k) is None]
    if missing:
        raise ValueError(f"multihost: {missing} must be set (the port reads no cluster environment)")
    device = torch.device(device)
    backend = cfg.get("backend") or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(cfg, device))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{cfg['coordinator_address']}",
        world_size=int(cfg["num_processes"]),
        rank=int(cfg["process_id"]),
        timeout=datetime.timedelta(seconds=float(cfg.get("timeout_s", DEFAULT_TIMEOUT_S))),
    )
    return dist.get_rank()


def multihost_barrier(name: str) -> None:
    """Every rank waits here (``name`` labels the call site); a no-op
    without a process group."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


@torch.no_grad()
def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Sums each tensor over the ranks in place, through one flat buffer
    per dtype (one collective for a module's gradients)."""
    if world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward sums
    the ranks' gradients, so each rank's input receives the gradient of
    the global loss. ``torch.distributed.nn.functional.all_reduce`` is an
    ``autograd.Function`` with exactly that backward on every backend and
    torch version the port runs on; it warns that it is deprecated in
    favour of ``_functional_collectives``, a private module whose
    all-reduce gained its backward only in recent releases."""
    if world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


@torch.no_grad()
def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every rank's elements (its sum and count
    all-reduced), without a graph; ``x.mean()`` at world size 1."""
    if world_size() == 1:
        return x.mean()
    s = torch.stack([x.sum(dtype=torch.float32), torch.tensor(float(x.numel()), device=x.device)])
    dist.all_reduce(s)
    return (s[0] / s[1]).to(x.dtype)


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()`` over every rank's elements, without a graph."""
    s = x.sum()
    if world_size() > 1:
        dist.all_reduce(s)
    return s


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch:
    ``x.sum() / (x.numel() · world)``, so that the ranks' shares sum to
    the global mean (ranks hold equal shares of the global batch);
    ``x.mean()`` at world size 1."""
    world = world_size()
    return x.mean() if world == 1 else x.sum() / (x.numel() * world)


@torch.no_grad()
def reduce_components(values: Dict[str, torch.Tensor], rules: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Each scalar of ``values`` reduced over the ranks by its rule in
    ``rules`` ('sum' of the ranks' shares, 'mean' of equal shares, 'max',
    'min'): one collective per rule. Unchanged at world size 1."""
    if world_size() == 1:
        return values
    unknown = sorted(set(values) - set(rules))
    if unknown:
        raise KeyError(f"no cross-rank reduction is declared for {unknown}")
    out = dict(values)
    ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    for rule in REDUCTIONS:
        keys = [k for k in values if rules[k] == rule]
        if not keys:
            continue
        flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(flat, op=ops[rule])
        if rule == "mean":
            flat = flat / world_size()
        for k, v in zip(keys, flat):
            out[k] = v
    return out


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copies rank ``src``'s parameters and buffers into every rank's
    ``module``, so that the replicas start equal."""
    if world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


class RowShard:
    """A generator whose draws are made at the global batch's shape and
    cut to this rank's rows: rank r of n, holding b rows, keeps rows
    [r·b, (r+1)·b) of a draw of n·b. Every rank seeds its generator
    alike, so the ranks' draws together are a one-process run's draws on
    the global batch, as JAX's one key is under SPMD."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world

    def rand(self, shape, device=None, dtype=torch.float32) -> torch.Tensor:
        b = shape[0]
        u = torch.rand((b * self.world, *shape[1:]), generator=self.generator, device=device, dtype=dtype)
        return u[self.rank * b:(self.rank + 1) * b]


def uniform(shape, generator, device=None, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` (batch first) from a ``torch.Generator``
    or a ``RowShard``."""
    if isinstance(generator, RowShard):
        return generator.rand(shape, device=device, dtype=dtype)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)
