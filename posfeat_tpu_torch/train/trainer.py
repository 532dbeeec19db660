"""The trainer of both stages on one device, stage 1 (the descriptor
backbone) and stage 2 (the keypoint head) (posfeat_tpu/train/trainer.py:52-766;
reference managers/trainer.py:41-544).

  * module freezing as the reference (optimal_modules, trainer.py:78-87):
    only the optimised modules' parameters require gradients. Stage 1
    optimises the backbone, which then runs with BatchNorm in training
    mode and keeps its updated running statistics (trainer.py:490-505);
    stage 2 freezes it, in eval mode and without a graph;
  * one optimizer per module (SGD, Adam, AdamW with optax's defaults),
    the StepLR schedule stepped per update as optax counts it, optional
    per-module global-norm clipping written as optax writes it;
  * the non-finite guard: gradients are zeroed and the optimizer still
    steps, as the JAX step calls ``optimizer.update`` (trainer.py:312-323),
    so step counts advance and Adam's moments decay while the parameters
    stay as they were; BatchNorm's running statistics keep the step's
    update, as the JAX trainer writes them back on any step
    (trainer.py:501-505); the batch goes to ``error_step<N>.npz``;
  * ``compute_dtype: bfloat16`` computes in bf16 while parameters,
    BatchNorm statistics and optimizer state stay f32, as the JAX model's
    ``param_dtype=float32``; checkpoints are f32 in either dtype;
  * epoch-directory checkpoints (``<checkpoint_name>/<epoch:03d>/``) with
    ``backbone.pth``, ``localheader.pth`` and ``opt_state.pth``, ``000/``
    at the start, resume from the latest, the reference's
    ``FileExistsError`` rule, ``config.yaml``, ``metrics.jsonl`` and
    ``step_times.jsonl`` (each step's time and its wait for the loader);
  * the visual validation dumps of ``val_config`` (``val_and_vis``): six
    image folders per validation sample at every logged step, written
    after the step's timer stops; a failing dump logs a warning and never
    stops training;
  * ``multihost:`` (trainer.py:59-125, 194-206): one process per card over
    ``torch.distributed`` (``core/distributed.py``), each loading its
    equal shard of the global batch. The global batch is the ranks' local
    batches in rank order; the draws are made at its shape and each rank
    keeps its rows (``RowShard``), so a run of n ranks takes the
    one-process step on the global batch, as JAX's SPMD step does. Each
    rank's loss is its share of the global loss, the gradients are summed
    over the ranks (one flat all-reduce per module) before the non-finite
    check, the norms and the clip, the non-finite decision is global, the
    logged values are the global batch's, and stage 1's BatchNorm
    normalizes by the global batch's moments. Rank 0 alone checks for an
    existing run, writes ``config.yaml``, checkpoints, metrics,
    TensorBoard events and the visual dumps; rank i > 0 logs to
    ``logging_file.proc<i>.txt`` and dumps ``error_step<N>.proc<i>.npz``;
    every rank waits at a barrier before the first step. On one machine
    ``train/launch.py`` starts such ranks, one per device, and feeds each
    its rows of one loader's global batches (``batches``);
  * ``profile_trace_dir``: a ``torch.profiler`` trace of the first steps
    (closed after step 3, or when training stops), for TensorBoard;
  * TensorBoard events of every logged value on rank 0 where
    ``tensorboard`` imports (one warning where it does not).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import threading
import time
import types
from typing import Dict

import numpy as np
import torch

from ..core import distributed
from ..core.config import dump_config, load_config, merge_from_checkpoint
from ..core.device import cudnn_autotune, resolve_device
from ..core.logging_utils import make_logger
from ..core.profiling import StepTimer, span, trace
from ..data import DATASETS
from ..data.loader import PrefetchLoader
from ..losses import LOSSES, PREPROCESSES
from ..models import MODELS
from ..models.resunet import BatchNorm2d

_DEVICE_KEYS = (
    "im1", "im2", "F1", "F2", "pose1", "pose2",
    "intrinsic1", "intrinsic2", "coord1", "coord2",
)
# optax.adamw's default weight decay (torch.optim.AdamW defaults to 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# datasets whose per-sample draws derive from the run's seed
_SEEDED_DATASETS = ("MegaDepth_SIFT",)


def make_dataset(name: str, configs: Dict, is_train: bool, seed: int):
    """``DATASETS[name]`` on ``configs``, seeded where it draws."""
    kwargs = {"seed": seed} if name in _SEEDED_DATASETS else {}
    return DATASETS[name](configs=configs, is_train=is_train, **kwargs)


def _to_cpu(obj):
    """Deep copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return copy.deepcopy(obj)


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over all tensors."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every gradient becomes g / norm · max_norm; below it
    they stay as they are (no epsilon, unlike ``clip_grad_norm_``).
    Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Trainer:
    """Trains stage 1 (``optimal_modules: ['backbone']``,
    configs/train_desc.yaml) or stage 2 (``['localheader']``,
    configs/train_kp.yaml). ``config``: a train config dict or the path of
    its YAML file. ``device``: None for the card (under ``multihost:``,
    the rank's card). ``dataset``: an indexable of training pair dicts
    used instead of the configured dataset. ``batches``: an iterable of
    this process's batches used instead of its own loader (a launched
    rank's rows of the launcher's global batches, ``train/launch.py``).
    ``multihost``: a ``multihost:`` block used as the config's would be
    and kept out of the ``config.yaml`` the run writes (the launcher's
    localhost group).

    Any ``torch.profiler`` trace of training (``profile_trace_dir``
    among them) holds these named host ranges of each ``train_step``
    (``core/profiling.span``), on the clock of the card's kernels, and
    their totals in ``profiling.span_totals()``: ``train.forward`` (the
    model, the preprocess and the losses; ``seq`` is the step number),
    ``train.backward``, ``train.guard`` (the non-finite check, where the
    host waits for the card; under ``multihost:`` also the gradients'
    all-reduce), and inside the forward ``model.backbone`` and
    ``model.head``, once a view."""

    def __init__(self, config, ckpt_root: str = "./ckpts", overwrite: bool = False,
                 device=None, dataset=None, batches=None, multihost=None):
        if isinstance(config, str):
            config = load_config(config)
        self.device = resolve_device(device)
        # the process group comes first, before anything touches the card
        # (trainer.py:59-64)
        multihost = multihost or config.get("multihost")
        if multihost:
            self.device = distributed.rank_device(multihost, self.device)
            distributed.init_multihost(multihost, self.device)
        self.process_id = distributed.rank()
        self.num_processes = distributed.world_size()
        self.config = copy.deepcopy(merge_from_checkpoint(config))
        cfg = self.config
        self.optimal_modules = list(cfg["optimal_modules"])
        self.optimal_lrs = [float(lr) for lr in cfg["optimal_lrs"]]
        self.train_backbone = "backbone" in self.optimal_modules

        self.save_root = os.path.join(ckpt_root, cfg["checkpoint_name"])
        self.resume = bool(cfg.get("resume", False))
        if (
            self.process_id == 0
            and os.path.exists(os.path.join(self.save_root, "config.yaml"))
            and not overwrite
            and not self.resume
        ):
            raise FileExistsError(
                f"The save path {self.save_root} already exists, please change "
                "checkpoint_name (reference trainer.py:177-182 semantics) or "
                "set resume: True"
            )
        os.makedirs(self.save_root, exist_ok=True)
        if self.process_id == 0:
            dump_config(cfg, os.path.join(self.save_root, "config.yaml"))
        log_name = "logging_file.txt" if self.process_id == 0 else f"logging_file.proc{self.process_id}.txt"
        self.logger = make_logger("trainer", os.path.join(self.save_root, log_name))
        self.metrics_path = os.path.join(self.save_root, "metrics.jsonl")
        bs = int(cfg["data_config_train"]["batch_size"])
        if bs % self.num_processes:
            raise ValueError(f"multihost: global batch_size {bs} must divide the "
                             f"{self.num_processes}-device global mesh")
        if self.num_processes > 1:
            self.logger.info(f"multihost: rank {self.process_id} of {self.num_processes} on {self.device}, "
                             f"{bs // self.num_processes} of the global batch's {bs} pairs")

        # ---------------------------------------------------------- model
        seed = int(cfg.get("seed", 0))
        self.model = MODELS[cfg.get("model", "PoSFeat")](
            cfg["model_config"], dtype=_DTYPES[cfg.get("compute_dtype", "float32")],
            device=self.device, seed=seed,
        )
        load_path = cfg.get("load_path")
        if load_path and os.path.isdir(str(load_path)):
            self.model.load_checkpoint(str(load_path))
        for name in self.model.module_names:
            getattr(self.model, name).requires_grad_(name in self.optimal_modules)
        # the replicas start from rank 0's weights; stage 1's BatchNorm
        # normalizes by the global batch
        distributed.broadcast_module_(self.model)
        if self.num_processes > 1 and self.train_backbone:
            for m in self.model.backbone.modules():
                if isinstance(m, BatchNorm2d):
                    m.sync = True

        # ------------------------------------------------------ optimizer
        self.steps_per_epoch = int(cfg["epoch_step"])
        self.params = {m: list(getattr(self.model, m).parameters()) for m in self.optimal_modules}
        self.optimizers, self.schedulers = {}, {}
        for mod, lr in zip(self.optimal_modules, self.optimal_lrs):
            self.optimizers[mod] = self._make_optimizer(self.params[mod], lr)
            self.schedulers[mod] = torch.optim.lr_scheduler.LambdaLR(
                self.optimizers[mod], lambda count: self._lr_factor(count)
            )
        self.start_epoch = 1
        if self.resume:
            self._resume()

        # --------------------------------------------------------- losses
        pp_name = cfg.get("preprocess_train") or "Preprocess_Skip"
        self.preprocess = PREPROCESSES[pp_name](cfg.get("preprocess_train_config", {}))
        self.loss_fns = [
            (name, float(weight), LOSSES[name](cfg[f"{name}_config"]))
            for name, weight in zip(cfg["losses"], cfg["losses_weight"])
        ]
        # how each logged value of a rank's share reduces to the global batch's
        self._reductions = {"total": "sum", "finite": "min"}
        for name, _w, fn in self.loss_fns:
            self._reductions.update(getattr(fn, "COMPONENT_REDUCTIONS", {}), **{name: "sum"})

        # ----------------------------------------------------------- data
        dcfg = cfg["data_config_train"]
        self.batch_size = bs
        if batches is not None:
            # a launched rank: the launcher's one loader feeds it
            self.train_dataset = dataset
            self.train_loader = batches
        else:
            if dataset is None:
                dataset = make_dataset(cfg["data"], dcfg, True, seed)
            self.train_dataset = dataset
            # each rank loads its shard's share of the global batch (trainer.py:194-206)
            self.train_loader = PrefetchLoader(
                dataset, batch_size=bs // self.num_processes, shuffle=True,
                num_workers=dcfg.get("workers", 4), seed=seed, infinite=True,
                num_shards=self.num_processes, shard_index=self.process_id,
            )
        # the draws of the preprocess and the losses (the JAX trainer's
        # PRNGKey(seed + 1)), made at the global batch's shape on every rank
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._draws = (self.generator if self.num_processes == 1
                       else distributed.RowShard(self.generator, self.process_id, self.num_processes))
        self._val_samples = None
        self._ckpt_thread = None
        self._steps = 0  # train_step calls: the spans' step numbers
        self._tb = self._try_tensorboard() if self.process_id == 0 else None

    # ------------------------------------------------------------ helpers

    def _try_tensorboard(self):
        """A SummaryWriter on the run directory, or None (with a warning)
        where ``tensorboard`` cannot be imported (trainer.py:211-219)."""
        # scalars need no TensorFlow: tensorboard's own switch to its stub
        # (the module tensorboard.compat.notf, which its builds without
        # TensorFlow carry) keeps an installed TensorFlow from being imported,
        # some 10 s per process
        if "tensorflow" not in sys.modules:
            sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            self.logger.warning(f"no TensorBoard events: the tensorboard package cannot be imported ({e}); "
                                "metrics.jsonl holds every logged value")
            return None
        return SummaryWriter(self.save_root)

    def _lr_factor(self, count: int) -> float:
        """StepLR as optax counts it (trainer.py:223-232): update ``count``
        (0-based) takes base_lr · factor ** ((count // epoch_step) //
        lr_decay_step)."""
        decay_step = int(self.config["lr_decay_step"])
        factor = float(self.config["lr_decay_factor"])
        return factor ** ((count // self.steps_per_epoch) // decay_step)

    def _make_optimizer(self, params, lr: float) -> torch.optim.Optimizer:
        name = self.config.get("optimizer", "Adam")
        if name == "SGD":  # optax.sgd: no momentum
            return torch.optim.SGD(params, lr=lr)
        if name == "Adam":  # optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt
            return torch.optim.Adam(params, lr=lr)
        if name == "AdamW":
            return torch.optim.AdamW(params, lr=lr, weight_decay=ADAMW_WEIGHT_DECAY)
        raise ValueError(f"unsupported optimizer {name}")

    def _resume(self):
        """Pick up the latest epoch dir with its optimizer state."""
        epochs = sorted(
            int(d) for d in os.listdir(self.save_root)
            if d.isdigit() and os.path.isdir(os.path.join(self.save_root, d))
        )
        if not epochs:
            return
        latest = os.path.join(self.save_root, f"{epochs[-1]:03d}")
        self.model.load_checkpoint(latest)
        opt_path = os.path.join(latest, "opt_state.pth")
        if os.path.exists(opt_path):
            state = torch.load(opt_path, map_location=self.device, weights_only=True)
            for mod in self.optimal_modules:
                self.optimizers[mod].load_state_dict(state[mod]["optimizer"])
                self.schedulers[mod].load_state_dict(state[mod]["scheduler"])
        self.start_epoch = epochs[-1] + 1
        self.logger.info(f"resumed from {latest}; continuing at epoch {self.start_epoch}")

    def to_device(self, batch_np: Dict) -> Dict[str, torch.Tensor]:
        cuda = self.device.type == "cuda"
        out = {}
        for k in _DEVICE_KEYS:
            if k in batch_np:
                t = torch.from_numpy(np.ascontiguousarray(batch_np[k], np.float32))
                out[k] = (t.pin_memory() if cuda else t).to(self.device, non_blocking=True)
        return out

    # --------------------------------------------------------- train step

    def loss(self, batch: Dict[str, torch.Tensor], epoch: int, draws=None, preprocess_draws=None):
        """(total, components) of one batch on the device, with the graph
        of the optimised modules (trainer.py:276-305); the backbone's
        BatchNorm trains when the backbone is optimised. ``draws`` are
        handed to the losses and ``preprocess_draws`` to the preprocess
        instead of drawing from the trainer's generator (the preprocess
        draws first)."""
        outputs = self.model(batch, train=self.train_backbone)
        outputs["epoch"] = epoch
        processed = self.preprocess(batch, outputs, self._draws, draws=preprocess_draws)
        total, components = 0.0, {}
        for name, weight, fn in self.loss_fns:
            li, comps = fn(batch, outputs, processed, generator=self._draws, draws=draws)
            total = total + weight * li
            components[name] = li.detach()
            components.update(comps)
        return total, components

    def train_step(self, batch: Dict[str, torch.Tensor], epoch: int, draws=None,
                   preprocess_draws=None):
        """One update. Returns (total, components, grad_norms, finite).
        Under ``multihost:`` ``batch`` and given ``draws`` are this rank's
        rows of the global batch's, and the returned values are the global
        batch's. Its spans: ``train.forward``, ``train.backward`` and
        ``train.guard``, from the finite flags to the host's read of the
        decision (the wait for the card), under ``multihost:`` with the
        gradients' all-reduce and the components' reduction inside.
        The forward and the backward run their convs on the algorithms
        cuDNN's autotune measures fastest (``cudnn_autotune``): the first
        step of each conv shape in the process pays for the timing, and
        outside them cuDNN's flags are as the caller set them."""
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)
        with cudnn_autotune():
            with span("train.forward", seq=self._steps):
                total, components = self.loss(batch, epoch, draws, preprocess_draws)
            self._steps += 1
            with span("train.backward"):
                total.backward()
        grads = {}
        for mod, params in self.params.items():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads[mod] = [p.grad for p in params]
        with span("train.guard"):
            flags = [torch.isfinite(total.detach()).reshape(1)]
            flags += [torch.isfinite(g).all().reshape(1) for gs in grads.values() for g in gs]
            finite = torch.cat(flags).all()
            total = total.detach()
            if self.num_processes > 1:
                # the global gradient is the sum of the ranks' shares'; the skip
                # decision is global, so no rank steps while another skips
                for gs in grads.values():
                    distributed.all_reduce_sum_(gs)
                components = distributed.reduce_components(
                    {**components, "total": total, "finite": finite.float()}, self._reductions)
                total, finite = components.pop("total"), components.pop("finite") > 0.5
            finite = bool(finite)
        with torch.no_grad():
            if not finite:
                for gs in grads.values():
                    for g in gs:
                        g.zero_()
            grad_norms = {m: global_norm(gs) for m, gs in grads.items()}
            if self.config.get("grad_clip"):
                for gs in grads.values():
                    clip_by_global_norm_(gs, float(self.config["clip_norm"]))
            saved = None if finite else {m: [p.clone() for p in ps] for m, ps in self.params.items()}
            for mod in self.optimal_modules:
                self.optimizers[mod].step()
                self.schedulers[mod].step()
            if saved is not None:  # the JAX step masks the update itself
                for m, ps in self.params.items():
                    for p, s in zip(ps, saved[m]):
                        p.copy_(s)
        return total, components, grad_norms, finite

    # -------------------------------------------------------------- train

    def save_checkpoint(self, epoch: int, block: bool = True):
        """Write the epoch-dir checkpoint (reference trainer.py:263-267), on
        rank 0 only (the replicas are equal). ``block=False`` copies the
        state to the host on the calling thread and writes the files from a
        daemon thread; writers never overlap."""
        if self.process_id != 0:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        path = os.path.join(self.save_root, f"{epoch:03d}")
        os.makedirs(path, exist_ok=True)
        modules = {n: _to_cpu(getattr(self.model, n).state_dict()) for n in self.model.module_names}
        opt_state = _to_cpu({
            m: {"optimizer": self.optimizers[m].state_dict(),
                "scheduler": self.schedulers[m].state_dict()}
            for m in self.optimal_modules
        })

        def _write():
            for name, sd in modules.items():
                torch.save(sd, os.path.join(path, f"{name}.pth"))
            for _name, _w, fn in self.loss_fns:
                if hasattr(fn, "save_checkpoint"):
                    fn.save_checkpoint(path)
            torch.save(opt_state, os.path.join(path, "opt_state.pth"))

        if block:
            _write()
        else:
            self._ckpt_thread = threading.Thread(target=_write, daemon=True)
            self._ckpt_thread.start()

    def save_error_dump(self, batch_np: Dict, loss_val, step: int):
        name = f"error_step{step}.npz" if self.process_id == 0 else f"error_step{step}.proc{self.process_id}.npz"
        path = os.path.join(self.save_root, name)
        arrs = {k: np.asarray(v) for k, v in batch_np.items() if not isinstance(v, (str, list, tuple))}
        arrs["loss"] = np.asarray(float(loss_val))
        np.savez(path, **arrs)
        self.logger.error(f"non-finite loss at step {step}; dumped {path}")

    def _log_metrics(self, record: Dict):
        if self.process_id != 0:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            step = record["global_step"]
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "global_step":
                    self._tb.add_scalar(k, v, step)

    def train(self):
        cfg = self.config
        n_epochs = int(cfg["epoch"])
        log_freq = int(cfg.get("log_freq", 100))
        ckpt_freq = int(cfg.get("ckpt_freq", 100))
        tb_keys = cfg.get("tb_component", [])
        # the ranks line up before the first step (trainer.py:417-423)
        distributed.multihost_barrier("trainer_start")
        if self.start_epoch == 1:
            self.save_checkpoint(0)
        data_iter = iter(self.train_loader)
        global_step = (self.start_epoch - 1) * self.steps_per_epoch
        timer = StepTimer(sink_path=os.path.join(self.save_root, "step_times.jsonl"),
                          device=self.device)
        rank_tag = {"rank": self.process_id} if self.num_processes > 1 else {}
        # a device trace of the first steps (trainer.py:433-447)
        trace_dir = cfg.get("profile_trace_dir")
        open_trace = trace(trace_dir, self.device) if trace_dir else None
        if open_trace is not None:
            open_trace.__enter__()
        try:
            for epoch in range(self.start_epoch, n_epochs + 1):
                t_epoch = time.time()
                for idx in range(self.steps_per_epoch):
                    timer.start()
                    t_data = time.perf_counter()
                    batch_np = next(data_iter)
                    data_wait = time.perf_counter() - t_data
                    total, components, grad_norms, finite = self.train_step(
                        self.to_device(batch_np), epoch
                    )
                    global_step += 1
                    timer.stop(step=global_step, epoch=epoch, data_wait_s=data_wait, **rank_tag)
                    if open_trace is not None and global_step >= 3:
                        # a few steps are enough for a kernel trace
                        open_trace.__exit__(None, None, None)
                        open_trace = None
                        self.logger.info(f"device trace written to {trace_dir}")
                    if not finite:
                        self.save_error_dump(batch_np, total, global_step)
                        continue
                    if global_step % log_freq == 0 or idx == 0:
                        comps = {k: float(v) for k, v in components.items()}
                        rec = {
                            "global_step": global_step,
                            "epoch": epoch,
                            "total_loss": float(total),
                            "sec_per_step": (time.time() - t_epoch) / (idx + 1),
                            **{f"step_time/{k}": v for k, v in timer.stats().items()},
                            **{f"grad_norm/{m}": float(g) for m, g in grad_norms.items()},
                            **comps,
                        }
                        self._log_metrics(rec)
                        shown = {k: round(comps[k], 4) for k in tb_keys if k in comps}
                        self.logger.info(
                            f"epoch {epoch} step {idx} total {rec['total_loss']:.4f} "
                            f"{shown} ({rec['sec_per_step']:.3f}s/step)"
                        )
                        self.val_and_vis(epoch, global_step)
                    if global_step % ckpt_freq == 0:
                        self.save_checkpoint(epoch, block=False)
                self.save_checkpoint(epoch)
                self.logger.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
        finally:
            # an exception anywhere in the loop still closes an open trace
            if open_trace is not None:
                open_trace.__exit__(None, None, None)
            if hasattr(data_iter, "close"):
                data_iter.close()  # stops the loader's threads
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
                self._ckpt_thread = None
            if self._tb is not None:
                self._tb.flush()

    # ------------------------------------------------------ visualization

    _VIS_FOLDERS = (
        "0_original_images",
        "1_score_maps",
        "2_all_keypoints",
        "3_matched_keypoints",
        "4_matches_less",
        "5_matches_all",
    )

    def _load_val_samples(self):
        """Validation samples (reference trainer.py:136-145): drawn from
        ``val_config['data_config_val']`` when present, else the train
        set, up to ``n_vis`` (2), and cached in ``val_data.npz`` so that
        every run and every resume validates on the same samples."""
        if self._val_samples is not None:
            return self._val_samples
        path = os.path.join(self.save_root, "val_data.npz")
        if os.path.exists(path):
            self._val_samples = list(np.load(path, allow_pickle=True)["val_data"])
            return self._val_samples
        vcfg = self.config.get("val_config") or {}
        n_vis = int(vcfg.get("n_vis", 2))
        dccfg = vcfg.get("data_config_val")
        seed = int(self.config.get("seed", 0))
        if dccfg:
            ds = make_dataset(self.config["data"], dccfg, False, seed)
        elif self.train_dataset is not None:
            ds = self.train_dataset
        else:  # a launched rank holds no dataset of its own
            ds = make_dataset(self.config["data"], self.config["data_config_train"], True, seed)
        samples = []
        for i in range(len(ds)):
            s = ds[i]
            if s is not None:
                samples.append(s)
            if len(samples) >= n_vis:
                break
        self._val_samples = samples
        if not samples:
            self.logger.warning(f"val_and_vis: none of the {len(ds)} validation pairs passed the filters")
            return samples
        arr = np.empty(len(samples), dtype=object)
        for i, s in enumerate(samples):
            arr[i] = s
        np.savez(path, val_data=arr)
        return samples

    def val_and_vis(self, epoch: int, step: int):
        """Visual validation dumps (reference trainer.py:380-544), the
        reference's stopping criterion for stage 2 (README.md:72-77): per
        validation sample the original pair, the score maps, all
        keypoints, the matched keypoints, the top-k matches and all
        matches coloured by epipolar error, as ``vis/sample<i>/<folder>/
        <step>.jpg``. ``val_config['detector']`` is honoured: ``'sift'``
        (train_desc.yaml) takes the sample's query points with unit
        scores, ``generate_kpts_single`` (train_kp.yaml) detects on the
        f32 score map. A failure is logged and training goes on."""
        vcfg = self.config.get("val_config")
        if not vcfg or self.process_id != 0:
            return
        try:
            with torch.no_grad():
                for si, sample in enumerate(self._load_val_samples()):
                    self._vis_sample(si, sample, vcfg, step)
        except Exception as e:  # a dump never stops training
            self.logger.warning(f"val_and_vis failed: {e}", exc_info=True)

    def _vis_sample(self, si: int, sample: Dict, vcfg: Dict, step: int):
        import cv2

        from ..data.utils import tensor2array
        from ..ops.coords import denormalize_coords, normalize_coords
        from ..ops.detect import DETECTORS
        from ..ops.grid_sample import sample_feat_by_coord
        from ..ops.matchers import mnn_matcher

        mid_pad = 20  # reference trainer.py:385
        # the two images of a MegaDepth pair may differ in size: each
        # image's coordinates use its own dims, the canvases pad to the
        # larger height
        dims = {t: sample[t].shape[:2] for t in ("im1", "im2") if t in sample}
        sample_dir = os.path.join(self.save_root, "vis", f"sample{si}")
        for folder in self._VIS_FOLDERS:
            os.makedirs(os.path.join(sample_dir, folder), exist_ok=True)

        outs = {}
        for tag in ("im1", "im2"):
            if tag not in sample:
                return
            im = torch.from_numpy(np.ascontiguousarray(sample[tag], np.float32))[None]
            outs[tag] = self.model.extract(im.to(self.device))

        cos = vcfg.get("loss_distance", "cos") == "cos"
        det_name = vcfg.get("detector", "sift")
        feats = {}
        for tag, ctag in (("im1", "coord1"), ("im2", "coord2")):
            o = outs[tag]
            h, w = dims[tag]
            if det_name == "sift":
                # SIFT passthrough (reference trainer.py:459-466): the
                # sample's query points, unit scores
                kps = np.asarray(sample[ctag], np.float32)[:, :2]
                score = np.ones((len(kps), 1), np.float32)
                kps_n = normalize_coords(torch.from_numpy(kps).to(self.device)[None], h, w)
            else:
                det_cfg = dict(
                    vcfg.get("detector_config")
                    or {"num_pts": 512, "nms_radius": 1, "use_nms": True, "thr": False}
                )
                det_cfg.pop("scale", None)
                kps_n, score_t, valid = DETECTORS[det_name](o["local_point"].float(), **det_cfg)
                n = max(min(int(valid[0]), kps_n.shape[1]), 8)
                kps_n = kps_n[:, :n]
                kps = denormalize_coords(kps_n, h, w)[0].float().cpu().numpy()
                score = score_t[0, :n].float().cpu().numpy()
            desc = sample_feat_by_coord(o["local_map"], kps_n, cos)[0].float().cpu().numpy()
            feats[tag] = (kps, score, desc)

        k1, s1, d1 = feats["im1"]
        k2, s2, d2 = feats["im2"]
        matches = mnn_matcher(d1, d2, device=self.device)
        mk1 = k1[matches[:, 0]] if len(matches) else np.zeros((0, 2), np.float32)
        mk2 = k2[matches[:, 1]] if len(matches) else np.zeros((0, 2), np.float32)
        mscore = (s1[matches[:, 0], 0] + s2[matches[:, 1], 0] if len(matches)
                  else np.zeros((0,), np.float32))
        topk = min(int(vcfg.get("vis_topk", 50)), len(matches))
        topk_idx = np.argsort(-mscore)[:topk]

        # epipolar error of the matched pairs, clamped (reference :491-500)
        thr_px = float(vcfg.get("vis_err_thr", 5))
        F12 = np.asarray(sample["F1"], np.float64)
        if len(matches):
            p1h = np.concatenate([mk1, np.ones((len(mk1), 1))], 1)
            lines = p1h @ F12.T  # epipolar lines in image 2
            lines = lines / np.maximum(np.linalg.norm(lines[:, :2], axis=1, keepdims=True), 1e-8)
            p2h = np.concatenate([mk2, np.ones((len(mk2), 1))], 1)
            epi_dist = np.clip(np.abs((p2h * lines).sum(1)), 0, thr_px)
        else:
            epi_dist = np.zeros((0,))
        # RdYlGn: green is a small error (reference :502-506)
        colors = tensor2array((thr_px - epi_dist)[:, None], max_value=thr_px, colormap="RdYlGn")
        colors = (255 * colors[:, :, 0].T).astype(np.uint8)  # [m, 3] RGB

        im1 = np.asarray(sample["im1_ori"], np.uint8)
        im2 = np.asarray(sample["im2_ori"], np.uint8)
        hmax = max(im1.shape[0], im2.shape[0])

        def vpad(a, h_to):  # bottom-pad to the canvas height
            return np.pad(a, ((0, h_to - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))

        gap = np.zeros((hmax, mid_pad, 3), np.uint8)
        comb = np.concatenate([vpad(im1, hmax), gap, vpad(im2, hmax)], axis=1)

        def save(folder, img_rgb):
            cv2.imwrite(os.path.join(sample_dir, folder, f"{step}.jpg"),
                        cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR))

        save("0_original_images", comb)

        sc1 = outs["im1"]["local_point"][0, :, :, 0].float().cpu().numpy()
        sc2 = outs["im2"]["local_point"][0, :, :, 0].float().cpu().numpy()
        shmax = max(sc1.shape[0], sc2.shape[0])
        sgap = np.zeros((shmax, mid_pad), np.float32)
        comb_score = np.concatenate([vpad(sc1, shmax), sgap, vpad(sc2, shmax)], axis=1)
        save("1_score_maps", (255 * tensor2array(comb_score).transpose(1, 2, 0)).astype(np.uint8))

        x_off = im1.shape[1] + mid_pad
        green = (0, 255, 0)
        img = comb.copy()
        for x, y in k1:
            cv2.circle(img, (int(x), int(y)), 2, green, -1)
        for x, y in k2:
            cv2.circle(img, (int(x) + x_off, int(y)), 2, green, -1)
        save("2_all_keypoints", img)

        img = comb.copy()
        for (x1p, y1p), (x2p, y2p) in zip(mk1, mk2):
            cv2.circle(img, (int(x1p), int(y1p)), 2, green, -1)
            cv2.circle(img, (int(x2p) + x_off, int(y2p)), 2, green, -1)
        save("3_matched_keypoints", img)

        def draw_matches(idxs):
            img = comb.copy()
            for mi in idxs:
                p1 = (int(mk1[mi][0]), int(mk1[mi][1]))
                p2 = (int(mk2[mi][0]) + x_off, int(mk2[mi][1]))
                cv2.line(img, p1, p2, tuple(int(c) for c in colors[mi]), 2)
                cv2.circle(img, p1, 2, green, -1)
                cv2.circle(img, p2, 2, green, -1)
            return img

        # 4: the top-k matches by summed keypoint score; 5: all matches
        save("4_matches_less", draw_matches(topk_idx))
        save("5_matches_all", draw_matches(range(len(matches))))
