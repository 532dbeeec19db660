"""The trainer of both stages on one device (posfeat_tpu/train/trainer.py:52-551;
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
  * epoch-directory checkpoints (``<checkpoint_name>/<epoch:03d>/``) with
    ``backbone.pth``, ``localheader.pth`` and ``opt_state.pth``, ``000/``
    at the start, resume from the latest, the reference's
    ``FileExistsError`` rule, ``config.yaml``, ``metrics.jsonl`` and
    ``step_times.jsonl``.

Not ported yet (ROADMAP.md): bf16 training, ``multihost:``
(slice E), the visual validation dumps ``val_and_vis``, device traces
(``profile_trace_dir``) and the TensorBoard writer (metrics.jsonl holds
every logged value).
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..core.config import dump_config, load_config, merge_from_checkpoint
from ..core.device import resolve_device
from ..core.logging_utils import make_logger
from ..core.profiling import StepTimer
from ..data import DATASETS
from ..data.loader import PrefetchLoader
from ..losses import LOSSES, PREPROCESSES
from ..models import MODELS

_DEVICE_KEYS = (
    "im1", "im2", "F1", "F2", "pose1", "pose2",
    "intrinsic1", "intrinsic2", "coord1", "coord2",
)
# optax.adamw's default weight decay (torch.optim.AdamW defaults to 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4


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
    """``config``: a train config dict or the path of its YAML file.
    ``device``: None for the card. ``dataset``: an indexable of training
    pair dicts used instead of the configured dataset."""

    def __init__(self, config, ckpt_root: str = "./ckpts", overwrite: bool = False,
                 device=None, dataset=None):
        if isinstance(config, str):
            config = load_config(config)
        if config.get("multihost"):
            raise NotImplementedError("multihost: not ported yet; see ROADMAP.md slice E")
        self.config = copy.deepcopy(merge_from_checkpoint(config))
        cfg = self.config
        for key in ("profile_trace_dir",):
            if cfg.get(key):
                raise NotImplementedError(f"{key}: not ported yet; see ROADMAP.md")
        if cfg.get("compute_dtype", "float32") != "float32":
            raise NotImplementedError(
                "bf16 training: the bf16 head and its fused kernels have no backward; "
                "see ROADMAP.md"
            )
        self.optimal_modules = list(cfg["optimal_modules"])
        self.optimal_lrs = [float(lr) for lr in cfg["optimal_lrs"]]
        self.train_backbone = "backbone" in self.optimal_modules
        self.device = resolve_device(device)

        self.save_root = os.path.join(ckpt_root, cfg["checkpoint_name"])
        self.resume = bool(cfg.get("resume", False))
        if (
            os.path.exists(os.path.join(self.save_root, "config.yaml"))
            and not overwrite
            and not self.resume
        ):
            raise FileExistsError(
                f"The save path {self.save_root} already exists, please change "
                "checkpoint_name (reference trainer.py:177-182 semantics) or "
                "set resume: True"
            )
        os.makedirs(self.save_root, exist_ok=True)
        dump_config(cfg, os.path.join(self.save_root, "config.yaml"))
        self.logger = make_logger("trainer", os.path.join(self.save_root, "logging_file.txt"))
        self.metrics_path = os.path.join(self.save_root, "metrics.jsonl")

        # ---------------------------------------------------------- model
        seed = int(cfg.get("seed", 0))
        self.model = MODELS[cfg.get("model", "PoSFeat")](
            cfg["model_config"], dtype=torch.float32, device=self.device, seed=seed
        )
        load_path = cfg.get("load_path")
        if load_path and os.path.isdir(str(load_path)):
            self.model.load_checkpoint(str(load_path))
        for name in self.model.module_names:
            getattr(self.model, name).requires_grad_(name in self.optimal_modules)

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

        # ----------------------------------------------------------- data
        dcfg = cfg["data_config_train"]
        if dataset is None:
            if cfg["data"] not in DATASETS:
                raise NotImplementedError(
                    f"dataset {cfg['data']}: not ported yet (MegaDepth_SIFT waits for "
                    "MegaDepth files); pass dataset= or use SyntheticPairs; see ROADMAP.md"
                )
            dataset = DATASETS[cfg["data"]](configs=dcfg, is_train=True)
        self.train_dataset = dataset
        self.batch_size = int(dcfg["batch_size"])
        self.train_loader = PrefetchLoader(
            dataset, batch_size=self.batch_size, shuffle=True,
            num_workers=dcfg.get("workers", 4), seed=seed, infinite=True,
        )
        # the draws of the preprocess and the losses (the JAX trainer's PRNGKey(seed + 1))
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        if cfg.get("val_config"):
            self.logger.warning("val_and_vis is not ported yet (ROADMAP.md): no visual dumps")
        self._ckpt_thread = None

    # ------------------------------------------------------------ helpers

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
        processed = self.preprocess(batch, outputs, self.generator, draws=preprocess_draws)
        total, components = 0.0, {}
        for name, weight, fn in self.loss_fns:
            li, comps = fn(batch, outputs, processed, generator=self.generator, draws=draws)
            total = total + weight * li
            components[name] = li.detach()
            components.update(comps)
        return total, components

    def train_step(self, batch: Dict[str, torch.Tensor], epoch: int, draws=None,
                   preprocess_draws=None):
        """One update. Returns (total, components, grad_norms, finite)."""
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)
        total, components = self.loss(batch, epoch, draws, preprocess_draws)
        total.backward()
        grads = {}
        for mod, params in self.params.items():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads[mod] = [p.grad for p in params]
        flags = [torch.isfinite(total.detach()).reshape(1)]
        flags += [torch.isfinite(g).all().reshape(1) for gs in grads.values() for g in gs]
        finite = bool(torch.cat(flags).all())
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
        return total.detach(), components, grad_norms, finite

    # -------------------------------------------------------------- train

    def save_checkpoint(self, epoch: int, block: bool = True):
        """Write the epoch-dir checkpoint (reference trainer.py:263-267).
        ``block=False`` copies the state to the host on the calling thread
        and writes the files from a daemon thread; writers never overlap."""
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
        path = os.path.join(self.save_root, f"error_step{step}.npz")
        arrs = {k: np.asarray(v) for k, v in batch_np.items() if not isinstance(v, (str, list, tuple))}
        arrs["loss"] = np.asarray(float(loss_val))
        np.savez(path, **arrs)
        self.logger.error(f"non-finite loss at step {step}; dumped {path}")

    def _log_metrics(self, record: Dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self):
        cfg = self.config
        n_epochs = int(cfg["epoch"])
        log_freq = int(cfg.get("log_freq", 100))
        ckpt_freq = int(cfg.get("ckpt_freq", 100))
        tb_keys = cfg.get("tb_component", [])
        if self.start_epoch == 1:
            self.save_checkpoint(0)
        data_iter = iter(self.train_loader)
        global_step = (self.start_epoch - 1) * self.steps_per_epoch
        timer = StepTimer(sink_path=os.path.join(self.save_root, "step_times.jsonl"),
                          device=self.device)
        try:
            for epoch in range(self.start_epoch, n_epochs + 1):
                t_epoch = time.time()
                for idx in range(self.steps_per_epoch):
                    timer.start()
                    batch_np = next(data_iter)
                    total, components, grad_norms, finite = self.train_step(
                        self.to_device(batch_np), epoch
                    )
                    global_step += 1
                    timer.stop(step=global_step, epoch=epoch)
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
                    if global_step % ckpt_freq == 0:
                        self.save_checkpoint(epoch, block=False)
                self.save_checkpoint(epoch)
                self.logger.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
        finally:
            data_iter.close()  # stops the loader's threads
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
                self._ckpt_thread = None
