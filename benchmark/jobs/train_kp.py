"""The stage-2 training window: ``posfeat_tpu_torch.train.Trainer.train_step``
on the benchmark's batches of seeded image pairs with their fundamental
matrices, the draws handed to it. The loader is outside the window.

Set-up builds one Trainer and drives it through its first three steps
on three distinct batches, through the same call the window makes; the
window then goes on with the same object. Before each of its steps the
window copies the head into a ring of three, so that its last three
steps can be followed too: SGD without momentum keeps no other state.
The check has the plain reference (``reference/stage2.py``) follow both
runs of three steps, from the same weights, batches and draws (the
window's from the head the program held before them), and compares
each step's loss, the first gradient as SGD got it ((head before −
head after the first step) / lr), and the head's change after the
three steps; each number is the worse of the two runs."""

from __future__ import annotations

import collections
import copy
import gc
import statistics
import time

import torch

from .. import traffic as gen_traffic
from .. import weights as gen_weights
from ..counts import model as model_counts
from ..harness import stage
from ..reference import full_f32, quant
from ..reference import stage2

CHECKED_STEPS = 3


def program_config(config: dict, traffic: dict) -> dict:
    """The Trainer's config: the configuration's model and numerics, the
    mix's stage-2 recipe (``traffic['trainer']``) and batch."""
    cfg = copy.deepcopy(traffic["trainer"])
    cfg.update({"model": config["model"], "model_config": copy.deepcopy(config["model_config"]),
                "compute_dtype": config["compute_dtype"], "checkpoint_name": "bench"})
    cfg["data_config_train"] = {"batch_size": traffic["batch_size"], "workers": 1}
    return cfg


def norm_gaps(prog: dict, refs: dict, keep: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median kept leaf,
    whichever is larger."""
    rn = {k: torch.linalg.vector_norm(refs[k].float()).item() for k in keep}
    pn = {k: torch.linalg.vector_norm(prog[k].float()).item() for k in keep}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep)


def moved_leaves(grad: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's norm (a bias under an instance norm
    has none)."""
    norms = {k: torch.linalg.vector_norm(g.float()).item() for k, g in grad.items()}
    med = statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= 1e-3 * med)


class Job:
    unit = "pairs"

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.H, self.W = self.tr["height"], self.tr["width"]
        self.trainer = None

    # ------------------------------------------------------------ set-up

    def _inputs(self, seed: int):
        dev, tr = self.ctx.device, self.tr
        params = gen_weights.make(self.ctx.config["model_config"], seed, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED2)
        batches = gen_traffic.pair_batches(gen, tr["pool_batches"], tr["batch_size"], self.H, self.W,
                                           tr["max_rotation"], dev)
        draws = [gen_traffic.cell_draws(gen, tr["batch_size"], self.H, self.W,
                                        tr["trainer"]["DiskLoss_config"]["grid_size"], tr["accept_p"], dev)
                 for _ in batches]
        return params, batches, draws

    def _head(self) -> dict:
        return {k: v.detach().clone() for k, v in self.trainer.model.localheader.named_parameters()}

    def _lr(self) -> float:
        return float(self.trainer.optimizers["localheader"].param_groups[0]["lr"])

    def _first_steps(self) -> None:
        """Load this seed's weights and run the checked steps."""
        model = self.trainer.model
        model.backbone.load_state_dict(gen_weights.module_state(self.params, "backbone"))
        model.localheader.load_state_dict(gen_weights.module_state(self.params, "localheader"))
        self.first = {"batches": list(range(CHECKED_STEPS)), "lrs": [], "losses": [], "heads": [self._head()]}
        self.last = None
        for s in range(CHECKED_STEPS):
            self.first["lrs"].append(self._lr())
            total, _comp, _norms, finite = self.trainer.train_step(self.batches[s], 1, draws=self.draws[s])
            self.first["losses"].append(float(total))
            self.first["heads"].append(self._head())

    def setup(self) -> None:
        t = time.perf_counter()
        from posfeat_tpu_torch.train import Trainer

        self.params, self.batches, self.draws = self._inputs(self.ctx.seed)
        t = stage("import, weights and pairs", t)
        self.trainer = Trainer(program_config(self.ctx.config, self.tr), ckpt_root=self.ctx.tmp,
                               overwrite=True, device=self.ctx.device, batches=iter(()))
        t = stage("Trainer", t)
        self._first_steps()
        stage("the checked steps", t)
        self.next_batch = CHECKED_STEPS

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        names, params = zip(*self.trainer.model.localheader.named_parameters())
        ring = [[torch.empty_like(p) for p in params] for _ in range(CHECKED_STEPS)]
        log = collections.deque(maxlen=CHECKED_STEPS)  # (ring slot, batch, lr, loss) of the last steps
        steps, bad = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = self.next_batch % len(self.batches)
            slot = steps % CHECKED_STEPS
            with torch.no_grad():
                for r, p in zip(ring[slot], params):
                    r.copy_(p)
            lr = self._lr()
            total, _comp, _norms, finite = self.trainer.train_step(self.batches[i], 1, draws=self.draws[i])
            log.append((slot, i, lr, total))
            self.next_batch += 1
            steps += 1
            bad += not finite
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        heads = [dict(zip(names, ring[slot])) for slot, _i, _lr, _t in log]
        self.last = {"batches": [i for _s, i, _lr, _t in log], "lrs": [lr for _s, _i, lr, _t in log],
                     "losses": [float(t) for _s, _i, _lr, t in log], "heads": heads + [self._head()]}
        B = self.tr["batch_size"]
        return {"units": steps * B, "seconds": elapsed, "attempted": steps, "failed": bad}

    def end_to_end(self, win: dict) -> dict:
        return {"train_pairs_per_s": win["units"] / win["seconds"]}

    def layers(self) -> dict:
        return {"backbone": self.trainer.model.backbone, "localheader": self.trainer.model.localheader}

    def trace_info(self, win: dict) -> dict:
        g = self.tr["trainer"]["DiskLoss_config"]["grid_size"]
        m = (self.H // g) * (self.W // g)
        D = self.ctx.config["model_config"]["backbone_config"]["fine_out_ch"]
        B = self.tr["batch_size"]
        mc = self.ctx.config["model_config"]
        return {
            "units": win["units"], "batch": B, "height": self.H, "width": self.W, "m": m, "n": m, "D": D,
            "flops_per_unit": model_counts.train_kp_flops(self.H, self.W, mc, B, m, m, D) / B,
            "peak_flops": self.ctx.config["peak_flops"],
        }

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _reference(self, run: dict, precision=None, pairs=None):
        """The reference's steps of ``run`` (set-up's first or the window's
        last), from the head the program held before them."""
        cfg = self.tr["trainer"]["DiskLoss_config"]
        enc = self.ctx.config["model_config"]["backbone_config"]["encoder"]
        params = {**self.params, **{"localheader." + k: v for k, v in run["heads"][0].items()}}
        batches = [(b["im1"], b["im2"], b["F1"], b["F2"]) for b in (self.batches[i] for i in run["batches"])]
        draws = [self.draws[i] for i in run["batches"]]
        return stage2.train_steps(params, batches, draws, cfg, run["lrs"], enc, quant.rounder(precision), pairs)

    def _judge(self, run: dict, losses, grad, last, ref, loss_scale: float) -> dict:
        """A step's loss gap is taken against the reference's loss of that
        step or ``loss_scale``, whichever is larger in magnitude: a loss
        that passes near zero has no relative error."""
        r_losses, r_grad, r_states = ref
        keep = moved_leaves(r_grad)
        head0 = run["heads"][0]
        r_change = {k: r_states[-1][k] - head0[k] for k in keep}
        return {
            "loss_gap": max(abs(a - b) / max(abs(b), loss_scale) for a, b in zip(losses, r_losses)),
            "grad_gap": norm_gaps(grad, r_grad, keep),
            "change_gap": norm_gaps({k: last[k] - head0[k] for k in keep}, r_change, keep),
        }

    def readings(self) -> dict:
        """The worse of set-up's first three steps and the window's last
        three (fewer where the window made fewer); losses against the
        median magnitude of the reference's losses of all those steps."""
        full_f32()
        runs = [self.first] + ([self.last] if self.last and self.last["batches"] else [])
        refs = [self._reference(run) for run in runs]
        scale = statistics.median(abs(x) for ref in refs for x in ref[0])
        each = []
        for run, ref in zip(runs, refs):
            h0, h1 = run["heads"][0], run["heads"][1]
            grad = {k: (h0[k] - h1[k]) / run["lrs"][0] for k in h0}
            each.append(self._judge(run, run["losses"], grad, run["heads"][-1], ref, scale))
        return {k: max(r[k] for r in each) for k in each[0]}

    def check(self) -> dict:
        return self.readings()

    # ------------------------------------------------- limits (calibrate)

    def reseed(self, seed: int) -> None:
        self.ctx.seed = seed
        self.params, self.batches, self.draws = self._inputs(seed)
        self._first_steps()

    def controls(self) -> dict:
        """{name: readings} of the runs that must fail the check: the
        reference at the configuration's control precision in the
        program's place, and with half of each batch left out, the mean
        taken over the rest, both over set-up's three steps. (A state left
        unchanged reads 1 by the gradient's and the change's measure, and
        needs no run.)"""
        prec = self.ctx.config["control_precision"]
        half = list(range(self.tr["batch_size"] // 2))
        return {f"control_{prec}": lambda: self.control_readings(prec),
                "fault_half_batch": lambda: self.control_readings(pairs=half)}

    def control_readings(self, precision: str = None, pairs=None) -> dict:
        """The reference in the program's place, at ``precision`` or over
        only ``pairs`` of each batch (the mean taken over them), judged as
        the program's steps are."""
        full_f32()
        lossc, gradc, statesc = self._reference(self.first, precision, pairs)
        ref = self._reference(self.first)
        scale = statistics.median(abs(x) for x in ref[0])
        return self._judge(self.first, lossc, gradc, statesc[-1], ref, scale)
