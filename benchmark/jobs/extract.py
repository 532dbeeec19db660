"""The extraction window: ``posfeat_tpu_torch.extract.Extractor.extract()``
over an in-memory dataset of the benchmark's seeded images, in the
Extractor's own batches, with its decode prefetch, asynchronous fetch
and writer pool. The benchmark's subclass keeps the slates in memory
(its ``save_desc``), so no npz or h5 is written.

The window opens when ``extract()`` is called. At the deadline the
dataset raises, so nothing more is dispatched; the Extractor finishes
what it has dispatched and its pools drain, and the window closes when
``extract()`` returns. Every image whose whole slate (keypoints, scores,
descriptors, trimmed as the Extractor trims them) reached the host
counts, over all of that time. The Extractor's console handler is taken
off once it is built (its log file in the run's scratch directory keeps
every line), so the reader of standard error never holds up its
writers. The check compares a sample of the window's
slates, drawn from the seed, with the plain reference
(``reference/extraction.py``) on the same images and weights."""

from __future__ import annotations

import copy
import gc
import heapq
import logging
import threading
import time

import numpy as np
import torch

from .. import traffic as gen_traffic
from .. import weights as gen_weights
from ..counts import model as model_counts
from ..harness import stage
from ..reference import extraction as ref
from ..reference import full_f32, quant


class WindowClosed(Exception):
    """Raised by the dataset once the window's deadline has passed."""


class Feed:
    """The Extractor's dataset: the image pool in a cycle, ``n`` items
    (or an unbounded stream), raising ``WindowClosed`` after ``deadline``."""

    def __init__(self, pool: list, n=None, deadline=None):
        self.pool, self.n, self.deadline = pool, n, deadline

    def __len__(self):
        return self.n if self.n is not None else 1 << 40

    def __getitem__(self, i):
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise WindowClosed
        return {"im1_ori": self.pool[i % len(self.pool)], "name1": str(i)}


def _well_formed(processed: dict, num_pts: int, H: int, W: int) -> bool:
    """A cheap look at every slate: counts, shapes, finite values, points
    inside the image, unit descriptors at both ends."""
    kpt, desc, score = processed["kpt"], processed["desc"], processed["kp_score"]
    n = kpt.shape[0]
    if not (min(128, num_pts) <= n <= num_pts and kpt.shape == (n, 2) and score.shape == (n, 1)
            and desc.shape[0] == n):
        return False
    if not (np.isfinite(kpt).all() and np.isfinite(score).all()):
        return False
    if kpt.min() < 0 or kpt[:, 0].max() > W - 1 or kpt[:, 1].max() > H - 1:
        return False
    norms = np.linalg.norm(desc[[0, -1]], axis=1)
    return bool(np.all(np.abs(norms - 1) < 1e-3))


def program_config(config: dict, traffic: dict) -> dict:
    """The Extractor's config: the configuration's model and numerics, the
    mix's detector and batch."""
    return {
        "output_root": "bench", "postfix": "bench", "loss_distance": "cos", "output_desc": True,
        "output_img": False, "compute_dtype": config["compute_dtype"], "model": config["model"],
        "model_config": copy.deepcopy(config["model_config"]), "data": "HPatch_SIFT",
        "data_config_extract": {"batch_size": traffic["batch_size"], "workers": traffic["workers"]},
        "use_sift": False, "detector": traffic["detector"], "detector_config": dict(traffic["detector_config"]),
    }


def compare(slate: dict, score: torch.Tensor, local_map: torch.Tensor, det: dict) -> dict:
    """One slate against the reference's score map [H, W] and local map
    NCHW [1, C, h, w] of its image:

    - ``kp_miss_pct``: the share of the reference's slate pixels that the
      slate does not hold;
    - ``coord_err_px``: each point's distance to the reference's refined
      position of the pixel it came from (the one of the 3×3 around it
      whose refined position is nearest), the largest;
    - ``score_err``: the largest gap of a point's score to the
      reference's 3×3 max-pooled score at that pixel;
    - ``desc_err``: the largest L2 distance of a descriptor to the
      reference's, sampled at the slate's own point."""
    H, W = score.shape
    dev = score.device
    num_pts, radius, thr = det["num_pts"], det["nms_radius"], float(det["thr"])
    idx, valid, _interior, pooled, grids = ref.detect(score[None], num_pts, radius, thr)
    ref_idx = idx[0, : ref.emitted(int(valid[0]), num_pts)]
    kpt = torch.from_numpy(np.ascontiguousarray(slate["kpt"], np.float32)).to(dev)
    base = kpt.round().long()
    best_d, best_i = None, None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            px = (base[:, 0] + dx).clamp(1, W - 2)
            py = (base[:, 1] + dy).clamp(1, H - 2)
            i = (py - 1) * (W - 2) + (px - 1)
            d = torch.linalg.vector_norm(grids[0].reshape(-1, 2)[i] - kpt, dim=1)
            if best_d is None:
                best_d, best_i = d, i
            else:
                closer = d < best_d
                best_d, best_i = torch.where(closer, d, best_d), torch.where(closer, i, best_i)
    got = torch.from_numpy(np.ascontiguousarray(slate["kp_score"], np.float32)).to(dev)[:, 0]
    desc = torch.from_numpy(np.ascontiguousarray(slate["desc"], np.float32)).to(dev)
    d_ref = ref.sample_descriptors(local_map, kpt[None], H, W)[0]
    return {
        "kp_miss_pct": 100.0 * (1.0 - torch.isin(ref_idx, best_i).float().mean().item()),
        "coord_err_px": best_d.max().item(),
        "score_err": (got - pooled[0].reshape(-1)[best_i]).abs().max().item(),
        "desc_err": torch.linalg.vector_norm(desc - d_ref, dim=1).max().item(),
    }


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


class Job:
    unit = "images"

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.H, self.W = self.tr["height"], self.tr["width"]
        self.det = self.tr["detector_config"]
        self.ex = None

    # ------------------------------------------------------------ set-up

    def _inputs(self, seed: int):
        """(weights, host image pool) of ``seed``, made on the device."""
        dev = self.ctx.device
        params = gen_weights.make(self.ctx.config["model_config"], seed, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED1)
        pool = gen_traffic.textures(gen, self.tr["pool_images"], self.H, self.W, dev).cpu().numpy()
        return params, list(pool)

    def _load(self, params: dict) -> None:
        model = self.ex.model
        model.backbone.load_state_dict(gen_weights.module_state(params, "backbone"))
        model.localheader.load_state_dict(gen_weights.module_state(params, "localheader"))

    def setup(self) -> None:
        t = time.perf_counter()
        # one thread for torch's host ops: the loop's host work is the
        # program's dispatch, which extra threads only contend with
        torch.set_num_threads(1)
        from posfeat_tpu_torch.extract import Extractor

        class BenchExtractor(Extractor):
            """Keeps each slate's count and a seeded sample in memory."""

            def save_desc(inner, inputs, processed):
                self._keep(inputs, processed)

        self.params, self.pool = self._inputs(self.ctx.seed)
        t = stage("import, weights and images", t)
        bs = self.tr["batch_size"]
        self.ex = BenchExtractor(program_config(self.ctx.config, self.tr), ckpt_root=self.ctx.tmp,
                                 device=self.ctx.device, dataset=Feed(self.pool, n=bs * self.tr["warmup_batches"]),
                                 seed=0)
        self._load(self.params)
        for h in list(self.ex.logger.handlers):
            if type(h) is logging.StreamHandler:  # its log file keeps every line
                self.ex.logger.removeHandler(h)
        t = stage("Extractor", t)
        self._reset()
        self.ex.extract()  # builds or loads the kernels, warms every shape of the window
        stage("warm-up batches", t)

    # ------------------------------------------------------------ window

    def _reset(self) -> None:
        self._lock = threading.Lock()
        self.done, self.bad, self._sample = 0, 0, []

    def _keep(self, inputs: dict, processed: dict) -> None:
        i = int(inputs["name1"])
        ok = _well_formed(processed, self.det["num_pts"], self.H, self.W)
        with self._lock:
            self.done += 1
            self.bad += not ok
            rank = gen_traffic.priority(self.ctx.seed, i)
            if len(self._sample) < self.tr["check_images"] or rank < -self._sample[0][0]:
                item = (-rank, i, {k: np.array(v) for k, v in processed.items()})
                if len(self._sample) < self.tr["check_images"]:
                    heapq.heappush(self._sample, item)
                else:
                    heapq.heapreplace(self._sample, item)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        self._reset()
        self.ex.dataset = Feed(self.pool, deadline=t0 + seconds)
        try:
            self.ex.extract()
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the window's dataset ran out before its deadline")
        # closed once all that was dispatched has reached the host
        elapsed = time.perf_counter() - t0
        return {"units": self.done, "seconds": elapsed, "attempted": self.done, "failed": self.bad}

    def end_to_end(self, win: dict) -> dict:
        return {"extract_images_per_s": win["units"] / win["seconds"]}

    def layers(self) -> dict:
        return {"backbone": self.ex.model.backbone, "localheader": self.ex.model.localheader}

    def trace_info(self, win: dict) -> dict:
        mc = self.ctx.config["model_config"]
        bf16 = self.ctx.config["compute_dtype"] == "bfloat16"
        return {
            "units": win["units"], "batch": self.tr["batch_size"], "height": self.H, "width": self.W,
            "in_channels": mc["localheader_config"]["in_channels"], "fused_head": bf16,
            "itemsize": 2 if bf16 else 4, "flops_per_unit": model_counts.extract_flops(self.H, self.W, mc),
            "peak_flops": self.ctx.config["peak_flops"],
        }

    def release(self) -> None:
        self.ex = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def sample(self) -> list:
        """(image index, slate) of the window's sample, in index order."""
        return sorted((i, s) for _r, i, s in self._sample)

    def _reference(self, params, pool, i, precision=None):
        im = torch.from_numpy(pool[i % len(pool)])[None].to(self.ctx.device)
        score, local = ref.forward(params, im, self.ctx.config["model_config"]["backbone_config"]["encoder"],
                                   quant.rounder(precision))
        return score[0], local

    @torch.no_grad()
    def readings(self, params=None, pool=None, sample=None) -> dict:
        """The compared numbers of a sample of slates, worst over its images."""
        full_f32()
        params = self.params if params is None else params
        pool = self.pool if pool is None else pool
        sample = self.sample() if sample is None else sample
        if not sample:
            raise RuntimeError("no slate reached the host in the window")
        rows = []
        for i, slate in sample:
            score, local = self._reference(params, pool, i)
            rows.append(compare(slate, score, local, self.det))
        return worst(rows)

    def check(self) -> dict:
        return self.readings()

    # ------------------------------------------------- limits (calibrate)

    def reseed(self, seed: int) -> None:
        """New weights and images of ``seed`` in the same Extractor."""
        self.ctx.seed = seed
        self.params, self.pool = self._inputs(seed)
        self._load(self.params)

    def controls(self) -> dict:
        """{name: readings} of the runs that must fail the check: the
        reference at the configuration's control precision in the
        program's place, on as many images as a run compares."""
        n = self.tr["check_images"]
        indices = sorted(sorted(range(len(self.pool)), key=lambda i: gen_traffic.priority(self.ctx.seed, i))[:n])
        prec = self.ctx.config["control_precision"]
        return {f"control_{prec}": lambda: self.control_readings(prec, indices)}

    @torch.no_grad()
    def control_readings(self, precision: str, indices: list) -> dict:
        """The reference at ``precision`` in the program's place: its
        slates of the pool's ``indices``, judged as the program's are."""
        full_f32()
        det = self.det
        sample = []
        for i in indices:
            score, local = self._reference(self.params, self.pool, i, precision)
            kpt, scores, desc = ref.slate(score, local, det["num_pts"], det["nms_radius"], float(det["thr"]))
            sample.append((i, {"kpt": kpt.cpu().numpy(), "kp_score": scores.cpu().numpy(),
                               "desc": desc.cpu().numpy()}))
        return self.readings(sample=sample)
