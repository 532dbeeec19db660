"""Feature extraction manager (posfeat_tpu/extract/extractor.py:79-280,
532-756; reference managers/extractor.py:40-382).

The device program per image shape: upload uint8, normalize on the
device, backbone + head, NMS + top-k + 3×3 refinement, descriptor
sampling. Images stream from a threaded decode prefetcher into
(shape, detector-config) buckets of the batch size; a full bucket is
dispatched at once, its results are copied back asynchronously and
trimmed on a fetch thread to the reference's dynamic count
max(min(num_pts, valid_count), 128) (putils:249-261), and feature files
are written from a pool, so device, decode and IO overlap.

Feature files match the reference: ``np.savez(keypoints [n,2] px,
scores [n,1], descriptors [n,C])``, float32 (extractor.py:267-271).

Not ported yet (ROADMAP.md queue 1, item 7): the h5 / feat.h5 writers,
the SIFT passthrough, ``output_img``, spatial sharding, multi-host
sharding (``num_shards``) and ``detector_config_query``. A config that
asks for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from ..core.config import dump_config, load_config, merge_from_checkpoint
from ..core.device import resolve_device
from ..data import DATASETS
from ..data.utils import IMAGENET_MEAN, IMAGENET_STD
from ..models import MODELS
from ..ops.coords import denormalize_coords
from ..ops.detect import DETECTORS
from ..ops.grid_sample import sample_feat_by_coord

_DEFERRED = ("use_sift", "save_h5", "output_img", "spatial_shard")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _make_logger(name: str, logfile: str) -> logging.Logger:
    logger = logging.getLogger(f"{name}:{logfile}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - %(levelname)s: %(message)s")
    for h in (logging.StreamHandler(), logging.FileHandler(logfile, mode="a")):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class Extractor:
    """``config``: an extract config dict or the path of its YAML file.
    ``device``: None for the card. ``dataset``: an object with
    ``__len__`` and ``__getitem__`` yielding the datasets' sample dicts
    ('im1_ori' uint8 HWC, 'name1', ...), used instead of the configured
    dataset."""

    def __init__(self, config, ckpt_root: str = "./ckpts", device=None, dataset=None):
        if isinstance(config, str):
            config = load_config(config)
        # deep copy: the head selection below must not leak into the caller's dict
        self.config = copy.deepcopy(merge_from_checkpoint(config))
        for key in _DEFERRED:
            if self.config.get(key):
                raise NotImplementedError(
                    f"{key}: not ported yet; see ROADMAP.md queue 1, item 7"
                )
        self.device = resolve_device(device)
        self.save_root = os.path.join(ckpt_root, self.config["output_root"])
        self.desc_root = os.path.join(self.save_root, "desc")
        self.img_root = os.path.join(self.save_root, "image")
        dcfg = dict(self.config["data_config_extract"])
        if int(dcfg.get("num_shards", 1)) > 1:
            raise NotImplementedError(
                "num_shards: not ported yet; see ROADMAP.md queue 1, item 7"
            )
        dtype = _DTYPES[self.config.get("compute_dtype", "float32")]

        # bf16 extraction on the card takes the fused head (its kernels are
        # CUDA); head_dataflow overrides. Resolved before config.yaml is
        # written, so the run records the dataflow it used.
        head_mode = self.config.get("head_dataflow")
        lh_cfg = (self.config.get("model_config") or {}).get("localheader_config")
        if isinstance(lh_cfg, dict):
            if head_mode is not None:
                lh_cfg["fused_upsample"] = head_mode
            elif (
                dtype == torch.bfloat16
                and "fused_upsample" not in lh_cfg
                and self.device.type == "cuda"
            ):
                lh_cfg["fused_upsample"] = "pallas"

        # fail fast on an existing run dir (reference extractor.py:133-140)
        # unless resume: True
        if (
            os.path.isdir(self.desc_root)
            and os.listdir(self.desc_root)
            and not self.config.get("resume", False)
        ):
            raise FileExistsError(
                f"extraction output {self.desc_root!r} already exists; "
                "choose a new output_root or set resume: True"
            )
        os.makedirs(self.desc_root, exist_ok=True)
        os.makedirs(self.img_root, exist_ok=True)
        dump_config(self.config, os.path.join(self.save_root, "config.yaml"))
        self.logger = _make_logger("extractor", os.path.join(self.save_root, "logging_file.txt"))

        model_name = self.config.get("model", "PoSFeat")
        self.model = MODELS[model_name](self.config["model_config"], dtype=dtype, device=self.device)
        load_path = self.config.get("load_path")
        if load_path and os.path.isdir(load_path):
            self.model.load_checkpoint(load_path)
        else:
            self.logger.warning(f"load_path {load_path!r} missing — using random init")

        self.detector_name = self.config["detector"]
        self.logger.info(f"use {self.detector_name} to detect keypoints")
        if dataset is None:
            dataset = DATASETS[self.config["data"]](configs=dcfg)
        self.dataset = dataset
        self.batch_size = max(1, int(dcfg.get("batch_size", 1)))
        self.workers = max(1, int(dcfg.get("workers", 4)))
        self._programs: Dict[Any, Any] = {}

    # ------------------------------------------------------ device program

    def _learned_fn(self, shape, det_cfg_key: str):
        """uint8 image batch on the device -> (coords px, scores,
        descriptors, valid_count); one program per (shape, detector
        config)."""
        key = (shape, det_cfg_key)
        if key not in self._programs:
            H, W = shape
            det_cfg = {k: v for k, v in self.config[det_cfg_key].items() if k != "scale"}
            detector = partial(DETECTORS[self.detector_name], **det_cfg)
            cos = self.config["loss_distance"] == "cos"
            mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
            std = torch.as_tensor(IMAGENET_STD, device=self.device)

            # descriptors leave f32: the JAX program rounds them to the
            # compute dtype to halve its device-to-host bytes, which moves
            # unit norms by up to 2^-9; over PCIe the f32 slate is cheap
            @torch.inference_mode()
            def run(im_u8):
                im = (im_u8.float() / 255.0 - mean) / std
                outputs = self.model.extract(im)
                coord_n, score, valid = detector(outputs["local_point"])
                feat = sample_feat_by_coord(outputs["local_map"], coord_n, cos)
                return denormalize_coords(coord_n, H, W), score, feat, valid

            self._programs[key] = run
        return self._programs[key]

    def _det_cfg_key(self, inputs: Dict) -> str:
        if (
            self.config["data"] == "Aachen_Day_Night"
            and inputs["name1"].split("/")[0] == "query"
            and "detector_config_query" in self.config
        ):
            raise NotImplementedError(
                "detector_config_query is not ported yet; see ROADMAP.md queue 1, item 7"
            )
        return "detector_config"

    # ------------------------------------------------------------ writers

    def save_desc(self, inputs: Dict, processed: Dict) -> None:
        save_path = os.path.join(self.desc_root, inputs["name1"])
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        with open(save_path + ".{}".format(self.config["postfix"]), "wb") as f:
            np.savez(
                f, keypoints=processed["kpt"], scores=processed["kp_score"],
                descriptors=processed["desc"],
            )

    # ----------------------------------------------------------- pipeline

    def _prefetch(self):
        """Yield (idx, sample) in dataset order with threaded lookahead."""
        n = len(self.dataset)
        depth = max(2 * self.workers, 2 * self.batch_size, 4)
        with ThreadPoolExecutor(self.workers) as pool:
            futs = deque((i, pool.submit(self.dataset.__getitem__, i)) for i in range(min(depth, n)))
            nxt = len(futs)
            while futs:
                i, f = futs.popleft()
                yield i, f.result()
                if nxt < n:
                    futs.append((nxt, pool.submit(self.dataset.__getitem__, nxt)))
                    nxt += 1

    def _extract_learned_batched(self, names: Dict[int, str]) -> int:
        """Shape-bucketed, batched, pipelined extraction. Partial final
        buckets are padded by repeating the last image; padded slots are
        dropped on the host."""
        bs = self.batch_size
        cuda = self.device.type == "cuda"
        buckets: Dict[Any, list] = {}
        fetch_pool = ThreadPoolExecutor(1)
        write_pool = ThreadPoolExecutor(4)
        fetch_futs: deque = deque()
        write_futs: deque = deque()
        write_cap = 4 * bs  # pending per-image writes before fetches wait
        pending_cap = max(4 * bs, 32)  # decoded images held before a partial flush

        def write_one(inputs, processed):
            if self.config["output_desc"]:
                self.save_desc(inputs, processed)
            self.logger.info(f"{inputs['name1']}\nkpts: {processed['kpt'].shape[0]}")

        def finish(key, items, host, done):
            if done is not None:
                done.synchronize()
            coords, score, feat, valid = (t.numpy() for t in host)
            num_pts = self.config[key[1]]["num_pts"]
            for j, inputs in enumerate(items):
                n_emit = int(max(min(num_pts, int(valid[j])), 128))
                processed = {
                    "kpt": coords[j, :n_emit],
                    "desc": feat[j, :n_emit],
                    "kp_score": score[j, :n_emit],
                }
                write_futs.append(write_pool.submit(write_one, inputs, processed))
            while len(write_futs) > write_cap:
                write_futs.popleft().result()

        def dispatch(key):
            items = buckets.pop(key)
            ims = [np.asarray(it["im1_ori"], np.uint8) for it in items]
            ims += [ims[-1]] * (bs - len(ims))  # pad a partial bucket
            batch = torch.from_numpy(np.stack(ims))
            if cuda:
                batch = batch.pin_memory().to(self.device, non_blocking=True)
            out = self._learned_fn(key[0], key[1])(batch)
            # device -> pinned host copies, waited for on the fetch thread
            host = [t.to("cpu", non_blocking=True) for t in out]
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            fetch_futs.append(fetch_pool.submit(finish, key, items, host, done))
            while len(fetch_futs) > 2:  # bound the live result buffers
                fetch_futs.popleft().result()

        n_images = 0
        try:
            for idx, inputs in self._prefetch():
                names[idx] = inputs["name1"]
                n_images += 1
                H, W = inputs["im1_ori"].shape[:2]
                key = ((H, W), self._det_cfg_key(inputs))
                buckets.setdefault(key, []).append(inputs)
                if len(buckets[key]) == bs:
                    dispatch(key)
                elif sum(len(v) for v in buckets.values()) >= pending_cap:
                    dispatch(max(buckets, key=lambda k: len(buckets[k])))
            for key in list(buckets):
                dispatch(key)
            while fetch_futs:  # surface fetch errors
                fetch_futs.popleft().result()
            while write_futs:  # surface write errors
                write_futs.popleft().result()
        finally:
            fetch_pool.shutdown(wait=True)
            write_pool.shutdown(wait=True)
        return n_images

    def extract(self):
        """Run the whole dataset; returns (n_images, seconds)."""
        t0 = time.time()
        names: Dict[int, str] = {}
        n_images = self._extract_learned_batched(names)
        with open(os.path.join(self.img_root, "name_list.txt"), "w") as f:
            for idx in sorted(names):
                f.write("{} {}\n".format(idx, names[idx]))
        dt = time.time() - t0
        self.logger.info(
            f"extracted {n_images} images in {dt:.1f}s ({n_images / max(dt, 1e-9):.2f} im/s)"
        )
        return n_images, dt
