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
scores [n,1], descriptors [n,C])``, float32 (extractor.py:267-271);
``save_h5`` adds the per-sequence ``keypoints.h5``, ``descriptors.h5``,
``scores.h5``, ``scales.h5`` and an hloc-style ``feat.h5`` with
``image_size`` under ``desc_root + "h5"`` (needs ``h5py``; without it
the extractor raises ImportError before any work; shards append to them
under one lock, below), and ``output_img``
dumps each image's score map and keypoints as JPEGs under ``image/``.
``use_sift`` is the SIFT passthrough: OpenCV SIFT keypoints found on the
host, descriptors sampled at them on the device, unit scores, one image
at a time (posfeat_tpu/extract/extractor.py:347-383, 712-735).

The detector config flows to the detector whole but for ``scale``: its
``refine`` picks the sub-pixel refiner, which a bf16 extraction runs in
f32 after the fused head's kernels. ``detector_config_query`` applies
to Aachen Day-Night query images, as in the JAX extractor.
``save_npz: False`` skips the npz files (the h5 files and the name list
are written as before).

``num_shards`` / ``shard_index`` in ``data_config_extract`` split the
image list between processes that share one ``output_root``: each writes
its own images' files and ``image/name_list.shard<i>.txt``, every shard
writes ``config.yaml`` and appends to ``logging_file.txt`` as the JAX
extractor does, and the ``FileExistsError`` check applies to
single-shard runs only. With ``save_h5`` each process holds an exclusive
``fcntl.flock`` on ``<h5 root>/.lock`` for one image's appends (its four
per-sequence files and its ``feat.h5`` group), so the shards' appends
take turns where the JAX extractor's collide in HDF5's own file lock;
the files end up holding every shard's images under the names one
process writes. ``spatial_shard`` (``auto``, ``True`` or a device
count) resolves its device count as JAX does (the visible cards; 1 on the
CPU). On one device every image runs unsharded, as in JAX. Over more,
images above ``spatial_threshold_px`` run one at a time through the
banded program of ``parallel/spatial.py`` (posfeat_tpu/extract/
extractor.py:195-219, 282-348): the image's rows split over the cards,
backbone, head, detector and descriptor sampling run on the bands, the
slate comes back whole; the fused head ("pallas") is swapped for the
"phase" dataflow there. Smaller images and the SIFT passthrough run
unsharded. ``stable: False`` (Gumbel or Categorical selection) needs a
generator, which the Extractor does not have (as JAX's extractor has no
PRNG key): under ``spatial_shard`` it is refused before any work, and
unsharded the detector raises at the first image.

``fast_mode`` and ``fast_gates`` are the JAX package's fast-path gates
(extractor.py:104-129, posfeat_tpu/__init__.py:19-31) as config keys:
``fast_gates: {head_ring, head_im2col, topk, sample_impl}`` stand for
POSFEAT_HEAD_RING, POSFEAT_HEAD_IM2COL, POSFEAT_TOPK and
POSFEAT_SAMPLE_IMPL. bf16 extraction on the card takes the "lite" set
(``FAST_GATES``) unless ``fast_mode: False``; f32 and the CPU never do; a
key given in ``fast_gates`` wins either way, as an explicitly set knob
does. The gates are this instance's state: the resolved set goes into
the run's ``config.yaml`` (``fast_gates``, and ``fast_gates_banded`` for
the banded program, which takes the same ``topk`` and ``sample_impl``
and whose head is "phase", so that the head gates do not apply there)
and into the logging file, and nothing else in the process sees it.
``model_config.backbone_config``'s ``desc_tail``,
``decoder_accum`` and ``desc_f32`` change no parameter: where an
extract config gives them, they win over the checkpoint's config, as
the JAX package's environment knobs do.
"""

from __future__ import annotations

import contextlib
import copy
import fcntl
import itertools
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
from ..core.profiling import span
from ..data import DATASETS
from ..data.utils import IMAGENET_MEAN, IMAGENET_STD
from ..models import MODELS
from ..models.keypoint_det import check_head_dataflow
from ..ops.coords import denormalize_coords, normalize_coords
from ..ops.detect import DETECTORS, TOPK
from ..ops.grid_sample import SAMPLE_IMPLS, sample_feat_by_coord
from ..parallel import banded_detect, spatial_extract, spatial_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference dataflow, and the JAX package's certified "lite" set
# (posfeat_tpu/__init__.py:24-30)
EXACT_GATES = {"head_ring": True, "head_im2col": False, "topk": "exact", "sample_impl": "corner"}
FAST_GATES = {"head_ring": False, "head_im2col": True, "topk": "approx", "sample_impl": "quad"}
_GATE_VALUES = {"head_ring": (True, False), "head_im2col": (True, False), "topk": TOPK,
                "sample_impl": SAMPLE_IMPLS}
BACKBONE_NUMERICS = ("desc_tail", "decoder_accum", "desc_f32")


def resolve_fast_gates(config: Dict, dtype: torch.dtype, device: torch.device) -> Dict:
    """The gates an extraction runs with (extractor.py:104-129): the lite
    set for bf16 on the card unless ``fast_mode`` is False, else the exact
    set; the keys of ``fast_gates`` win over either. Unknown keys or
    values raise ValueError."""
    given = dict(config.get("fast_gates") or {})
    for key, value in given.items():
        if key not in _GATE_VALUES:
            raise ValueError(f"unknown fast_gates key {key!r}; expected one of {tuple(_GATE_VALUES)}")
        if value not in _GATE_VALUES[key]:
            raise ValueError(f"fast_gates.{key} = {value!r}; expected one of {_GATE_VALUES[key]}")
    lite = dtype == torch.bfloat16 and device.type == "cuda" and config.get("fast_mode", True)
    return {**(FAST_GATES if lite else EXACT_GATES), **given}


def _visible_devices(device: torch.device) -> int:
    """The devices a spatial shard could span: the visible cards, or 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def spatial_devices(sp, device: torch.device) -> int:
    """``spatial_shard``'s device count as the JAX extractor resolves it
    (extractor.py:205-219): every device for ``True``/``auto``, else at
    most ``sp``; 0 when the key is off."""
    if not sp:
        return 0
    n_dev = _visible_devices(device)
    return n_dev if sp in (True, "auto") else min(int(sp), n_dev)


H5_LOCK = ".lock"  # the h5 root's lock file, held for one image's appends


@contextlib.contextmanager
def _locked(path: str):
    """An exclusive ``fcntl.flock`` on ``path`` (made where missing) for
    the block; another process's lock on it waits for this one."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


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
    dataset. ``seed``: the random init's seed where no checkpoint is
    loaded.

    Any ``torch.profiler`` trace of an extraction holds these named host
    ranges on the main thread (``core/profiling.span``), on the clock of
    the card's kernels, and their totals in ``profiling.span_totals()``:
    ``extract.feed_wait`` (waiting for the decode prefetcher's next
    image), ``extract.dispatch`` (a batch from its bucket to the fetch
    thread: stacking, the pinned upload, the device program's enqueue,
    the device-to-host copies; ``seq`` is the batch number),
    ``extract.card_wait`` (waiting for the fetch thread, which waits for
    the card: the bound of two batches in flight, the last drain, the
    pools' shutdown), and inside a batch ``model.backbone`` and
    ``model.head``."""

    def __init__(self, config, ckpt_root: str = "./ckpts", device=None, dataset=None, seed: int = 0):
        if isinstance(config, str):
            config = load_config(config)
        asked = (config.get("model_config") or {}).get("backbone_config")
        numerics = {k: asked[k] for k in BACKBONE_NUMERICS if isinstance(asked, dict) and k in asked}
        # deep copy: the head selection below must not leak into the caller's dict
        self.config = copy.deepcopy(merge_from_checkpoint(config))
        if numerics:
            model_cfg = self.config.setdefault("model_config", {})
            if not isinstance(model_cfg.get("backbone_config"), dict):
                model_cfg["backbone_config"] = {}
            model_cfg["backbone_config"].update(numerics)
        self.sift_kp = bool(self.config.get("use_sift", False))
        self.save_npz = bool(self.config.get("save_npz", True))
        self.save_h5 = bool(self.config.get("save_h5", False))
        if self.save_h5:
            try:
                import h5py  # noqa: F401
            except ImportError as e:
                raise ImportError("save_h5: writing the h5 feature files needs h5py, which is not "
                                  "installed; set save_h5: False to write the npz files only") from e
        self.device = resolve_device(device)
        self.save_root = os.path.join(ckpt_root, self.config["output_root"])
        self.desc_root = os.path.join(self.save_root, "desc")
        self.img_root = os.path.join(self.save_root, "image")
        dcfg = dict(self.config["data_config_extract"])
        self.num_shards = int(dcfg.get("num_shards", 1))
        self.shard_index = int(dcfg.get("shard_index", 0))
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(f"shard_index {self.shard_index} is not in [0, num_shards = {self.num_shards})")
        # spatial_threshold_px: the pixel count above which the JAX extractor
        # shards an image over its spatial mesh (default 4M, about 2048x2048)
        self.spatial_threshold = int(self.config.get("spatial_threshold_px", 4 * 1024 * 1024))
        n_spatial = spatial_devices(self.config.get("spatial_shard", False), self.device)
        self._spatial_mesh = None
        self._spatial_forward = None
        if n_spatial > 1:
            # a detector configuration that cannot run is refused before any
            # work (parallel/banded_detect.py): with no generator, stable: False
            if not self.sift_kp:
                for key in ("detector_config", "detector_config_query"):
                    if key in self.config:
                        banded_detect.check_detector(self.config["detector"], self.config[key])
            # distinct devices, as JAX's mesh over jax.devices()[:n]; the CPU is one
            devices = ([torch.device("cuda", i) for i in range(n_spatial)] if self.device.type == "cuda"
                       else [self.device] * n_spatial)
            self._spatial_mesh = spatial_mesh(devices)
        dtype = _DTYPES[self.config.get("compute_dtype", "float32")]

        # bf16 extraction on the card takes the fused head (its kernels are
        # CUDA); head_dataflow overrides with any KeypointDet dataflow
        # (False, True, "always", "phase", "pallas"), and head_mode picks
        # the fused head's "v3" or "v1" dataflow (the JAX package's
        # POSFEAT_HEAD_MODE). Resolved before config.yaml is written, so
        # the run records the dataflow it used.
        # ResUNetHR's local map is at H/2, where the fused dataflows do not
        # apply: the JAX extractor picks "pallas" and its head then takes
        # the reference dataflow (keypoint_det.py:537-539); the port picks
        # that dataflow (False) outright, so config.yaml records it.
        head_dataflow = self.config.get("head_dataflow")
        head_mode = self.config.get("head_mode")
        model_cfg = self.config.get("model_config") or {}
        lh_cfg = model_cfg.get("localheader_config")
        hr = model_cfg.get("backbone") == "ResUNetHR"
        if isinstance(lh_cfg, dict):
            if head_mode is not None:
                lh_cfg["fused_head_mode"] = head_mode
            if head_dataflow is not None:
                lh_cfg["fused_upsample"] = head_dataflow
            elif (
                dtype == torch.bfloat16
                and "fused_upsample" not in lh_cfg
                and self.device.type == "cuda"
            ):
                lh_cfg["fused_upsample"] = False if hr else "pallas"
            check_head_dataflow(lh_cfg.get("fused_upsample", True), dtype, self.device.type)
        self.gates = resolve_fast_gates(self.config, dtype, self.device)
        self.config["fast_gates"] = dict(self.gates)
        if isinstance(lh_cfg, dict):
            lh_cfg["head_ring"] = self.gates["head_ring"]
            lh_cfg["head_im2col"] = self.gates["head_im2col"]
        if self._spatial_mesh is not None:
            # the banded head is "phase" (posfeat_tpu/parallel/spatial.py:18-21): no head gate applies
            self.config["fast_gates_banded"] = {"head_ring": None, "head_im2col": None, "topk": self.gates["topk"],
                                                "sample_impl": self.gates["sample_impl"]}

        # fail fast on an existing run dir (reference extractor.py:133-140)
        # unless resume: True
        # shards share one output_root by design, so the check is single-shard only
        if (
            self.num_shards == 1
            and os.path.isdir(self.desc_root)
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
        self.logger.info(f"fast gates (fast_mode {self.config.get('fast_mode', True)!r}, "
                         f"{self.config.get('compute_dtype', 'float32')} on {self.device.type}): {self.gates}")
        if n_spatial == 1:
            self.logger.info("spatial_shard: one device, so every image runs unsharded")
        elif self._spatial_mesh is not None:
            self.logger.info(f"spatial sharding enabled: {n_spatial}-device H-axis bands for images "
                             f"> {self.spatial_threshold} px; the banded program takes the {self.gates['topk']!r} "
                             f"top-k and {self.gates['sample_impl']!r} sampling, and its 'phase' head no head "
                             f"gate (config.yaml: fast_gates_banded)")
        if hr and isinstance(lh_cfg, dict):
            self.logger.info(f"ResUNetHR: the head's trunk is at H/2, so it takes the reference dataflow "
                             f"(fused_upsample {lh_cfg.get('fused_upsample', True)!r}); K1/K2 are not launched")

        model_name = self.config.get("model", "PoSFeat")
        self.model = MODELS[model_name](self.config["model_config"], dtype=dtype, device=self.device, seed=seed)
        load_path = self.config.get("load_path")
        if load_path and os.path.isdir(load_path):
            self.model.load_checkpoint(load_path)
        else:
            self.logger.warning(f"load_path {load_path!r} missing — using random init")

        if self.sift_kp:
            self.logger.info("use sift keypoints")
        else:
            self.detector_name = self.config["detector"]
            self.logger.info(f"use {self.detector_name} to detect keypoints")
        if dataset is None:
            # host SIFT and host normalization for the SIFT passthrough only;
            # the learned path normalizes the uint8 image on the device
            dcfg.setdefault("compute_sift", self.sift_kp)
            dcfg.setdefault("compute_normalize", self.sift_kp)
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
            detector = partial(DETECTORS[self.detector_name], **{"topk": self.gates["topk"], **det_cfg})
            impl = self.gates["sample_impl"]
            cos = self.config["loss_distance"] == "cos"
            mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
            std = torch.as_tensor(IMAGENET_STD, device=self.device)
            # image dumps also fetch the score map (reference extractor.py:211-252)
            want_map = bool(self.config.get("output_img"))

            # descriptors leave f32: the JAX program rounds them to the
            # compute dtype to halve its device-to-host bytes, which moves
            # unit norms by up to 2^-9; over PCIe the f32 slate is cheap
            @torch.inference_mode()
            def run(im_u8):
                im = (im_u8.float() / 255.0 - mean) / std
                outputs = self.model.extract(im)
                coord_n, score, valid = detector(outputs["local_point"])
                feat = sample_feat_by_coord(outputs["local_map"], coord_n, cos, impl)
                out = (denormalize_coords(coord_n, H, W), score, feat, valid)
                return out + (outputs["local_point"][..., 0].float(),) if want_map else out

            self._programs[key] = run
        return self._programs[key]

    def _use_spatial(self, shape) -> bool:
        return self._spatial_mesh is not None and shape[0] * shape[1] > self.spatial_threshold

    def _spatial_model(self):
        """The model of the banded program: this Extractor's model, or where
        its head is the fused one ('pallas', a single-device kernel) a copy
        with the 'phase' dataflow in its place, as the JAX extractor swaps
        it (extractor.py:288-303)."""
        if self.model.localheader.fused_upsample != "pallas":
            return self.model
        model = copy.deepcopy(self.model)
        model.localheader.fused_upsample = "phase"
        self.logger.info("spatial_shard: the fused head ('pallas') runs on one device, so the banded "
                         "program takes fused_upsample 'phase'")
        return model

    def _spatial_fn(self, shape, det_cfg_key: str):
        """``_learned_fn``'s program for one [1, H, W, 3] image over the
        spatial bands (JAX ``_spatial_fn``, extractor.py:305-348): the
        backbone, head, detector and sampling banded, the slate (and the
        score map that ``output_img`` asks for) whole on the first device."""
        key = ("spatial", shape, det_cfg_key)
        if key not in self._programs:
            if self._spatial_forward is None:  # the replicas, once
                self._spatial_forward = spatial_extract(self._spatial_model(), self._spatial_mesh)
            forward = self._spatial_forward
            H, W = shape
            det_cfg = {k: v for k, v in self.config[det_cfg_key].items() if k != "scale"}
            det_cfg = {"topk": self.gates["topk"], **det_cfg}
            impl = self.gates["sample_impl"]
            cos = self.config["loss_distance"] == "cos"
            dev0 = self._spatial_mesh.devices[0]
            mean = torch.as_tensor(IMAGENET_MEAN, device=dev0)
            std = torch.as_tensor(IMAGENET_STD, device=dev0)
            want_map = bool(self.config.get("output_img"))

            @torch.inference_mode()
            def run(im_u8):
                im = (im_u8.to(dev0).float() / 255.0 - mean) / std
                outputs = forward(im)
                coord_n, score, valid = banded_detect.detect(outputs["local_point"], self.detector_name,
                                                             **det_cfg)
                feat = banded_detect.sample_feat_by_coord(outputs["local_map"], coord_n, cos, impl)
                out = (denormalize_coords(coord_n, H, W), score, feat, valid)
                return out + (outputs["local_point"].concat()[..., 0].float(),) if want_map else out

            self._programs[key] = run
        return self._programs[key]

    @torch.inference_mode()
    def _sift_descriptors(self, inputs: Dict) -> Dict:
        """The SIFT passthrough for one image: descriptors sampled on the
        device at the host's SIFT keypoints, unit scores (JAX
        ``_sift_fn`` and ``process``, extractor.py:347-383)."""
        im = torch.from_numpy(np.asarray(inputs["im1"], np.float32))[None].to(self.device)
        H, W = im.shape[1:3]
        kpt = np.asarray(inputs["coord1"], np.float32).reshape(-1, 2)
        coords = torch.from_numpy(kpt)[None].to(self.device)
        outputs = self.model.extract(im)
        cos = self.config["loss_distance"] == "cos"
        feat = sample_feat_by_coord(outputs["local_map"], normalize_coords(coords, H, W), cos,
                                    self.gates["sample_impl"])
        return {"kpt": kpt, "desc": feat[0].float().cpu().numpy(),
                "kp_score": np.ones((len(kpt), 1), np.float32)}

    def _det_cfg_key(self, inputs: Dict) -> str:
        """Aachen Day-Night query images take ``detector_config_query``
        where the config has it (posfeat_tpu/extract/extractor.py:513-522)."""
        if (
            self.config["data"] == "Aachen_Day_Night"
            and inputs["name1"].split("/")[0] == "query"
            and "detector_config_query" in self.config
        ):
            return "detector_config_query"
        return "detector_config"

    # ------------------------------------------------------------ writers

    def save_desc(self, inputs: Dict, processed: Dict) -> None:
        """The npz file unless ``save_npz`` is False and, with ``save_h5``,
        the h5 files (extractor.py:417-458)."""
        kpt, desc, scores = processed["kpt"], processed["desc"], processed["kp_score"]
        name = inputs["name1"]
        save_path = os.path.join(self.desc_root, name)
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        if self.save_npz:
            with open(save_path + ".{}".format(self.config["postfix"]), "wb") as f:
                np.savez(f, keypoints=kpt, scores=scores, descriptors=desc)
        if self.save_h5:
            import h5py

            h5_root = self.desc_root + "h5"
            h5_name = name.split(".")[0]
            seq_dir = os.path.join(h5_root, "/".join(h5_name.split("/")[:-1]))
            base = h5_name.split("/")[-1]
            os.makedirs(seq_dir, exist_ok=True)
            h, w = inputs["im1_ori"].shape[:2]
            # the shards' processes append to the same files: one at a time
            with _locked(os.path.join(h5_root, H5_LOCK)):
                for fname, data in (("keypoints", kpt), ("descriptors", desc), ("scores", scores),
                                    ("scales", np.ones_like(scores))):
                    with h5py.File(os.path.join(seq_dir, f"{fname}.h5"), "a") as f:
                        f[base] = data
                with h5py.File(os.path.join(h5_root, "feat.h5"), "a") as f:
                    grp = f.create_group(name)
                    grp.create_dataset("keypoints", data=kpt)
                    grp.create_dataset("scores", data=scores)
                    grp.create_dataset("descriptors", data=desc)
                    grp.create_dataset("image_size", data=np.array([w, h]))

    def save_imgs(self, inputs: Dict, processed: Dict) -> None:
        """``<base>_score_map.jpg`` (the score map over its ``local_thr``
        percentile in OpenCV's JET colours) and ``<base>_image_with_kp.jpg``
        (the keypoints on the image) under ``image/`` (extractor.py:461-490;
        reference extractor.py:211-252)."""
        import cv2

        name = inputs["name1"]
        save_path = os.path.join(self.img_root, os.path.dirname(name))
        base = os.path.basename(name).split(".")[0]
        os.makedirs(save_path, exist_ok=True)
        score = processed.get("score_map")
        if score is not None:
            thr = np.percentile(score, 100 * self.config.get("local_thr", 0.99))
            vis = (np.clip(score / max(thr, 1e-8), 0, 1) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(save_path, f"{base}_score_map.jpg"),
                        cv2.applyColorMap(vis, cv2.COLORMAP_JET))
        im = np.ascontiguousarray(np.asarray(inputs["im1_ori"], np.uint8))
        for kp in processed["kpt"]:
            cv2.circle(im, (int(kp[0]), int(kp[1])), 2, (0, 255, 0), -1)
        cv2.imwrite(os.path.join(save_path, f"{base}_image_with_kp.jpg"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))

    def _write_one(self, inputs: Dict, processed: Dict) -> None:
        if self.config["output_desc"]:
            self.save_desc(inputs, processed)
        if self.config.get("output_img"):
            self.save_imgs(inputs, processed)
        self.logger.info(f"{inputs['name1']}\nkpts: {processed['kpt'].shape[0]}")

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
                with span("extract.feed_wait"):
                    sample = f.result()
                yield i, sample
                if nxt < n:
                    futs.append((nxt, pool.submit(self.dataset.__getitem__, nxt)))
                    nxt += 1

    def _extract_learned_batched(self, names: Dict[int, str]) -> int:
        """Shape-bucketed, batched, pipelined extraction. Partial final
        buckets are padded by repeating the last image; padded slots are
        dropped on the host. Images that run banded go one at a time
        (the whole mesh works on one image's rows)."""
        bs = self.batch_size
        cuda = self.device.type == "cuda"
        buckets: Dict[Any, list] = {}
        fetch_pool = ThreadPoolExecutor(1)
        # h5py's appends are not thread-safe: one writer with h5 on
        write_pool = ThreadPoolExecutor(1 if self.save_h5 else 4)
        fetch_futs: deque = deque()
        write_futs: deque = deque()
        write_cap = 4 * bs  # pending per-image writes before fetches wait
        pending_cap = max(4 * bs, 32)  # decoded images held before a partial flush
        batch_no = itertools.count()

        def finish(key, items, host, done):
            if done is not None:
                done.synchronize()
            coords, score, feat, valid = (t.numpy() for t in host[:4])
            smap = host[4].numpy() if len(host) > 4 else None
            num_pts = self.config[key[1]]["num_pts"]
            for j, inputs in enumerate(items):
                n_emit = int(max(min(num_pts, int(valid[j])), 128))
                processed = {
                    "kpt": coords[j, :n_emit],
                    "desc": feat[j, :n_emit],
                    "kp_score": score[j, :n_emit],
                }
                if smap is not None:
                    processed["score_map"] = smap[j]
                write_futs.append(write_pool.submit(self._write_one, inputs, processed))
            while len(write_futs) > write_cap:
                write_futs.popleft().result()

        def bucket_cap(key) -> int:
            return 1 if self._use_spatial(key[0]) else bs

        def dispatch(key):
            with span("extract.dispatch", seq=next(batch_no)):
                items = buckets.pop(key)
                ims = [np.asarray(it["im1_ori"], np.uint8) for it in items]
                ims += [ims[-1]] * (bucket_cap(key) - len(ims))  # pad a partial bucket
                batch = torch.from_numpy(np.stack(ims))
                if cuda:
                    batch = batch.pin_memory().to(self.device, non_blocking=True)
                program = self._spatial_fn if self._use_spatial(key[0]) else self._learned_fn
                out = program(key[0], key[1])(batch)
                # device -> pinned host copies, waited for on the fetch thread
                host = [t.to("cpu", non_blocking=True) for t in out]
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                fetch_futs.append(fetch_pool.submit(finish, key, items, host, done))
            with span("extract.card_wait"):
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
                if len(buckets[key]) == bucket_cap(key):
                    dispatch(key)
                elif sum(len(v) for v in buckets.values()) >= pending_cap:
                    dispatch(max(buckets, key=lambda k: len(buckets[k])))
            for key in list(buckets):
                dispatch(key)
            with span("extract.card_wait"):
                while fetch_futs:  # surface fetch errors
                    fetch_futs.popleft().result()
            while write_futs:  # surface write errors
                write_futs.popleft().result()
        finally:
            # on an error from the dataset, up to two batches are still in flight
            with span("extract.card_wait"):
                fetch_pool.shutdown(wait=True)
                write_pool.shutdown(wait=True)
        return n_images

    def _extract_sift(self, names: Dict[int, str]) -> int:
        """The SIFT passthrough, one image at a time (keypoint counts
        vary), with the threaded prefetch and the write pool."""
        write_pool = ThreadPoolExecutor(1 if self.save_h5 else 4)
        futs = []
        n_images = 0
        try:
            for idx, inputs in self._prefetch():
                names[idx] = inputs["name1"]
                n_images += 1
                futs.append(write_pool.submit(self._write_one, inputs, self._sift_descriptors(inputs)))
            for f in futs:  # surface write errors
                f.result()
        finally:
            write_pool.shutdown(wait=True)
        return n_images

    def extract(self):
        """Run the whole dataset; returns (n_images, seconds)."""
        t0 = time.time()
        names: Dict[int, str] = {}
        if self.sift_kp:
            n_images = self._extract_sift(names)
        else:
            n_images = self._extract_learned_batched(names)
        # each shard writes its own list; a single shard keeps the reference's name
        fname = "name_list.txt" if self.num_shards == 1 else f"name_list.shard{self.shard_index}.txt"
        with open(os.path.join(self.img_root, fname), "w") as f:
            for idx in sorted(names):
                f.write("{} {}\n".format(idx, names[idx]))
        dt = time.time() - t0
        self.logger.info(
            f"extracted {n_images} images in {dt:.1f}s ({n_images / max(dt, 1e-9):.2f} im/s)"
        )
        return n_images, dt
