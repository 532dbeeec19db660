"""The correspondence preprocess of stage 1, Line2Window, and the no-op
of stage 2 (posfeat_tpu/losses/preprocess.py:39-243; reference
losses/preprocess.py:7-129).

Per batch, between the model's forward and the loss: sample grid query
points, take the dense m×n cosine correlation's expected grid
correspondences (and their spread), then refine each with an epipolar
line search and a windowed soft-argmax around the line's hit.

Drawing and computing are split, as in DiskLoss: ``draw`` returns the
grid proposals (or jitters) of both images and the two window jitters,
and ``__call__`` takes them as ``draws=`` or draws them itself from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.distributed import uniform
from ..ops.coords import denormalize_coords, normalize_coords
from ..ops.correlation import dual_softmax, ot_sinkhorn_log, ot_sinkhorn_log_unmatch
from ..ops.epipolar import epipolar_line_search, get_expected_correspondence_within_window
from ..ops.grid_sample import l2_normalize, sample_feat_by_coord
from ..ops.line_window import fused_line_window
from ..ops.priors import PRIORS
from ..ops.resize import interpolate_bilinear
from ..ops.samplers import draw_grid_random, generate_kpts_regular_grid_random

MATCHERS = {
    "ot_sinkhorn": ot_sinkhorn_log,
    "ot_sinkhorn_unmatch": ot_sinkhorn_log_unmatch,
    "dual_softmax": dual_softmax,
}
ENGINES = ("fused", "reference")


class Preprocess_Line2Window:
    __lossname__ = "Preprocess_Line2Window"

    def __init__(self, configs: Dict[str, Any]):
        self.config = configs
        self.t_base = configs["temperature_base"]
        self.t_max = configs["temperature_max"]
        if configs["kps_generator"] != "generate_kpts_regular_grid_random":
            raise ValueError(
                f"kps_generator {configs['kps_generator']!r}: the stage-1 sampler is "
                "generate_kpts_regular_grid_random (the only one the reference configs wire)"
            )
        self.engine = configs.get("engine", "fused")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one of {ENGINES}")
        self.match_prob = configs.get("match_prob", "softmax")
        if self.match_prob != "softmax" and self.match_prob not in MATCHERS:
            raise ValueError(f"unknown match_prob {self.match_prob!r}")
        gcfg = configs["kps_generator_config"]
        self.grid_size = gcfg["grid_size"]
        self.random_select = gcfg.get("random_select", "random")
        self.map_init = gcfg.get("map_init", "identity")
        self.line_cfg = dict(configs.get("line_search_config") or {})

    def name(self):
        return self.__lossname__

    @torch.no_grad()
    def _kp_maps(self, inputs, outputs):
        """The grid sampler's score maps (putils:598-610): ones under
        ``map_init: identity``, else the prior of the upsampled local map."""
        lp1 = outputs["preds1"]["local_point"]
        lp2 = outputs["preds2"]["local_point"]
        if self.map_init == "identity":
            return torch.ones_like(lp1), torch.ones_like(lp2)
        prior = PRIORS[self.map_init]
        maps = []
        for p, im in (("preds1", "im1"), ("preds2", "im2")):
            lm = interpolate_bilinear(outputs[p]["local_map"], inputs[im].shape[1:3])
            maps.append(prior(lm, channel_mean=True) if self.map_init == "SSIM" else prior(lm))
        return tuple(maps)

    def _draw(self, kp_map1, kp_map2, generator: torch.Generator):
        kps = tuple(draw_grid_random(m, self.grid_size, self.random_select, generator)
                    for m in (kp_map1, kp_map2))
        jitters = (None, None)
        if self.config["use_line_search"] and self.line_cfg.get("loc_rand", True):
            g = self.grid_size
            jitters = tuple(uniform((m.shape[0], (m.shape[1] // g) * (m.shape[2] // g), 2), generator, m.device)
                            for m in (kp_map1, kp_map2))
        return {"kps": kps, "jitter1": jitters[0], "jitter2": jitters[1]}

    def draw(self, inputs, outputs, generator: torch.Generator):
        """Both images' grid draws, then the two directions' window jitters
        ([B, N, 2] uniform [0, 1), None without a randomized line search)."""
        return self._draw(*self._kp_maps(inputs, outputs), generator)

    def __call__(self, inputs, outputs, generator: torch.Generator = None, draws=None):
        preds1, preds2 = outputs["preds1"], outputs["preds2"]
        xf1, xf2 = preds1["local_map"], preds2["local_map"]
        h1i, w1i = inputs["im1"].shape[1:3]
        h2i, w2i = inputs["im2"].shape[1:3]
        b = xf1.shape[0]
        temperature = min(self.t_base + outputs["epoch"], self.t_max)
        cos = self.config["loss_distance"] == "cos"
        ws = self.config["window_size"]

        kp_map1, kp_map2 = self._kp_maps(inputs, outputs)
        if draws is None:
            draws = self._draw(kp_map1, kp_map2, generator)
        coord1_n, coord2_n, _, _ = generate_kpts_regular_grid_random(
            kp_map1, kp_map2, self.grid_size, draws["kps"], self.random_select)
        coord1_n = coord1_n.reshape(b, -1, 2)
        coord2_n = coord2_n.reshape(b, -1, 2)
        coord1 = denormalize_coords(coord1_n, h1i, w1i)
        coord2 = denormalize_coords(coord2_n, h2i, w2i)

        feat1_fine = sample_feat_by_coord(xf1, coord1_n, cos)
        feat2_fine = sample_feat_by_coord(xf2, coord2_n, cos)

        # dense grid correlation -> expected locations (preprocess.py:59-81);
        # match_prob: the softmax of the reference (putils:89-115), or the
        # joint matrix of one of its unwired matchers (putils:117-194),
        # conditioned per row and per column
        cos_sim = torch.bmm(feat1_fine, feat2_fine.transpose(1, 2))  # [B, m, n]
        if self.match_prob == "softmax":
            p12 = torch.softmax(temperature * cos_sim, dim=2)
            p21 = torch.softmax(temperature * cos_sim, dim=1)
        else:
            joint, _ = MATCHERS[self.match_prob](
                -cos_sim, iters=int(self.config.get("sinkhorn_iters", 20)), temperature=temperature)
            joint = joint.clamp_min(1e-12)
            p12 = joint / joint.sum(2, keepdim=True)
            p21 = joint / joint.sum(1, keepdim=True)
        p21t = p21.transpose(1, 2)
        feat1g_corloc = torch.bmm(p12, coord2)  # [B, m, 2]
        feat2g_corloc = torch.bmm(p21t, coord1)  # [B, n, 2]
        feat1g_corloc_n = normalize_coords(feat1g_corloc, h2i, w2i).detach()
        feat2g_corloc_n = normalize_coords(feat2g_corloc, h1i, w1i).detach()
        feat1g_std = torch.bmm(p12, coord2_n ** 2) - feat1g_corloc_n ** 2
        feat1g_std = feat1g_std.clamp_min(1e-6).sqrt().sum(-1)
        feat2g_std = torch.bmm(p21t, coord1_n ** 2) - feat2g_corloc_n ** 2
        feat2g_std = feat2g_std.clamp_min(1e-6).sqrt().sum(-1)

        # the temperature-scaled normalized maps the searches read
        xf2_n = temperature * l2_normalize(xf2)
        xf1_n = temperature * l2_normalize(xf1)

        lcfg = self.line_cfg
        if self.config["use_line_search"] and self.engine == "fused":
            kw = dict(window_size=ws, use_nn=lcfg.get("use_nn", True),
                      loc_rand=lcfg.get("loc_rand", True))
            _, c1n_org, valid1, feat1w_corloc_n, feat1w_std = fused_line_window(
                xf2_n, feat1_fine, coord1, inputs["F1"], h2i, w2i, jitter_u=draws["jitter1"], **kw)
            _, c2n_org, valid2, feat2w_corloc_n, feat2w_std = fused_line_window(
                xf1_n, feat2_fine, coord2, inputs["F2"], h1i, w1i, jitter_u=draws["jitter2"], **kw)
            feat1c_corloc_org = denormalize_coords(c1n_org, h2i, w2i)
        else:
            if self.config["use_line_search"]:
                c1n_, c1n_org, valid1, _ = epipolar_line_search(
                    coord1, inputs["F1"], feat1_fine, xf2_n, h2i, w2i,
                    jitter_u=draws["jitter1"], window_size=ws, **lcfg)
                c2n_, c2n_org, valid2, _ = epipolar_line_search(
                    coord2, inputs["F2"], feat2_fine, xf1_n, h1i, w1i,
                    jitter_u=draws["jitter2"], window_size=ws, **lcfg)
                feat1c_corloc_org = denormalize_coords(c1n_org, h2i, w2i)
            else:
                c1n_, c2n_ = feat1g_corloc_n, feat2g_corloc_n
                c2n_org = c2n_
                feat1c_corloc_org = c1n_
                valid1 = torch.ones_like(feat1g_std, dtype=torch.bool)
                valid2 = torch.ones_like(feat2g_std, dtype=torch.bool)
            feat1w_corloc_n, _, feat1w_std, _ = get_expected_correspondence_within_window(
                feat1_fine, xf2_n, c1n_, ws, with_std=True)
            feat2w_corloc_n, _, feat2w_std, _ = get_expected_correspondence_within_window(
                feat2_fine, xf1_n, c2n_, ws, with_std=True)

        return {
            "coord1": coord1,
            "coord2": coord2,
            "feat1g_corloc": feat1g_corloc,
            "feat2g_corloc": feat2g_corloc,
            "feat1w_corloc": denormalize_coords(feat1w_corloc_n, h2i, w2i),
            "feat2w_corloc": denormalize_coords(feat2w_corloc_n, h1i, w1i),
            "feat1c_corloc_org": feat1c_corloc_org,
            # kept normalized for image 2, as the reference does (preprocess.py:113)
            "feat2c_corloc_org": c2n_org,
            "feat1g_std": feat1g_std,
            "feat2g_std": feat2g_std,
            "feat1w_std": feat1w_std,
            "feat2w_std": feat2w_std,
            "temperature": temperature,
            "valid_epi1": valid1,
            "valid_epi2": valid2,
        }


class Preprocess_Skip:
    """No-op preprocess for stage 2 (reference preprocess.py:120-129)."""

    __lossname__ = "Preprocess_Skip"

    def __init__(self, configs=None, **kwargs):
        pass

    def name(self):
        return self.__lossname__

    def __call__(self, inputs, outputs, generator=None, draws=None):
        return None
