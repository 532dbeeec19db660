"""Stage-2 DISK-style REINFORCE detector loss
(posfeat_tpu/losses/disk_loss.py:48-371; reference losses/kploss.py).

Per-cell Categorical pixel proposals and Bernoulli accepts on both score
maps, a dual-Categorical match distribution over the m×n descriptor
cost, and a bidirectional epipolar reward.

Two formulations, chosen as the JAX ``_use_pallas`` chooses
(disk_loss.py:135-152): an eligible configuration (detached match
distribution, constant un-rescaled reward) takes the streamed reduction
of ``ops/reinforce.py`` at any descriptor width, whose kernels run for
CUDA tensors and whose plain version runs for CPU tensors;
``use_pallas: False`` and every other configuration take the dense
formulation. The gradient reaches the score
maps through the sampled log-probabilities and, under ``loc_weight``,
through the soft-argmax offsets.

Two sub-pixel levers, both off by default (disk_loss.py:64-81), take
the dense formulation, as JAX's ``_use_pallas`` excludes them:
``reward_at_refined`` rewards each pair at its sampled pixels plus their
stop-grad quadratic-fit offsets, the coordinates a ``refine: quad``
extraction emits; ``loc_weight`` adds loc_weight · loc_pen, the mean
epipolar distance of the accepted, epipolar-good pairs at their
soft-argmax peaks (``loc_temperature``, ``loc_window``), weighted by the
detached match probability. Unlike the JAX package, the port computes
both offsets at the sampled cells only (each from its own window; the
values equal the dense map's there), and its loc gate reads the
thresholds that ``rescale_thr`` rescales, as the reward does.

Under ``multihost:`` each rank holds a share of the global batch. The
REINFORCE objective and the keypoint penalty are sums over the batch, so
a rank's loss is its own sum; ``loc_pen`` divides by the global weight
sum; the components reduce across ranks by ``COMPONENT_REDUCTIONS``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.distributed import global_sum
from ..ops.coords import homogenize, normalize_coords
from ..ops.detect import quad_offsets_at, softargmax_offsets_at
from ..ops.epipolar import epipolar_lines, epipolar_pairwise_dist
from ..ops.grid_sample import sample_feat_by_coord
from ..ops.reinforce import reinforce_reduction
from ..ops.samplers import (
    accept_logits,
    bernoulli_logp,
    categorical_logp,
    cell_coords_pixel,
    draw_bernoulli,
    draw_categorical,
    grid_cells,
)


class DiskLoss:
    __lossname__ = "DiskLoss"
    # how each component of a rank's share reduces to the global batch's value
    COMPONENT_REDUCTIONS = {
        "reinforce": "sum", "kp_penalty": "sum", "loc_pen": "sum",
        "scale1": "mean", "scale2": "mean", "n_kps": "mean", "cor mean": "mean", "n_pairs": "mean",
        "temperature": "mean", "reward_thr": "mean",
        "cor max": "max", "cor summax": "max",
        "cor minmax": "min", "cor minmean": "min", "cor summin": "min",
    }

    def __init__(self, configs: Dict[str, Any]):
        self.config = configs
        self.unfold_size = configs["grid_size"]
        self.t_base = configs["temperature_base"]
        self.t_max = configs["temperature_max"]
        self.reward_name = configs["epipolar_reward"]
        if self.reward_name not in ("constant_reward", "dynamic_reward"):
            raise ValueError(f"unknown epipolar_reward {self.reward_name!r}")
        self.good_reward = configs["good_reward"]
        self.bad_reward = configs["bad_reward"]
        self.kp_penalty = configs["kp_penalty"]
        self.reward_at_refined = configs.get("reward_at_refined", False)
        self.loc_weight = configs.get("loc_weight", 0.0)
        self.loc_temperature = configs.get("loc_temperature", 20.0)
        self.loc_window = configs.get("loc_window", 3)
        if self.loc_window % 2 != 1 or self.loc_window < 3:
            raise ValueError(f"loc_window must be odd and >= 3, got {self.loc_window}")

    def name(self):
        return self.__lossname__

    # ------------------------------------------------------------ sample

    def draw(self, kp_map: torch.Tensor, generator: torch.Generator):
        """(proposals [B, hg, wg] int64, accept [B, hg, wg] bool), drawn
        without a graph: a Categorical pixel per cell, then its Bernoulli
        accept (kploss.py:20-31)."""
        cells = grid_cells(kp_map, self.unfold_size)
        proposals = draw_categorical(cells, generator)
        accept = draw_bernoulli(accept_logits(cells, proposals), generator)
        return proposals, accept

    def point_score(self, kp_map: torch.Tensor, proposals: torch.Tensor, accept: torch.Tensor):
        """Given the draws: (pixel coords [B, hg, wg, 2], logp [B, hg, wg]),
        logp = log p(proposal) + log p(accept), with its graph."""
        cells = grid_cells(kp_map, self.unfold_size)
        logp = categorical_logp(cells, proposals) + bernoulli_logp(
            accept_logits(cells, proposals), accept
        )
        H, W = kp_map.shape[1:3]
        return cell_coords_pixel(H, W, self.unfold_size, proposals), logp

    def point_sample(self, kp_map: torch.Tensor, generator: torch.Generator):
        """kp_map [B, H, W, 1] -> (coords px [B, hg, wg, 2], logp, accept)
        (disk_loss.py:83-94)."""
        proposals, accept = self.draw(kp_map, generator)
        kps, logp = self.point_score(kp_map, proposals, accept)
        return kps, logp, accept

    # ------------------------------------------------------------ reward

    def _epipolar_dists(self, inputs, coord1, coord2):
        d1 = epipolar_pairwise_dist(coord1, coord2, inputs["F1"])  # [B, m, n]
        d2t = epipolar_pairwise_dist(coord2, coord1, inputs["F2"])  # [B, n, m]
        return d1, d2t.transpose(1, 2)

    def _thresholds(self, d1, d2, reward_thr, rescale_thr):
        if not rescale_thr:
            one = torch.ones((), dtype=d1.dtype, device=d1.device)
            return reward_thr, reward_thr, one, one
        b = d1.shape[0]
        m1 = d1.detach().reshape(b, -1).mean(1, keepdim=True)
        m2 = d2.detach().reshape(b, -1).mean(1, keepdim=True)
        dmin = torch.minimum(m1, m2).clamp_min(1e-6)
        scale1, scale2 = m1 / dmin, m2 / dmin
        return (reward_thr * scale1).reshape(b, 1, 1), (reward_thr * scale2).reshape(b, 1, 1), scale1, scale2

    def constant_reward(self, inputs, coord1, coord2, reward_thr, rescale_thr):
        d1, d2 = self._epipolar_dists(inputs, coord1, coord2)
        thr1, thr2, scale1, scale2 = self._thresholds(d1, d2, reward_thr, rescale_thr)
        good = (d1 < thr1) & (d2 < thr2)
        reward = self.good_reward * good.float() + self.bad_reward * (~good).float()
        return reward.detach(), scale1, scale2

    def dynamic_reward(self, inputs, coord1, coord2, reward_thr, rescale_thr):
        d1, d2 = self._epipolar_dists(inputs, coord1, coord2)
        thr1, thr2, scale1, scale2 = self._thresholds(d1, d2, reward_thr, rescale_thr)
        reward = torch.exp(-d1 / thr1) + torch.exp(-d2 / thr2) - 2 / math.exp(1.0)
        return reward.clamp_min(self.bad_reward).detach(), scale1, scale2

    # -------------------------------------------------------------- loss

    def _use_streamed(self) -> bool:
        """The streamed reduction covers the shipped configuration
        (detached match distribution, constant un-rescaled reward, neither
        sub-pixel lever) at any descriptor width, as the JAX reduction
        does; anything else takes the dense path, chosen before any
        launch as the JAX package's ``_use_pallas`` chooses."""
        if self.config.get("use_pallas", "auto") is False:
            return False
        return bool(
            self.config["cor_detach"]
            and not self.config["match_grad"]
            and self.reward_name == "constant_reward"
            and not self.config["reward_config"].get("rescale_thr", False)
            and not self.reward_at_refined
            and not self.loc_weight
        )

    def _reward_config(self, epoch) -> Dict[str, Any]:
        """Per-epoch reward config: ``reward_thr_final`` with
        ``reward_anneal_epochs`` anneals the threshold linearly from
        ``reward_thr`` (epoch 1) to ``reward_thr_final`` (epoch >= 1 +
        reward_anneal_epochs) (disk_loss.py:154-174)."""
        rcfg = dict(self.config["reward_config"])
        thr_final = rcfg.pop("reward_thr_final", None)
        anneal = rcfg.pop("reward_anneal_epochs", 0)
        if thr_final is not None and anneal:
            frac = min(max(epoch - 1, 0) / float(anneal), 1.0)
            base = rcfg["reward_thr"]
            rcfg["reward_thr"] = base + (thr_final - base) * frac
        return rcfg

    def _components(self, reinforce, kp_penalty, scale1, scale2, a1, a2, temperature, reward_thr,
                    cor):
        dev = a1.device
        return {
            "reinforce": reinforce.detach(),
            "kp_penalty": kp_penalty.detach(),
            "scale1": scale1.mean(),
            "scale2": scale2.mean(),
            **cor,
            "n_kps": (a1.sum(-1) + a2.sum(-1)).float().mean(),
            "temperature": torch.tensor(float(temperature), device=dev),
            "reward_thr": torch.tensor(float(reward_thr), device=dev),
        }

    def _streamed_loss(self, inputs, feat1, feat2, coord1, coord2, logp1, logp2,
                       accept1, accept2, temperature, reward_thr):
        """Loss via the streamed reduction (disk_loss.py:176-243)."""
        b, m, n = feat1.shape[0], feat1.shape[1], feat2.shape[1]
        a1, a2 = accept1.reshape(b, -1), accept2.reshape(b, -1)
        s0, roww, colw, p_rowsum, p_colsum, p_max, p_sum = reinforce_reduction(
            feat1, feat2,
            epipolar_lines(inputs["F1"], coord1), homogenize(coord2),
            epipolar_lines(inputs["F2"], coord2), homogenize(coord1),
            a1, a2,
            temperature=float(temperature), thr=float(reward_thr),
            good_reward=float(self.good_reward), bad_reward=float(self.bad_reward),
        )
        logp1f, logp2f = logp1.reshape(b, -1), logp2.reshape(b, -1)
        reinforce = s0.sum() + (logp1f * roww).sum() + (logp2f * colw).sum()
        kp_penalty = self.kp_penalty * ((a1 * logp1f).sum() + (a2 * logp2f).sum())
        loss = -reinforce - kp_penalty
        mn = m * n
        one = torch.ones((), device=feat1.device)
        cor = {
            "cor minmax": p_max.min(),
            "cor minmean": (p_sum / mn).min(),
            "cor max": p_max.max(),
            "cor mean": p_sum.sum() / (b * mn),
            "cor summin": torch.minimum(p_rowsum.min(), p_colsum.min()),
            "cor summax": torch.maximum(p_rowsum.max(), p_colsum.max()),
            "n_pairs": p_sum.mean(),
        }
        return loss, self._components(reinforce, kp_penalty, one, one, a1, a2, temperature,
                                      reward_thr, cor)

    def __call__(self, inputs, outputs, processed, generator: Optional[torch.Generator] = None,
                 draws=None):
        """(loss, components). The draws come from ``generator`` (image 1's
        proposals and accepts, then image 2's), or are given as
        ``draws = ((proposals1, accept1), (proposals2, accept2))``."""
        preds1, preds2 = outputs["preds1"], outputs["preds2"]
        kp_map1, kp_map2 = preds1["local_point"], preds2["local_point"]
        xf1, xf2 = preds1["local_map"], preds2["local_map"]
        b = xf1.shape[0]
        H, W = kp_map1.shape[1:3]
        temperature = min(self.t_base + outputs["epoch"], self.t_max)
        rcfg = self._reward_config(outputs["epoch"])
        cos = self.config["loss_distance"] == "cos"

        if draws is None:
            draws = (self.draw(kp_map1, generator), self.draw(kp_map2, generator))
        (prop1, accept1), (prop2, accept2) = draws
        coord1, logp1 = self.point_score(kp_map1, prop1, accept1)
        coord2, logp2 = self.point_score(kp_map2, prop2, accept2)
        coord1, coord2 = coord1.reshape(b, -1, 2), coord2.reshape(b, -1, 2)

        feat1 = sample_feat_by_coord(xf1, normalize_coords(coord1, H, W), cos)  # [B, m, c]
        feat2 = sample_feat_by_coord(xf2, normalize_coords(coord2, H, W), cos)  # [B, n, c]

        if self._use_streamed():
            return self._streamed_loss(inputs, feat1, feat2, coord1, coord2, logp1, logp2,
                                       accept1, accept2, temperature, rcfg["reward_thr"])

        costs = 1 - torch.bmm(feat1, feat2.transpose(1, 2))  # [B, m, n] in [0, 2]
        if not self.config["match_grad"]:
            costs = costs.detach()
        affinity = -temperature * costs

        # dual Categorical match distribution (kploss.py:162-166)
        logp_I = F.log_softmax(affinity, dim=2)
        logp_T = F.log_softmax(affinity, dim=1)
        dense_p = torch.exp(logp_I) * torch.exp(logp_T)
        dense_logp = logp_I + logp_T
        sample_p = dense_p.detach() if self.config["cor_detach"] else dense_p

        rcoord1, rcoord2 = coord1, coord2
        if self.reward_at_refined:
            # reward what a refine: quad extraction emits (no gradient on this path)
            rcoord1 = coord1 + quad_offsets_at(kp_map1, coord1)
            rcoord2 = coord2 + quad_offsets_at(kp_map2, coord2)
        reward, scale1, scale2 = getattr(self, self.reward_name)(inputs, rcoord1, rcoord2, **rcfg)

        logp1f, logp2f = logp1.reshape(b, -1), logp2.reshape(b, -1)
        kps_logp = logp1f[:, :, None] + logp2f[:, None, :]  # [B, m, n]
        sample_plogp = sample_p * (dense_logp + kps_logp)
        a1, a2 = accept1.reshape(b, -1), accept2.reshape(b, -1)
        accept_mask = (a1[:, :, None] & a2[:, None, :]).float()

        reinforce = (accept_mask * reward * sample_plogp).sum()
        kp_penalty = self.kp_penalty * ((a1 * logp1f).sum() + (a2 * logp2f).sum())
        loss = -reinforce - kp_penalty

        if self.loc_weight:
            # the epipolar distances of each accepted pair at its
            # soft-argmax peaks; the gradient reaches the score maps only
            # through the soft offsets. The gate reads the reward's
            # thresholds, rescaled where rescale_thr rescales them.
            lcoord1 = coord1 + softargmax_offsets_at(kp_map1, coord1, self.loc_temperature, self.loc_window)
            lcoord2 = coord2 + softargmax_offsets_at(kp_map2, coord2, self.loc_temperature, self.loc_window)
            d1r, d2r = self._epipolar_dists(inputs, lcoord1, lcoord2)
            thr1 = (rcfg["reward_thr"] * scale1).reshape(-1, 1, 1)  # _thresholds' thr1; scale 1 unrescaled
            thr2 = (rcfg["reward_thr"] * scale2).reshape(-1, 1, 1)
            good_loc = ((d1r < thr1) & (d2r < thr2)).float().detach()
            w_pair = accept_mask * good_loc * sample_p.detach()
            loc_pen = (w_pair * (d1r + d2r)).sum() / global_sum(w_pair.detach()).clamp_min(1.0)
            loss = loss + self.loc_weight * loc_pen

        sp = sample_p.detach()
        cor = {
            "cor minmax": sp.reshape(b, -1).amax(-1).min(),
            "cor minmean": sp.reshape(b, -1).mean(-1).min(),
            "cor max": sp.max(),
            "cor mean": sp.mean(),
            "cor summin": torch.minimum(sp.sum(1).min(), sp.sum(2).min()),
            "cor summax": torch.maximum(sp.sum(1).max(), sp.sum(2).max()),
            "n_pairs": sp.sum((-1, -2)).mean(),
        }
        components = self._components(reinforce, kp_penalty, scale1, scale2, a1, a2, temperature,
                                      rcfg["reward_thr"], cor)
        if self.loc_weight:
            components["loc_pen"] = loc_pen.detach()
        return loss, components
