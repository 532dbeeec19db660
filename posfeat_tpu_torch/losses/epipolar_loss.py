"""Stage-1 descriptor loss: the masked, inverse-std-weighted epipolar
cost of the predicted correspondences (posfeat_tpu/losses/epipolar_loss.py:13-84;
reference losses/epipolarloss.py:8-101).

Under ``multihost:`` each rank holds a share of the global batch, and
JAX's means run over the global batch: the weight normalisers are global
means (detached), each loss term is this rank's share of its global mean,
and the components reduce across ranks by ``COMPONENT_REDUCTIONS``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.distributed import global_mean, mean_share
from ..ops.epipolar import epipolar_cost


class EpipolarLoss_full:
    __lossname__ = "EpipolarLoss_fullinfo"
    # the ranks' loss terms are shares of the global mean; the masks' means are equal shares
    COMPONENT_REDUCTIONS = {**dict.fromkeys(("loss_g1", "loss_w1", "loss_g2", "loss_w2"), "sum"),
                            "percent_g": "mean", "percent_w": "mean"}

    def __init__(self, configs: Dict[str, Any]):
        self.config = configs
        self.w_g = configs["weight_grid"]
        self.w_w = configs["weight_window"]

    def name(self):
        return self.__lossname__

    def _weight(self, inverse_std: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Normalized, detached inverse-std weights (epipolarloss.py:25-36),
        normalized by their means over the global batch."""
        if self.config["use_std_as_weight"]:
            weight = (inverse_std / global_mean(inverse_std.detach())).detach()
        else:
            weight = torch.ones_like(inverse_std)
        weight = weight * mask.to(weight.dtype)
        return weight / (global_mean(weight) + 1e-8)

    def __call__(self, inputs, outputs, processed, generator=None, draws=None):
        """(loss, components); the loss draws nothing."""
        shorter_edge = min(inputs["im1"].shape[1:3])
        thr = {"g": shorter_edge * self.config["grid_cost_thr"],
               "w": shorter_edge * self.config["win_cost_thr"]}
        losses, masks = {}, {}
        for i, coord, fmat in ((1, processed["coord1"], inputs["F1"]),
                               (2, processed["coord2"], inputs["F2"])):
            for k in ("g", "w"):
                cost = epipolar_cost(coord, processed[f"feat{i}{k}_corloc"], fmat)
                mask = cost < thr[k]
                if "valid_epi1" in processed:
                    mask = mask & processed[f"valid_epi{i}"]
                weight = self._weight(1 / processed[f"feat{i}{k}_std"].clamp_min(1e-10), mask)
                losses[f"loss_{k}{i}"] = mean_share(weight * cost)
                masks[f"{k}{i}"] = mask.float().mean()
        loss = (self.w_g * (losses["loss_g1"] + losses["loss_g2"])
                + self.w_w * (losses["loss_w1"] + losses["loss_w2"]))
        components = {
            **{k: losses[k].detach() for k in ("loss_g1", "loss_w1", "loss_g2", "loss_w2")},
            "percent_g": (masks["g1"] + masks["g2"]) / 2,
            "percent_w": (masks["w1"] + masks["w2"]) / 2,
        }
        return loss, components
