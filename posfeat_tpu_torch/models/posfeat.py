"""PoSFeat composite model: descriptor backbone + keypoint score head
(posfeat_tpu/models/posfeat.py; reference networks/PoSFeat_model.py:15-147).

Checkpoints use the reference's per-module layout: ``backbone.pth`` and
``localheader.pth`` in one directory. A missing module keeps its current
parameters (how stage 2 starts with a fresh head).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.profiling import span
from .keypoint_det import KeypointDet
from .resunet import ResUNet, ResUNetHR

BACKBONES = {"ResUNet": ResUNet, "ResUNetHR": ResUNetHR}
HEADS = {"KeypointDet": KeypointDet}


# flax's variance_scaling(1, "fan_in", "truncated_normal"): the std of a
# unit normal truncated at ±2 is 0.87962566..., so the draw's std is raised
# by its inverse to keep the variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX modules' init, drawn from ``generator``: conv kernels from
    flax's ``lecun_normal`` (a normal of std fan_in^-½ / 0.8796,
    truncated at ±2 of that std, so that the variance is 1 / fan_in;
    fan_in = kh·kw·cin/groups), zero biases, identity BatchNorm, PReLU
    slope 0.25."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


class PoSFeat(nn.Module):
    """Composite of ``backbone`` and ``localheader``.

    config keys (reference PoSFeat_model.py:16-46): backbone,
    backbone_config, localheader, localheader_config, align_local_grad,
    local_input_elements, local_with_img. ``backbone_config`` carries the
    bf16 decoder's ``desc_tail``, ``decoder_accum`` and ``desc_f32``, and
    ``localheader_config`` the fused head's ``head_ring`` and
    ``head_im2col`` (the Extractor's resolved ``fast_gates`` put them
    there); none changes a parameter. ``dtype`` is the compute dtype:
    backbone and head keep f32 parameters and BatchNorm statistics and
    cast per op, as the JAX modules' ``param_dtype=float32``
    (posfeat_tpu/models/resunet.py:43,59), so an optimizer updates f32
    parameters and a checkpoint is f32 at either dtype. Weights are drawn
    from a ``torch.Generator`` seeded with ``seed`` unless a checkpoint is
    loaded over them.
    """

    module_names = ("backbone", "localheader")

    def __init__(self, config: Dict[str, Any], dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.align_local_grad = config["align_local_grad"]
        self.local_input_elements = list(config["local_input_elements"])
        self.local_with_img = config["local_with_img"]
        if not self.local_with_img:
            raise ValueError(
                "KeypointDet requires local_with_img=True (reference DeteNet "
                "forward consumes [feat, image])"
            )
        backbone = BACKBONES[config["backbone"]](**(config.get("backbone_config") or {}), dtype=dtype)
        head_name = config.get("localheader")
        if head_name and head_name != "None":
            head = HEADS[head_name](**(config.get("localheader_config") or {}), dtype=dtype)
        else:  # default head (PoSFeat_model.py:37-42)
            head = KeypointDet(in_channels=backbone.out_channels[0], out_channels=2, dtype=dtype)
        g = torch.Generator().manual_seed(seed)
        init_parameters(backbone, g)
        init_parameters(head, g)
        self.backbone = backbone.to(device=dev)
        self.localheader = head.to(device=dev)
        self.eval()

    def _outputs(self, feat_maps, tensor: torch.Tensor, detach_local_input: bool = False):
        """The head on the backbone's maps -> the reference output dict
        (PoSFeat_model.py:91-134, NHWC maps)."""
        b, h16, w16, _ = feat_maps["global_map"].shape
        local_map = feat_maps["local_map"]
        g_map = torch.ones((b, h16, w16, 1), dtype=local_map.dtype, device=local_map.device)
        local_input = torch.cat([feat_maps[n] for n in self.local_input_elements], dim=-1)
        if detach_local_input:
            local_input = local_input.detach()
        with span("model.head"):
            l_map = self.localheader(local_input, tensor)
        if l_map.shape[-1] == 1:
            local_thr = torch.zeros_like(l_map)
        else:
            local_thr = l_map[..., 1:]
            l_map = l_map[..., :1]
        g_desc = g_map * feat_maps["global_map"]
        g_desc = g_desc / torch.linalg.vector_norm(g_desc, dim=-1, keepdim=True).clamp_min(1e-12)
        return {
            "local_map": local_map,
            "global_map": feat_maps["global_map"],
            "global_feat": g_desc.mean(dim=(1, 2)),
            "local_point": l_map,
            "local_thr": local_thr,
            "global_point": g_map,
        }

    @torch.no_grad()
    def extract(self, tensor: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Single-image feature extraction in eval mode, without a graph:
        NHWC image [B, H, W, 3] -> the reference output dict."""
        self.eval()
        with span("model.backbone"):
            feat_maps = self.backbone(tensor)
        return self._outputs(feat_maps, tensor)

    def forward(self, inputs: Dict[str, torch.Tensor], train: bool = False):
        """Two-view forward (PoSFeat_model.py:136-147) with autograd, the
        training forward of both stages. ``train=True`` (stage 1) runs the
        backbone's BatchNorm in training mode: each view is normalized by
        its own batch's statistics and updates the running statistics,
        image 1's call first, as the JAX forward with ``mutable_bn``
        (posfeat.py:141-147); ``train=False`` (stage 2) keeps them in eval
        mode (trainer.py:285-291). The backbone builds a graph only when
        one of its parameters requires a gradient. The head runs in eval
        mode in both stages, and ``align_local_grad: False`` detaches its
        input as the JAX ``stop_gradient`` does (posfeat.py:100-101). At
        bf16 the head takes its bf16 dataflow, by default the dilated
        composite, as the JAX head does; the fused kernels K1/K2
        (``fused_upsample="pallas"``) have no backward and are refused
        here."""
        if torch.is_grad_enabled() and self.localheader.fused_upsample == "pallas":
            raise NotImplementedError(
                "fused_upsample='pallas' under autograd: the fused head's kernels K1/K2 have no "
                "backward; train with the head's other dataflows (see ROADMAP.md)"
            )
        self.eval()
        self.backbone.train(train)
        backbone_grad = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.backbone.parameters()
        )
        out = {}
        for key, im in (("preds1", inputs["im1"]), ("preds2", inputs["im2"])):
            with torch.set_grad_enabled(backbone_grad), span("model.backbone"):
                feat_maps = self.backbone(im)
            out[key] = self._outputs(feat_maps, im, detach_local_input=not self.align_local_grad)
        return out

    def save_checkpoint(self, save_path: str) -> None:
        os.makedirs(save_path, exist_ok=True)
        for name in self.module_names:
            torch.save(getattr(self, name).state_dict(), os.path.join(save_path, f"{name}.pth"))

    def load_checkpoint(self, load_path: str) -> None:
        """Load per-module ``.pth`` files; missing modules keep their
        current parameters (PoSFeat_model.py:57-72)."""
        for name in self.module_names:
            path = os.path.join(load_path, f"{name}.pth")
            if os.path.exists(path):
                sd = torch.load(path, map_location="cpu", weights_only=True)
                getattr(self, name).load_state_dict(sd)
                print(f"load {name} from checkpoint")
            else:
                print(f"{name} does not exist, skipping load")


MODELS = {"PoSFeat": PoSFeat}
