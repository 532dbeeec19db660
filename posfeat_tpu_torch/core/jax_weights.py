"""JAX (flax) PoSFeat variables -> the port's torch ``state_dict``s.

The inverse of ``posfeat_tpu/core/torch_import.py``, written again here:
the port imports nothing of the JAX package. ``to_jax_head_params``
maps a head's ``state_dict`` back to flax params. Names follow the reference
checkpoints (networks/DescNet.py, DeteNet.py), so the result also loads
into the reference and ``torch.save`` gives ``backbone.pth`` /
``localheader.pth``.

  flax path                                  torch name
  -----------------------------------------  ------------------------------
  params/encoder/firstconv/kernel            firstconv.weight
  params|batch_stats/encoder/firstbn/*       firstbn.{weight,bias,running_*}
  .../encoder/layerX_{Y}/convZ|bnZ           layerX.Y.convZ|bnZ
  .../encoder/layerX_{Y}/ds_conv|ds_bn       layerX.Y.downsample.0|1
  conv_coarse|conv_fine|iconvN/{conv,bn}     <name>.conv|bn
  upconvN/conv/{conv,bn}                     upconvN.conv.conv|bn
  (head) convK/{kernel,bias}                 convK.{weight,bias}
  (head) prelu                               relu.weight

Conv kernels go [kh, kw, in, out] -> [out, in, kh, kw]; BatchNorm
``scale`` becomes ``weight`` and ``mean``/``var`` become ``running_*``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _conv_w(k) -> torch.Tensor:
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _bn(sd, prefix, params, stats):
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _convbnelu(sd, prefix, params, stats):
    sd[prefix + ".conv.weight"] = _conv_w(params["conv"]["kernel"])
    sd[prefix + ".conv.bias"] = _t(params["conv"]["bias"])
    _bn(sd, prefix + ".bn", params["bn"], stats["bn"])


def backbone_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ResUNet/ResUNetHR {'params', 'batch_stats'} -> state_dict."""
    P, S = variables["params"], variables["batch_stats"]
    hr = "encoder" not in P  # ResUNetHR keeps its stem and layers at the top
    enc, encs = (P, S) if hr else (P["encoder"], S["encoder"])
    stem_conv, stem_bn = ("stem_conv", "stem_bn") if hr else ("firstconv", "firstbn")
    sd: Dict[str, torch.Tensor] = {}
    sd["firstconv.weight"] = _conv_w(enc[stem_conv]["kernel"])
    _bn(sd, "firstbn", enc[stem_bn], encs[stem_bn])
    blocks = sorted(
        (int(m.group(1)), int(m.group(2)), name)
        for name in enc
        if (m := re.fullmatch(r"layer(\d)_(\d+)", name))
    )
    for li, bi, name in blocks:
        tp = f"layer{li}.{bi}"
        bp, bs = enc[name], encs[name]
        for ci in (1, 2, 3):
            if f"conv{ci}" in bp:
                sd[f"{tp}.conv{ci}.weight"] = _conv_w(bp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{tp}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
        if "ds_conv" in bp:
            sd[f"{tp}.downsample.0.weight"] = _conv_w(bp["ds_conv"]["kernel"])
            _bn(sd, f"{tp}.downsample.1", bp["ds_bn"], bs["ds_bn"])
    for name in ("conv_coarse", "conv_fine", "iconv3", "iconv2", "iconv1"):
        if name in P:
            _convbnelu(sd, name, P[name], S[name])
    for name in ("upconv3", "upconv2", "upconv1"):
        if name in P:
            _convbnelu(sd, f"{name}.conv", P[name]["conv"], S[name]["conv"])
    return sd


def head_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax KeypointDet {'params'} -> state_dict."""
    P = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2", "conv3", "convimg"):
        sd[f"{name}.weight"] = _conv_w(P[name]["kernel"])
        sd[f"{name}.bias"] = _t(P[name]["bias"])
    sd["relu.weight"] = _t(P["prelu"])
    return sd


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """PoSFeat variables as nested numpy dicts
    ({'backbone': {'params', 'batch_stats'}, 'localheader': {'params'}})
    -> {'backbone': state_dict, 'localheader': state_dict}."""
    return {
        "backbone": backbone_state_dict(variables["backbone"]),
        "localheader": head_state_dict(variables["localheader"]),
    }


def to_jax_head_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """KeypointDet state_dict -> flax {'params'} as numpy arrays: the
    inverse of ``head_state_dict``, so a head trained here can be held
    against (or loaded into) the JAX head."""
    def np_(t):
        return t.detach().cpu().numpy()

    P: Dict[str, Any] = {
        name: {
            "kernel": np_(state_dict[f"{name}.weight"]).transpose(2, 3, 1, 0),
            "bias": np_(state_dict[f"{name}.bias"]),
        }
        for name in ("conv1", "conv2", "conv3", "convimg")
    }
    P["prelu"] = np_(state_dict["relu.weight"])
    return {"params": P}
