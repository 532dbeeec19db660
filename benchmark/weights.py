"""The model's weights, made on the device from the seed in a few large
calls, under the reference's torch names (``backbone.*``,
``localheader.*``): conv kernels normal with std fan_in^-½ clamped at ±2
std; conv biases, BatchNorm's affine parameters and running statistics,
and the PReLU slope drawn around their usual values, so that every one of
them matters. Both the program and the reference are handed these."""

from __future__ import annotations

import torch

from .reference.extraction import ENCODER_BLOCKS


def _conv(name, cin, cout, k, bias):
    out = [(name + ".weight", (cout, cin, k, k), "conv")]
    return out + [(name + ".bias", (cout,), "bias")] if bias else out


def _bn(name, c):
    return [(name + ".weight", (c,), "gamma"), (name + ".bias", (c,), "beta"),
            (name + ".running_mean", (c,), "mean"), (name + ".running_var", (c,), "var"),
            (name + ".num_batches_tracked", (), "count")]


def _conv_bn(name, cin, cout, k):
    return _conv(name + ".conv", cin, cout, k, True) + _bn(name + ".bn", cout)


def backbone_leaves(encoder: str, coarse_out: int, fine_out: int) -> list:
    """(name, shape, kind) of ResUNet's parameters and buffers."""
    leaves = _conv("firstconv", 3, 64, 7, False) + _bn("firstbn", 64)
    cin = 64
    for li, (n_blocks, planes) in enumerate(zip(ENCODER_BLOCKS[encoder], (64, 128, 256))):
        for bi in range(n_blocks):
            name = f"layer{li + 1}.{bi}"
            leaves += _conv(name + ".conv1", cin, planes, 1, False) + _bn(name + ".bn1", planes)
            leaves += _conv(name + ".conv2", planes, planes, 3, False) + _bn(name + ".bn2", planes)
            leaves += _conv(name + ".conv3", planes, 4 * planes, 1, False) + _bn(name + ".bn3", 4 * planes)
            if bi == 0:
                leaves += _conv(name + ".downsample.0", cin, 4 * planes, 1, False) + _bn(name + ".downsample.1", 4 * planes)
            cin = 4 * planes
    c1, c2, c3 = 256, 512, 1024
    leaves += _conv_bn("conv_coarse", c3, coarse_out, 1)
    leaves += _conv_bn("upconv3.conv", c3, 512, 3)
    leaves += _conv_bn("iconv3", c2 + 512, 512, 3)
    leaves += _conv_bn("upconv2.conv", 512, 256, 3)
    leaves += _conv_bn("iconv2", c1 + 256, 256, 3)
    leaves += _conv_bn("conv_fine", 256, fine_out, 1)
    return leaves


def head_leaves(in_channels: int) -> list:
    return (_conv("conv1", in_channels, in_channels, 3, True) + _conv("conv2", in_channels + 64, 128, 3, True)
            + _conv("conv3", 128, 1, 1, True) + [("relu.weight", (1,), "slope")] + _conv("convimg", 3, 64, 3, True))


def make(model_config: dict, seed: int, device) -> dict:
    """{'backbone.<name>': tensor, 'localheader.<name>': tensor}, f32
    (the step counts int64), from ``seed`` with a generator on ``device``."""
    bb = model_config["backbone_config"]
    leaves = [("backbone." + n, s, k) for n, s, k in
              backbone_leaves(bb["encoder"], bb["coarse_out_ch"], bb["fine_out_ch"])]
    leaves += [("localheader." + n, s, k) for n, s, k in
               head_leaves(model_config["localheader_config"]["in_channels"])]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    numel = lambda s: int(torch.Size(s).numel())
    convs = [(n, s) for n, s, k in leaves if k == "conv"]
    others = [(n, s, k) for n, s, k in leaves if k not in ("conv", "count")]
    normal = torch.randn(sum(numel(s) for _, s in convs), generator=gen, device=device).clamp_(-2.0, 2.0)
    uniform = torch.rand(sum(numel(s) for _, s, _ in others), generator=gen, device=device)
    out, at = {}, 0
    for n, s in convs:
        fan_in = numel(s[1:])
        out[n] = (normal[at: at + numel(s)] * fan_in ** -0.5).reshape(s)
        at += numel(s)
    ranges = {"bias": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.1, 0.1), "mean": (-0.1, 0.1),
              "var": (0.5, 1.5), "slope": (0.1, 0.4)}
    at = 0
    for n, s, k in others:
        lo, hi = ranges[k]
        out[n] = (lo + (hi - lo) * uniform[at: at + numel(s)]).reshape(s)
        at += numel(s)
    for n, s, k in leaves:
        if k == "count":
            out[n] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def module_state(params: dict, prefix: str) -> dict:
    """The state_dict of one module (``backbone`` or ``localheader``)."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}
