"""The extraction forward of ``PoSFeat`` (ResUNet + KeypointDet) on row
bands (posfeat_tpu/parallel/spatial.py; what XLA's SPMD partitioner
makes of ``model.extract`` with an H-sharded image).

Each function walks the port's modules (models/resunet.py ``ResUNet``,
models/keypoint_det.py ``KeypointDet.forward``) and calls the banded
primitives of ``banded_ops`` with the parameters of each band's replica
(``nets[i]`` lives on band i's device). The decoder is the unsharded
one, ``run_decoder`` on the backbone's own plan, given ``BandOps``. The
arithmetic of every op is the unsharded op's; only the rows it reads
come from the neighbours.
The head runs the dataflows the JAX spatial program can take: the
reference dataflow (``False``, and ``True`` at f32), ``"phase"`` and
the dilated composite (``"always"``, ``True`` at bf16/f16).
"""

from __future__ import annotations

from operator import attrgetter
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..models.keypoint_det import _act, _conv
from ..models.resunet import BasicBlock, run_decoder
from ..ops.phase import (
    _bilinear_taps_1d,
    _phase_kernel,
    phase_to_space,
    ring_correction_strips,
    space_to_phase,
)
from ..ops.resize import _upsample_axis_int
from . import banded_ops as bo
from .banded_ops import Bands


def _per(nets, path: str) -> List:
    get = attrgetter(path)
    return [get(n) for n in nets]


def _conv_bn(x: Bands, convs, bns) -> Bands:
    return bo.module_nchw(bo.conv_module(x, convs), bns)


def _conv_bn_elu(x: Bands, blocks) -> Bands:
    """``ConvBNElu`` (resunet.py:160-168)."""
    return _conv_bn(x, [b.conv for b in blocks], [b.bn for b in blocks]).map(F.elu)


class BandOps:
    """``models.resunet.DenseOps``'s primitives on NHWC bands, so that the
    decoder runs the unsharded plan (``decoder_plan``) op for op."""

    @staticmethod
    def map(fn, x: Bands, *others: Bands) -> Bands:
        return x.map(fn, *others)

    @staticmethod
    def conv(x: Bands, convs, weight=lambda w: w, bias=None, tile=None) -> Bands:
        c = convs[0]
        biases = None if bias is None else [bias(m.bias) for m in convs]
        return bo.conv2d(x, [weight(m.weight) for m in convs], biases, c.stride, c.padding, c.dilation, tile)

    @staticmethod
    def add_bias(x: Bands, convs) -> Bands:
        return x.with_parts([p + m.bias.float() for p, m in zip(x.parts, convs)])

    @staticmethod
    def bn(x: Bands, bns) -> Bands:
        return bo.module_nchw(x, bns)

    @staticmethod
    def upsample(x: Bands, scale: int) -> Bands:
        """bilinear ×scale (align_corners=True) in global rows."""
        return bo.resize(x, (x.total * scale, x.parts[0].shape[2] * scale), align_corners=True)

    @staticmethod
    def cat(a: Bands, b: Bands) -> Bands:
        return a.map(lambda p, q: torch.cat([p, q], dim=-1), b)

    @staticmethod
    def pad_to(x1: Bands, x2: Bands) -> Bands:
        """``_skip_pad``, a no-op on a %16 image, where the maps agree."""
        for a, b in zip(x1.parts, x2.parts):
            assert a.shape[:3] == b.shape[:3], "_skipconnect would pad: the image is not a multiple of 16"
        return x1

    @staticmethod
    def channels(x: Bands) -> int:
        return x.parts[0].shape[-1]

    @staticmethod
    def dtype(x: Bands) -> torch.dtype:
        return x.parts[0].dtype


def _block(x: Bands, blocks) -> Bands:
    """One ``BasicBlock`` or ``Bottleneck`` (resunet.py:115-158)."""
    relu = lambda t: t.map(F.relu)
    if isinstance(blocks[0], BasicBlock):
        out = relu(_conv_bn(x, _per(blocks, "conv1"), _per(blocks, "bn1")))
        out = _conv_bn(out, _per(blocks, "conv2"), _per(blocks, "bn2"))
    else:
        out = relu(_conv_bn(x, _per(blocks, "conv1"), _per(blocks, "bn1")))
        out = relu(_conv_bn(out, _per(blocks, "conv2"), _per(blocks, "bn2")))
        out = _conv_bn(out, _per(blocks, "conv3"), _per(blocks, "bn3"))
    if blocks[0].downsample is None:
        identity = x
    else:
        identity = _conv_bn(x, [b.downsample[0] for b in blocks], [b.downsample[1] for b in blocks])
    return out.map(lambda o, i: F.relu(o + i), identity)


def resunet(x: Bands, nets) -> Dict[str, Bands]:
    """``ResUNet.forward`` (resunet.py) on image bands [B, rows, W, 3], and
    ``ResUNetHR.forward`` where the nets are HR: its third decoder level
    (``upconv1`` ×2, the skip with the un-pooled stem, ``iconv1``) puts
    ``local_map`` and ``local_map_small`` (the stem) at H/2. The decoder is
    ``run_decoder`` on the nets' own plan, concat-free skip iconvs and
    ``desc_tail`` included."""
    net = nets[0]
    x = x.map(lambda p: p.to(net.dtype))
    x_first1 = _conv_bn(x, _per(nets, "firstconv"), _per(nets, "firstbn")).map(F.relu)
    x_first = bo.max_pool2d(x_first1, 3, 2, 1)
    feats = []
    y = x_first
    for layer in ("layer1", "layer2", "layer3"):
        for blocks in zip(*_per(nets, layer)):
            y = _block(y, blocks)
        feats.append(y)
    x1, x2, x3 = feats
    x_coarse = _conv_bn_elu(x3, _per(nets, "conv_coarse"))
    maps = {"x1": x1, "x2": x2, "x3": x3, "x_first1": x_first1}
    x_fine = run_decoder(BandOps, nets, maps, net.plan(net.training))
    return {"global_map": x_coarse, "local_map": x_fine, "local_map_small": x_first1 if net.hr else x_first}


# ------------------------------------------------------------------ head


def _edge_cols(t: torch.Tensor) -> torch.Tensor:
    """``_edge_pad1``'s column half: columns are whole in every band."""
    return torch.cat([t[:, :, :1], t, t[:, :, -1:]], dim=2)


def _phase_band(ext, kt, dt, first: bool, last: bool):
    """``fused_upsample_conv3x3_phase`` + ``_fix_border_ring_phase`` on
    one band. ext: the band's trunk with one edge-clamped row above and
    below -> [B, n, w, 4, 4, Cout]: the column strips on every band, the
    row strips on the map's first and last trunk rows only."""
    B, n2, w, _ = ext.shape
    n = n2 - 2
    kph = _phase_kernel(kt, 4).to(dt)
    z = _conv(_edge_cols(ext), kph.permute(3, 2, 0, 1))
    C = kt.shape[-1]
    z = z.reshape(B, n, w, 4, 4, C).clone()
    # the strips of ext: its rows' upsample matches the map's wherever the
    # map's own edge clamp would act, so rows 4 .. 4n + 4 are the band's
    T, Bo, L, R = ring_correction_strips(ext, kt, 4)
    z[:, :, 0, :, 0] -= L[:, 4 : 4 + 4 * n].reshape(B, n, 4, C).to(z.dtype)
    z[:, :, w - 1, :, 3] -= R[:, 4 : 4 + 4 * n].reshape(B, n, 4, C).to(z.dtype)
    if first:
        z[:, 0, :, 0] -= T.reshape(B, w, 4, C).to(z.dtype)
    if last:
        z[:, n - 1, :, 3] -= Bo.reshape(B, w, 4, C).to(z.dtype)
    return z


def _dilated_band(ext, kernel, first: bool, last: bool):
    """``fused_upsample_conv3x3_dilated`` (its stride-4 transposed conv of
    the edge-padded trunk, keypoint_det.py:69-93) and ``_fix_border_ring``
    on one band: output row o reads trunk rows ⌈(o−2)/4⌉−1 .. ⌊(o+7)/4⌋−1,
    so the band's rows need one trunk row above and below."""
    k = 4
    ms, vals = _bilinear_taps_1d(k)
    lo, hi = ms[0], ms[-1]
    n_taps = hi - lo + 3
    u_ext = np.zeros((n_taps + 2,), np.float32)
    for m, v in zip(ms, vals):
        u_ext[m - lo + 2] = v
    A = torch.from_numpy(np.stack([u_ext[d : d + n_taps] for d in range(3)], axis=1)).to(kernel.device)
    comp = torch.einsum("yd,xe,decf->yxcf", A, A, kernel.float()).to(ext.dtype)
    pad = n_taps - 1 - (hi + 1 - k)
    out = F.conv_transpose2d(
        _edge_cols(ext).permute(0, 3, 1, 2), comp.permute(2, 3, 0, 1), stride=k, padding=pad
    ).permute(0, 2, 3, 1)
    n = ext.shape[1] - 2
    assert out.shape[1] == k * n, out.shape
    # the ring (keypoint_det.py:96-125): column strips from the band's
    # upsampled edge columns plus one row above and below; the row strips
    # on the map's first and last rows
    K = kernel.float()
    t32 = ext.float()
    L = k * n

    def conv1d_valid(strip, k1d):
        return sum(strip[:, t : t + L] @ k1d[t] for t in range(3))

    def conv1d_same(strip, k1d):
        sp = F.pad(strip, (0, 0, 1, 1))
        return sum(sp[:, t : t + strip.shape[1]] @ k1d[t] for t in range(3))

    dt = out.dtype
    left_src = _upsample_axis_int(t32[:, :, 0:1], k, 1)[:, k - 1 : k * n + k + 1, 0]
    right_src = _upsample_axis_int(t32[:, :, -1:], k, 1)[:, k - 1 : k * n + k + 1, 0]
    z_left = conv1d_valid(left_src, K[:, 1] + K[:, 2]).to(dt)
    z_right = conv1d_valid(right_src, K[:, 0] + K[:, 1]).to(dt)
    out = torch.cat([z_left[:, :, None], out[:, :, 1:-1], z_right[:, :, None]], dim=2)
    if first:
        z_top = conv1d_same(_upsample_axis_int(t32[:, 1:2], k, 2)[:, 0], K[1] + K[2]).to(dt)
        out = torch.cat([z_top[:, None], out[:, 1:]], dim=1)
    if last:
        z_bot = conv1d_same(_upsample_axis_int(t32[:, n : n + 1], k, 2)[:, 0], K[0] + K[1]).to(dt)
        out = torch.cat([out[:, :-1], z_bot[:, None]], dim=1)
    return out


def keypoint_det(fine_map: Bands, img: Bands, heads) -> Bands:
    """``KeypointDet.forward`` (keypoint_det.py:228-308) on bands of the
    trunk's input [B, h, w, C_in] and of the image [B, H, W, 3]."""
    h0 = heads[0]
    dt, fu = h0.dtype, h0.fused_upsample
    if fu == "pallas":
        raise ValueError("the fused head ('pallas') runs on one device; the banded program takes "
                         "fused_upsample 'phase' in its place")
    prior = bo.PRIORS[h0.prior]
    slopes = [h.relu.weight for h in heads]

    def prelu(x: Bands) -> Bands:
        return x.with_parts([torch.where(p >= 0, p, a.to(p.dtype) * p) for p, a in zip(x.parts, slopes)])

    fine_map = fine_map.map(lambda p: p.to(dt))
    img = img.map(lambda p: p.to(dt))
    x_pf = prior(fine_map)
    x_pi = prior(img)
    trunk = bo.conv2d(x_pf.map(torch.mul, fine_map), [h.conv1.weight.to(dt) for h in heads],
                      [h.conv1.bias.to(dt) for h in heads], 1, 1)
    trunk = prelu(bo.instance_norm(trunk))
    s_img = x_pi.map(lambda a, b: (a * b).to(dt), img)
    y_img = bo.conv2d(s_img, [h.convimg.weight.to(dt) for h in heads], None, 1, 1)
    y_img = y_img.with_parts([p + h.convimg.bias.to(dt) for p, h in zip(y_img.parts, heads)])

    H, W = img.total, img.parts[0].shape[2]
    h, w = trunk.total, trunk.parts[0].shape[2]
    cin = h0.in_channels
    size_ok = H == 4 * h and W == 4 * w
    h0.warn_off_ratio(h, w, H, W)  # ResUNetHR's trunk at H/2: the reference dataflow
    hwio = lambda t: t.permute(2, 3, 1, 0)
    img_feat = bo.instance_norm(y_img.map(lambda p: p.float())).map(lambda p: p.to(dt))
    b2 = [hd.conv2.bias.to(dt) for hd in heads]

    def conv2_img_part():
        return bo.conv2d(img_feat, [hd.conv2.weight[:, cin:].to(dt) for hd in heads], None, 1, 1).map(
            lambda p: p.to(dt))

    fuse_ok = fu in ("always", "phase") or (fu is True and dt in (torch.bfloat16, torch.float16))
    phase = fu == "phase" and size_ok
    n_bands = len(trunk)
    edge = lambda i: (i == 0, i == n_bands - 1)
    if phase:
        ext = trunk.halo(1, 1, "replicate")
        z = trunk.with_parts([_phase_band(e, hwio(hd.conv2.weight[:, :cin]), dt, *edge(i))
                              for i, (e, hd) in enumerate(zip(ext, heads))])
        z = z.map(lambda p, q: p + space_to_phase(q, 4), conv2_img_part())
        z = z.with_parts([p + b for p, b in zip(z.parts, b2)])
        x = prelu(bo.instance_norm(z, dims=(1, 2, 3, 4)))
        x = x.map(lambda p: p.reshape(p.shape[0], p.shape[1], w * 16, p.shape[-1]))
    elif fuse_ok and size_ok:
        ext = trunk.halo(1, 1, "replicate")
        z = trunk.with_parts([_dilated_band(e, hwio(hd.conv2.weight[:, :cin]), *edge(i)).to(dt)
                              for i, (e, hd) in enumerate(zip(ext, heads))], 4 * h)
        z = z.map(torch.add, conv2_img_part())
        z = z.with_parts([p + b for p, b in zip(z.parts, b2)])
        x = prelu(bo.instance_norm(z))
    else:
        xu = bo.resize(trunk, (H, W), align_corners=False)
        xcat = xu.map(lambda a, b: torch.cat([a, b], dim=-1), img_feat)
        x = bo.conv2d(xcat, [hd.conv2.weight.to(dt) for hd in heads], None, 1, 1)
        x = prelu(bo.instance_norm(x.with_parts([p + b for p, b in zip(x.parts, b2)])))
    if dt in (torch.bfloat16, torch.float16):
        z3 = x.with_parts([_conv(p.float(), hd.conv3.weight, hd.conv3.bias) for p, hd in zip(x.parts, heads)])
    else:
        z3 = x.with_parts([_conv(p, hd.conv3.weight.to(dt), hd.conv3.bias.to(dt))
                           for p, hd in zip(x.parts, heads)])
    score = bo.instance_norm(z3).map(lambda p: _act(p, h0.act))
    if phase:
        score = score.with_parts([phase_to_space(p.reshape(p.shape[0], p.shape[1], w, 4, 4, h0.out_channels))
                                  for p in score.parts], 4 * h)
    up = bo.resize(x_pf, (H, W), align_corners=False)
    return up.map(lambda u, pi, s: u.mean(dim=-1, keepdim=True) * pi.mean(dim=-1, keepdim=True) * s,
                  x_pi, score)


def posfeat_extract(im: Bands, models) -> Dict:
    """``PoSFeat.extract`` (models/posfeat.py:100-135) on image bands
    [B, rows, W, 3]: the maps come back as Bands, ``global_feat`` on the
    first band's device."""
    m0 = models[0]
    fm = resunet(im, [m.backbone for m in models])
    elems = m0.local_input_elements
    local_input = fm[elems[0]].map(lambda *ps: torch.cat(ps, dim=-1), *(fm[e] for e in elems[1:]))
    l_map = keypoint_det(local_input, im, [m.localheader for m in models])
    if l_map.parts[0].shape[-1] == 1:
        local_thr = l_map.map(torch.zeros_like)
    else:
        local_thr = l_map.map(lambda p: p[..., 1:])
        l_map = l_map.map(lambda p: p[..., :1])
    g = fm["global_map"]
    g_map = g.map(lambda p: torch.ones(p.shape[:3] + (1,), dtype=fm["local_map"].parts[0].dtype, device=p.device))
    g_desc = g_map.map(lambda a, b: a * b, g)
    g_desc = g_desc.map(lambda p: p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp_min(1e-12))
    count = g.total * g.parts[0].shape[2]
    global_feat = bo.global_sum([p.sum(dim=(1, 2)) for p in g_desc.parts]) / count
    return {
        "local_map": fm["local_map"],
        "global_map": g,
        "global_feat": global_feat,
        "local_point": l_map,
        "local_thr": local_thr,
        "global_point": g_map,
    }
