"""ResUNet descriptor backbones: ResNet encoder + U-Net decoder
(posfeat_tpu/models/resunet.py:423-689; reference
networks/DescNet.py:11-165). ``ResUNet`` forms its descriptors at H/4,
``ResUNetHR`` at H/2, one decoder level further, with the un-pooled stem
as that level's skip.

Module and parameter names are the reference's torch names
(``firstconv``, ``layer2.0.downsample.1``, ``upconv3.conv.bn``, ...), so
reference ``backbone.pth`` files load as they are. The public forward
takes and returns NHWC; convolutions run NCHW views of it, which are
``channels_last`` in memory.

BatchNorm trains as flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
(resunet.py:37-45): normalized by the batch's biased variance, and the
running variance updated with that same biased variance (``BatchNorm2d``
below), not with torch's unbiased one. Under ``multihost:`` the stage-1
trainer sets each BatchNorm's ``sync``: its moments are then those of the
global batch, as flax's are under JAX's SPMD step.

Parameters and running statistics stay f32 at every compute dtype, as
the JAX modules' ``param_dtype=float32`` (resunet.py:43,59): a bf16
backbone casts each conv's weight to bf16 where it runs (``Conv2d``),
and its BatchNorm normalizes in f32 with f32 statistics and returns
bf16, as flax's does. An optimizer therefore updates f32 parameters in
either dtype.

The decoder runs the JAX package's dataflow plan (``decoder_plan``,
resunet.py:438-565 and 582-689), shared with the banded program
(parallel/banded_models.py). At f32 every block is the reference's
conv + BN + ELU on the concat of its skip. At bf16:

- extraction (BatchNorm in eval mode) computes ResUNet's skip iconvs
  concat-free (``split_cat_conv``, JAX ``ConvBNEluSplitCat``): two
  partial convs of bf16 operands with f32 accumulators, summed with the
  bias and rounded to bf16 once. Training keeps the concat dataflow, as
  JAX does (resunet.py:494-507); ResUNetHR has no concat-free iconv.
- ``desc_tail`` (``TAIL_VARIANTS``, JAX's POSFEAT_DESC_TAIL_F32) runs the
  last decoder handoff with f32 operands: ``up2`` and ``iconv2`` as f32
  convs, ``split2``/``split3`` as 2- or 3-pass bf16 splits of f32 operands
  after an f32 lerp (``conv_split``), ``split3w`` one level wider; the
  final projection then runs in f32 and ``local_map`` comes out f32.
- ``decoder_accum: "f32"`` (POSFEAT_DECODER_ACCUM=f32) runs the decoder
  convs on bf16 operands with f32 accumulators (``conv_accum_f32``) and
  their BatchNorm and ELU in f32; ``desc_f32`` (POSFEAT_DESC_F32=1) runs
  ``conv_fine`` in f32.

A bf16 × bf16 product is exact in f32, and a bf16 value is exact in
TF32, so the f32-accumulated convs run as f32 convs of bf16-rounded
operands with TF32 allowed for that call only (``_bf16_operands``): on
the card cuDNN then takes the tensor cores, and no partial result is
rounded to bf16 before its sum.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.distributed import all_reduce_autograd
from ..ops import conv_tiles

# torchvision families (only layers 1-3 are used): block, counts, width mult
_ENCODERS = {
    "resnet18": ("basic", (2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6), 1),
    "resnet50": ("bottleneck", (3, 4, 6), 1),
    "resnet101": ("bottleneck", (3, 4, 23), 1),
    "resnet152": ("bottleneck", (3, 8, 36), 1),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6), 2),
}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs at its input's dtype: the f32 weight and
    bias are cast to it for the call; in row tiles of ``row_tile`` output
    rows where that is set (``row_tiled_conv``)."""

    row_tile = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.row_tile is None:
            return self._conv_forward(x, self.weight.to(x.dtype), bias)
        return conv_tiles.row_tiled_conv(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                         self.dilation, self.row_tile)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running
    statistics as flax does: running = 0.9 · running + 0.1 · batch, with
    the batch's biased variance (torch's own update uses the unbiased
    one, n/(n−1) larger: a few percent at the deepest layers of small
    images). Evaluation and the state_dict are torch's. A bf16 input is
    normalized with the f32 parameters and statistics and comes out
    bf16.

    ``sync = True`` (set by the trainer when several ranks train the
    backbone) normalizes a training batch by the moments of the global
    batch: each rank's per-channel Σx and Σx² and its count are summed
    over the ranks through a differentiable all-reduce, and the variance
    is E[x²] − E[x]², as flax's fast variance computes it; the running
    statistics take the global biased variance. One code path for the
    CPU (gloo) and the card (gloo or NCCL), which ``nn.SyncBatchNorm``,
    CUDA only, is not."""

    sync = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync:
            y, mean, var = self._global_batch_norm(x)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor):
        """(normalized x, mean, biased variance) over every rank's batch."""
        xf = x.float()
        c = xf.shape[1]
        count = torch.full((1,), float(xf.numel() // c), device=x.device)
        moments = all_reduce_autograd(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = moments[2 * c].detach()
        mean = moments[:c] / n
        var = (moments[c:2 * c] / n - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


def _downsample(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(cin, planes, stride) if downsample else None
        self.out_ch = planes

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False, width_mult=1):
        super().__init__()
        width = planes * width_mult
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = _downsample(cin, planes * 4, stride) if downsample else None
        self.out_ch = planes * 4

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvBNElu(nn.Module):
    """The reference's ``conv`` block: Conv2d + BN + ELU (DescNet.py:167-179).
    Its parameters serve every variant of the decoder plan (``Conv``)."""

    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    """bilinear ×scale (align_corners=True) + ConvBNElu (DescNet.py:182-190):
    its parameters; ``up_conv`` runs it under the decoder plan's ``Up``."""

    def __init__(self, cin, cout, kernel, scale=2):
        super().__init__()
        self.scale = scale
        self.conv = ConvBNElu(cin, cout, kernel, 1)


def _skip_pad(x1, x2):
    """x1 zero-padded to x2's spatial size (DescNet.py:50-62); NCHW."""
    dy = x2.shape[2] - x1.shape[2]
    dx = x2.shape[3] - x1.shape[3]
    if dy or dx:
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return x1


# ------------------------------------------------------ the decoder plan

TAIL_VARIANTS = ("iconv2", "up2", "split2", "split3", "split3w")
DECODER_ACCUM = ("", "f32")


@dataclass(frozen=True)
class Conv:
    """How one ConvBNElu block runs (resunet.py:304-337): ``kind`` "plain"
    (conv and BN at ``dtype``, its input cast to it), "accum"
    (``conv_accum_f32``, BN and ELU in f32) or "split" (``conv_split`` of
    ``passes`` passes, BN and ELU in f32)."""

    kind: str
    dtype: torch.dtype
    passes: int = 2


@dataclass(frozen=True)
class Up:
    """An UpConv block (resunet.py:340-371): the input cast to ``cast_in``
    (kept where None), the lerp in f32 where ``interp_f32`` (else at the
    input's dtype) and rounded back to the input's dtype unless
    ``keep_f32``, then ``conv``."""

    name: str
    conv: Conv
    cast_in: Optional[torch.dtype] = None
    interp_f32: bool = False
    keep_f32: bool = False


@dataclass(frozen=True)
class Skip:
    """An iconv block on the skip ``skip`` (a name of the encoder's maps)
    and the upsampled map: ``split_cat_conv`` at ``conv.dtype`` where
    ``splitcat``, else ``conv`` on the concat of both cast to its input
    dtype."""

    name: str
    skip: str
    conv: Conv
    splitcat: bool = False


@dataclass(frozen=True)
class Fine:
    """``conv_fine``: ``conv`` on the last map."""

    name: str
    conv: Conv


def _tail_plan(tail: str, bf16: bool):
    """(split, passes, up_f32, ic_f32, interp) of the last decoder handoff
    for a ``desc_tail`` variant (resunet.py:398-420). Raises ValueError on
    an unknown name: a misspelt variant must not run the plain tail."""
    if tail and tail not in TAIL_VARIANTS:
        raise ValueError(f"unknown desc_tail variant {tail!r}; expected one of {TAIL_VARIANTS}")
    split = bf16 and tail in ("split2", "split3", "split3w")
    passes = 2 if tail == "split2" else 3
    return split, passes, bf16 and tail == "up2", bf16 and tail in ("iconv2", "up2"), split


def decoder_plan(dtype, training: bool, desc_tail: str = "", decoder_accum: str = "",
                 desc_f32: bool = False, hr: bool = False):
    """The decoder's blocks in order, as the JAX ResUNet (resunet.py:
    470-565) or, with ``hr``, ResUNetHR (:612-680) runs them at ``dtype``
    with BatchNorm in training mode or not. Unknown ``desc_tail`` or
    ``decoder_accum`` values raise ValueError."""
    if decoder_accum not in DECODER_ACCUM:
        raise ValueError(f"unknown decoder_accum {decoder_accum!r}; expected one of {DECODER_ACCUM}")
    bf16 = dtype == torch.bfloat16
    f32 = torch.float32
    acc = bf16 and decoder_accum == "f32"
    split, passes, up_f32, ic_f32, interp = _tail_plan(desc_tail, bf16)

    def conv(split_, accum, dt, n=passes):
        if split_:
            return Conv("split", f32, n)
        return Conv("accum", f32) if accum else Conv("plain", dt)

    if hr:
        # no concat-free iconv; the tail acts on upconv1 / iconv1 at H/2,
        # and split3w is split3 there (no level below to widen into)
        up1_dt = f32 if up_f32 else dtype
        ic1_dt = f32 if ic_f32 else dtype
        steps = [
            Up("upconv3", conv(False, acc, dtype)),
            Skip("iconv3", "x2", conv(False, acc, dtype)),
            Up("upconv2", conv(False, acc, dtype)),
            Skip("iconv2", "x1", conv(False, acc, dtype)),
            Up("upconv1", conv(split, acc and up1_dt != f32 and not split, up1_dt), up1_dt, interp, split),
            Skip("iconv1", "x_first1", conv(split, acc and ic1_dt != f32 and not split, ic1_dt)),
        ]
    else:
        wide = bf16 and desc_tail == "split3w"
        splitcat = bf16 and not training
        up2_dt = f32 if up_f32 else dtype
        ic2_dt = f32 if ic_f32 else dtype
        steps = [
            Up("upconv3", conv(wide, acc and not wide, dtype, 3), None, wide, wide),
            Skip("iconv3", "x2", conv(wide, acc and not wide, dtype, 3), splitcat and not wide and not acc),
            Up("upconv2", conv(split, acc and up2_dt != f32 and not split, up2_dt),
               None if wide else up2_dt, interp, split),
            Skip("iconv2", "x1", conv(split, acc and ic2_dt != f32 and not split, ic2_dt),
                 splitcat and not split and ic2_dt == dtype and not acc),
        ]
    fine_dt = f32 if desc_f32 or (bf16 and desc_tail) else dtype
    steps.append(Fine("conv_fine", conv(False, acc and fine_dt != f32, fine_dt)))
    return steps


# ------------------------------------------- the decoder's arithmetic


@contextlib.contextmanager
def _bf16_operands():
    """Convs whose operands all hold bf16 values: TF32 loses none of their
    bits and their products are exact in f32, so on the card cuDNN may
    take the tensor cores for this call; the port otherwise keeps f32
    convs out of TF32 (core/device.py)."""
    flags = torch.backends.cudnn
    saved = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class DenseOps:
    """The decoder's primitives on whole NCHW maps (the unsharded forward);
    parallel/banded_models.py gives the same ones on row bands."""

    @staticmethod
    def map(fn, x, *others):
        return fn(x, *others)

    @staticmethod
    def conv(x, convs, weight=lambda w: w, bias=None, tile=None):
        m = convs[0]
        b = None if bias is None else bias(m.bias)
        return conv_tiles.row_tiled_conv(x, weight(m.weight), b, m.stride, m.padding, m.dilation, tile)

    @staticmethod
    def add_bias(x, convs):
        return x + convs[0].bias.float()[:, None, None]

    @staticmethod
    def bn(x, bns):
        return bns[0](x)

    @staticmethod
    def upsample(x, scale):
        return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)

    @staticmethod
    def cat(a, b):
        return torch.cat([a, b], dim=1)

    @staticmethod
    def pad_to(x1, x2):
        return _skip_pad(x1, x2)

    @staticmethod
    def channels(x):
        return x.shape[1]

    @staticmethod
    def dtype(x):
        return x.dtype


def _conv_f32_accum(ops, x, convs, dtype, weight=lambda w: w):
    """The conv of x and the weight, both rounded to ``dtype``, with an f32
    accumulator and result."""
    x = ops.map(lambda t: t.to(dtype).float(), x)
    exact = _bf16_operands() if dtype == torch.bfloat16 else contextlib.nullcontext()
    with exact:
        return ops.conv(x, convs, lambda w: weight(w).to(dtype).float())


def conv_accum_f32(ops, x, convs, weight=lambda w: w):
    """JAX ``_ConvAccumF32`` (resunet.py:153-190) without its bias: the conv
    of x and the weight, both rounded to bf16, with an f32 accumulator."""
    return _conv_f32_accum(ops, x, convs, torch.bfloat16, weight)


def conv_split(ops, x, convs, passes: int):
    """JAX ``_ConvSplit2`` (resunet.py:192-243) without its bias: x in f32
    split as hi = bf16(x), lo = bf16(x − hi) and the weight as whi =
    bf16(w), wlo = bf16(w − whi); conv(hi, whi) + conv(lo, whi), plus
    conv(hi, wlo) at 3 passes, each with an f32 accumulator."""
    hi = ops.map(lambda t: _bf16_values(t.float()), x)
    lo = ops.map(lambda t, h: _bf16_values(t.float() - h), x, hi)
    whi = lambda w: _bf16_values(w)
    with _bf16_operands():
        y = ops.map(torch.add, ops.conv(hi, convs, whi), ops.conv(lo, convs, whi))
        if passes >= 3:
            y = ops.map(torch.add, y, ops.conv(hi, convs, lambda w: _bf16_values(w - whi(w))))
    return y


def split_cat_conv(ops, a, b, convs, dtype):
    """JAX ``_SplitCatConv`` (resunet.py:246-285): conv(concat(a, b)) as
    the sum of the partial convs of a and b against their slices of the
    weight, f32-accumulated on operands at ``dtype``, plus the bias,
    rounded to ``dtype`` once."""
    ca = ops.channels(a)
    pa = _conv_f32_accum(ops, a, convs, dtype, lambda w: w[:, :ca])
    pb = _conv_f32_accum(ops, b, convs, dtype, lambda w: w[:, ca:])
    return ops.map(lambda t: t.to(dtype), ops.add_bias(ops.map(torch.add, pa, pb), convs))


def conv_bn_elu(ops, x, blocks, c: Conv):
    """A ConvBNElu block under ``c`` (resunet.py:304-337)."""
    convs = [b.conv for b in blocks]
    if c.kind == "plain":
        x = ops.map(lambda t: t.to(c.dtype), x)
        y = ops.conv(x, convs, lambda w: w.to(c.dtype), lambda b: b.to(c.dtype))
    elif c.kind == "accum":
        y = ops.add_bias(conv_accum_f32(ops, x, convs), convs)
    else:
        y = ops.add_bias(conv_split(ops, x, convs, c.passes), convs)
    return ops.map(F.elu, ops.bn(y, [b.bn for b in blocks]))


def _input_dtype(c: Conv) -> torch.dtype:
    return torch.bfloat16 if c.kind == "accum" else c.dtype


def up_conv(ops, x, blocks, step: Up):
    """An UpConv block under ``step`` (resunet.py:340-371)."""
    if step.cast_in is not None:
        x = ops.map(lambda t: t.to(step.cast_in), x)
    dt = ops.dtype(x)
    y = ops.upsample(ops.map(torch.Tensor.float, x) if step.interp_f32 else x, blocks[0].scale)
    if not step.keep_f32:
        y = ops.map(lambda t: t.to(dt), y)
    return conv_bn_elu(ops, y, [b.conv for b in blocks], step.conv)


def skip_conv(ops, y, skip, blocks, step: Skip):
    """An iconv block under ``step`` on the upsampled map y and the skip
    (resunet.py:508-545): concat-free, or on the concat, skip first."""
    if step.splitcat:
        dt = step.conv.dtype
        a = ops.map(lambda t: t.to(dt), skip)
        b = ops.pad_to(ops.map(lambda t: t.to(dt), y), skip)
        y = split_cat_conv(ops, a, b, [blk.conv for blk in blocks], dt)
        return ops.map(F.elu, ops.bn(y, [blk.bn for blk in blocks]))
    cast = lambda t: t.to(_input_dtype(step.conv))
    x = ops.cat(ops.map(cast, skip), ops.pad_to(ops.map(cast, y), skip))
    return conv_bn_elu(ops, x, blocks, step.conv)


@dataclass(frozen=True)
class RowTiles:
    """``ops`` whose convs run in row tiles of ``rows`` output rows."""

    ops: object
    rows: int

    def __getattr__(self, name):
        return getattr(self.ops, name)

    def conv(self, x, convs, weight=lambda w: w, bias=None):
        return self.ops.conv(x, convs, weight, bias, tile=self.rows)


def run_decoder(ops, nets, maps, plan, after_step=None):
    """The decoder of ``plan`` from the encoder's ``maps`` ('x1', 'x2',
    'x3', 'x_first1') through ``ops`` (``DenseOps`` or the banded program's),
    each block with its replicas in ``nets``, every conv in row tiles of
    ``ops/conv_tiles.py``'s ``ROW_TILE`` image rows; returns the local map.
    ``after_step(step, y)``, where given, sees each block's output."""
    y = maps["x3"]
    stride = 16  # x3's, in image rows per map row
    for step in plan:
        blocks = [getattr(n, step.name) for n in nets]
        if isinstance(step, Up):
            stride //= blocks[0].scale
        tiled = RowTiles(ops, conv_tiles.ROW_TILE // stride)
        if isinstance(step, Up):
            y = up_conv(tiled, y, blocks, step)
        elif isinstance(step, Skip):
            y = skip_conv(tiled, y, maps[step.skip], blocks, step)
        else:
            y = conv_bn_elu(tiled, y, blocks, step.conv)
        if after_step is not None:
            after_step(step, y)
    return y


class ResUNet(nn.Module):
    """Dense-descriptor U-Net (reference networks/DescNet.py:11-84).

    forward(x [B, H, W, 3]) -> {'global_map' [B, H/16, W/16, coarse_out_ch],
    'local_map' [B, H/4, W/4, fine_out_ch], 'local_map_small'
    [B, H/4, W/4, 64]}, NHWC, in the compute dtype ``dtype`` ('local_map'
    in f32 where the plan's ``conv_fine`` runs in f32).

    ``desc_tail`` (one of ``TAIL_VARIANTS`` or ""), ``decoder_accum``
    ("" or "f32") and ``desc_f32`` select the bf16 decoder's numerics
    (module docstring); none of them changes a parameter, and at f32 none
    changes the result."""

    hr = False

    def __init__(self, encoder="resnet50", pretrained=True, coarse_out_ch=128,
                 fine_out_ch=128, desc_tail="", decoder_accum="", desc_f32=False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if encoder not in _ENCODERS:
            raise ValueError(f"Incorrect encoder type {encoder}")
        self.desc_tail = desc_tail or ""
        self.decoder_accum = decoder_accum or ""
        self.desc_f32 = bool(desc_f32)
        self.plan(False)  # unknown variants raise here, before any work
        kind, counts, width_mult = _ENCODERS[encoder]
        self.firstconv = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.firstbn = BatchNorm2d(64)
        cin = 64
        for li, (n_blocks, planes, stride) in enumerate(zip(counts, (64, 128, 256), (1, 2, 2))):
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                if kind == "bottleneck":
                    blk = Bottleneck(cin, planes, s, bi == 0, width_mult)
                else:
                    blk = BasicBlock(cin, planes, s, bi == 0 and (s != 1 or li > 0))
                blocks.append(blk)
                cin = blk.out_ch
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            # the encoder's 3x3 stride-1 convs in row tiles (ops/conv_tiles.py): on the
            # card cuDNN picks another bf16 algorithm for a 12 Mpx frame's H/8
            # map than for a band's (tools/spatial_rounding_torch.py)
            for m in blocks:
                for c in m.modules():
                    if isinstance(c, Conv2d) and c.kernel_size == (3, 3) and c.stride == (1, 1):
                        c.row_tile = conv_tiles.ROW_TILE // (4 * 2**li)
        c1 = self.layer1[-1].out_ch
        c2 = self.layer2[-1].out_ch
        c3 = self.layer3[-1].out_ch
        self.conv_coarse = ConvBNElu(c3, coarse_out_ch, 1)
        self.upconv3 = UpConv(c3, 512, 3, 2)
        self.iconv3 = ConvBNElu(c2 + 512, 512, 3)
        self.upconv2 = UpConv(512, 256, 3, 2)
        self.iconv2 = ConvBNElu(c1 + 256, 256, 3)
        self.conv_fine = ConvBNElu(256, fine_out_ch, 1)
        self.fine_out_ch = fine_out_ch
        self.coarse_out_ch = coarse_out_ch

    @property
    def out_channels(self):
        return [self.fine_out_ch, self.coarse_out_ch]

    def plan(self, training: bool):
        """``decoder_plan`` of this backbone with BatchNorm in training mode or not."""
        return decoder_plan(self.dtype, training, self.desc_tail, self.decoder_accum, self.desc_f32, self.hr)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x_first1 = F.relu(self.firstbn(self.firstconv(x)))
        x_first = F.max_pool2d(x_first1, 3, 2, 1)
        x1 = self.layer1(x_first)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x_coarse = self.conv_coarse(x3)
        maps = {"x1": x1, "x2": x2, "x3": x3, "x_first1": x_first1}
        x_fine = run_decoder(DenseOps, [self], maps, self.plan(self.training))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {
            "global_map": nhwc(x_coarse),
            "local_map": nhwc(x_fine),
            "local_map_small": nhwc(x_first1 if self.hr else x_first),
        }


class ResUNetHR(ResUNet):
    """High-resolution variant (posfeat_tpu/models/resunet.py:571-689;
    DescNet.py:86-165): the ResUNet decoder plus one more level, a ×2
    ``upconv1`` (192 channels) and ``iconv1`` (256) on the concat with the
    stem's un-pooled output, so that 'local_map' [B, H/2, W/2,
    fine_out_ch] and 'local_map_small' (the stem, [B, H/2, W/2, 64]) come
    out at H/2. The reference's torch names, as ``ResUNet``'s; the same
    ``desc_tail`` contract, on upconv1 / iconv1."""

    hr = True

    def __init__(self, encoder="resnet50", pretrained=True, coarse_out_ch=128,
                 fine_out_ch=128, desc_tail="", decoder_accum="", desc_f32=False, dtype=torch.float32):
        super().__init__(encoder, pretrained, coarse_out_ch, fine_out_ch, desc_tail, decoder_accum,
                         desc_f32, dtype)
        self.upconv1 = UpConv(256, 192, 3, 2)
        self.iconv1 = ConvBNElu(64 + 192, 256, 3)
