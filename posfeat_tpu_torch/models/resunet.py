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

Both dtypes run the reference concat dataflow, the one JAX trains with
at bf16 (resunet.py:501-507). The JAX package's bf16 extraction ladder
(``accum_f32``, ``split*``, ``splitcat``, ``_tail_plan``,
resunet.py:398-558) is left out, so at bf16 this backbone rounds where
the concat dataflow rounds.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.distributed import all_reduce_autograd

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
    bias are cast to it for the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
    """The reference's ``conv`` block: Conv2d + BN + ELU (DescNet.py:167-179)."""

    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    """bilinear ×scale (align_corners=True) + ConvBNElu (DescNet.py:182-190)."""

    def __init__(self, cin, cout, kernel, scale=2):
        super().__init__()
        self.scale = scale
        self.conv = ConvBNElu(cin, cout, kernel, 1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=self.scale, mode="bilinear", align_corners=True)
        return self.conv(x)


def _skipconnect(x1, x2):
    """Zero-pad x1 to x2's size and concat channels, skip first
    (DescNet.py:50-62). NCHW."""
    dy = x2.shape[2] - x1.shape[2]
    dx = x2.shape[3] - x1.shape[3]
    if dy or dx:
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([x2, x1], dim=1)


class ResUNet(nn.Module):
    """Dense-descriptor U-Net (reference networks/DescNet.py:11-84).

    forward(x [B, H, W, 3]) -> {'global_map' [B, H/16, W/16, coarse_out_ch],
    'local_map' [B, H/4, W/4, fine_out_ch], 'local_map_small'
    [B, H/4, W/4, 64]}, NHWC, in the compute dtype ``dtype``."""

    def __init__(self, encoder="resnet50", pretrained=True, coarse_out_ch=128,
                 fine_out_ch=128, desc_tail="", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if encoder not in _ENCODERS:
            raise ValueError(f"Incorrect encoder type {encoder}")
        if desc_tail:
            raise NotImplementedError(
                f"desc_tail={desc_tail!r}: the bf16 descriptor-tail ladder is not "
                "ported; see ROADMAP.md §1 (not queued: the TPU bf16 ladder)"
            )
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

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = F.relu(self.firstbn(self.firstconv(x)))
        x_first = F.max_pool2d(x, 3, 2, 1)
        x1 = self.layer1(x_first)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x_coarse = self.conv_coarse(x3)
        y = self.iconv3(_skipconnect(self.upconv3(x3), x2))
        y = self.iconv2(_skipconnect(self.upconv2(y), x1))
        x_fine = self.conv_fine(y)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {
            "global_map": nhwc(x_coarse),
            "local_map": nhwc(x_fine),
            "local_map_small": nhwc(x_first),
        }



class ResUNetHR(ResUNet):
    """High-resolution variant (posfeat_tpu/models/resunet.py:571-689;
    DescNet.py:86-165): the ResUNet decoder plus one more level, a ×2
    ``upconv1`` (192 channels) and ``iconv1`` (256) on the concat with the
    stem's un-pooled output, so that 'local_map' [B, H/2, W/2,
    fine_out_ch] and 'local_map_small' (the stem, [B, H/2, W/2, 64]) come
    out at H/2. The reference's torch names, as ``ResUNet``'s."""

    def __init__(self, encoder="resnet50", pretrained=True, coarse_out_ch=128,
                 fine_out_ch=128, desc_tail="", dtype=torch.float32):
        super().__init__(encoder, pretrained, coarse_out_ch, fine_out_ch, desc_tail, dtype)
        self.upconv1 = UpConv(256, 192, 3, 2)
        self.iconv1 = ConvBNElu(64 + 192, 256, 3)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x_first1 = F.relu(self.firstbn(self.firstconv(x)))
        x1 = self.layer1(F.max_pool2d(x_first1, 3, 2, 1))
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x_coarse = self.conv_coarse(x3)
        y = self.iconv3(_skipconnect(self.upconv3(x3), x2))
        y = self.iconv2(_skipconnect(self.upconv2(y), x1))
        y = self.iconv1(_skipconnect(self.upconv1(y), x_first1))
        x_fine = self.conv_fine(y)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {
            "global_map": nhwc(x_coarse),
            "local_map": nhwc(x_fine),
            "local_map_small": nhwc(x_first1),
        }
