"""The flagship model's extraction in plain float32 PyTorch, NCHW:
ResUNet (a torchvision-style ResNet encoder, layers 1-3, and the U-Net
decoder, BatchNorm in eval mode), the KeypointDet head on its published
dataflow (prior 'identity', upsample ×4, concat with the image branch,
conv2 at full resolution, non-affine instance norms, one PReLU slope,
Softplus), the NMS + threshold + top-k detector with the 3×3
score-weighted refinement, and bilinear descriptor sampling
(align_corners=False, zeros outside) with L2 normalisation.

``params`` maps the reference's torch names to tensors: ``backbone.*``
and ``localheader.*``. ``q``, where given, rounds every convolution's
operands (``quant.rounder``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
IN_EPS = 1e-5
ENCODER_BLOCKS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23), "resnet152": (3, 8, 36)}


def normalize_image(im_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float NHWC, ImageNet mean and std."""
    mean = torch.tensor(IMAGENET_MEAN, device=im_u8.device)
    std = torch.tensor(IMAGENET_STD, device=im_u8.device)
    return (im_u8.float() / 255.0 - mean) / std


def _conv(x, w, b=None, stride=1, padding=0, q=None):
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, b, stride, padding)


def _bn(x, p, name):
    g, b = p[name + ".weight"], p[name + ".bias"]
    mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    scale = g / torch.sqrt(var + BN_EPS)
    return x * scale[:, None, None] + (b - mean * scale)[:, None, None]


def _conv_bn_elu(x, p, name, padding, q):
    y = _conv(x, p[name + ".conv.weight"], p[name + ".conv.bias"], 1, padding, q)
    return F.elu(_bn(y, p, name + ".bn"))


def _bottleneck(x, p, name, stride, q):
    out = F.relu(_bn(_conv(x, p[name + ".conv1.weight"], q=q), p, name + ".bn1"))
    out = F.relu(_bn(_conv(out, p[name + ".conv2.weight"], None, stride, 1, q), p, name + ".bn2"))
    out = _bn(_conv(out, p[name + ".conv3.weight"], q=q), p, name + ".bn3")
    if name + ".downsample.0.weight" in p:
        x = _bn(_conv(x, p[name + ".downsample.0.weight"], None, stride, 0, q), p, name + ".downsample.1")
    return F.relu(out + x)


def _pad_to(x, ref):
    dy, dx = ref.shape[2] - x.shape[2], ref.shape[3] - x.shape[3]
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2)) if dy or dx else x


def backbone(p: dict, im: torch.Tensor, encoder: str = "resnet50", q=None):
    """im NCHW normalized -> (local_map [B, 128, H/4, W/4], local_map_small
    [B, 64, H/4, W/4]); ``p`` holds the backbone's tensors without prefix."""
    x_first1 = F.relu(_bn(_conv(im, p["firstconv.weight"], None, 2, 3, q), p, "firstbn"))
    x = F.max_pool2d(x_first1, 3, 2, 1)
    x_first = x
    skips = []
    for li, n_blocks in enumerate(ENCODER_BLOCKS[encoder]):
        for bi in range(n_blocks):
            x = _bottleneck(x, p, f"layer{li + 1}.{bi}", 2 if (bi == 0 and li > 0) else 1, q)
        skips.append(x)
    x1, x2, x3 = skips
    y = F.interpolate(x3, scale_factor=2, mode="bilinear", align_corners=True)
    y = _conv_bn_elu(y, p, "upconv3.conv", 1, q)
    y = _conv_bn_elu(torch.cat([x2, _pad_to(y, x2)], 1), p, "iconv3", 1, q)
    y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
    y = _conv_bn_elu(y, p, "upconv2.conv", 1, q)
    y = _conv_bn_elu(torch.cat([x1, _pad_to(y, x1)], 1), p, "iconv2", 1, q)
    return _conv_bn_elu(y, p, "conv_fine", 0, q), x_first


def _instance_norm(x):
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + IN_EPS)


def head(p: dict, fine: torch.Tensor, im: torch.Tensor, q=None) -> torch.Tensor:
    """fine NCHW [B, 192, h, w], im NCHW normalized [B, 3, H, W] -> score
    [B, 1, H, W]; ``p`` holds the head's tensors without prefix."""
    a = p["relu.weight"]
    prelu = lambda t: torch.where(t >= 0, t, a * t)
    trunk = prelu(_instance_norm(_conv(fine, p["conv1.weight"], p["conv1.bias"], 1, 1, q)))
    img_feat = _instance_norm(_conv(im, p["convimg.weight"], p["convimg.bias"], 1, 1, q))
    up = F.interpolate(trunk, size=im.shape[2:], mode="bilinear", align_corners=False)
    x = prelu(_instance_norm(_conv(torch.cat([up, img_feat], 1), p["conv2.weight"], p["conv2.bias"], 1, 1, q)))
    return F.softplus(_instance_norm(_conv(x, p["conv3.weight"], p["conv3.bias"], q=q)))


def split_params(params: dict):
    bb = {k[len("backbone."):]: v for k, v in params.items() if k.startswith("backbone.")}
    hd = {k[len("localheader."):]: v for k, v in params.items() if k.startswith("localheader.")}
    return bb, hd


def forward(params: dict, im_u8: torch.Tensor, encoder: str = "resnet50", q=None):
    """uint8 NHWC images -> (score [B, H, W], local_map NCHW)."""
    bb, hd = split_params(params)
    im = normalize_image(im_u8).permute(0, 3, 1, 2)
    local_map, small = backbone(bb, im, encoder, q)
    score = head(hd, torch.cat([local_map, small], 1), im, q)
    return score[:, 0], local_map


# ---------------------------------------------------------------- detector


def nms_mask(s: torch.Tensor, radius: int) -> torch.Tensor:
    """s [B, h, w] -> bool: the maximum of its (2r+1)² window, the map
    reflect-padded; of equal values the one with the lower linear index
    (row-major, in the padded map) wins."""
    r = radius
    sp = F.pad(s[:, None], (r, r, r, r), mode="reflect")[:, 0]
    h, w = s.shape[1:]
    keep = torch.ones_like(s, dtype=torch.bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nb = sp[:, r + dy: r + dy + h, r + dx: r + dx + w]
            earlier = dy < 0 or (dy == 0 and dx < 0)
            keep &= (s > nb) if earlier else (s >= nb)
    return keep


def refined_coords(score: torch.Tensor) -> torch.Tensor:
    """The 3×3 score-weighted centre of mass of every interior pixel, in
    pixels: [B, H-2, W-2, 2] (x, y). Computed on the normalized [-1, 1]
    grid, as the reference code does, then mapped to pixels."""
    B, H, W = score.shape
    ys = torch.linspace(-1, 1, H, device=score.device)
    xs = torch.linspace(-1, 1, W, device=score.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    s = score[:, None]
    den = F.avg_pool2d(s, 3, 1)
    rx = F.avg_pool2d(s * gx, 3, 1) / den
    ry = F.avg_pool2d(s * gy, 3, 1) / den
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    return torch.stack([rx[:, 0] * cx + cx, ry[:, 0] * cy + cy], dim=-1)


def detect(score: torch.Tensor, num_pts: int, nms_radius: int, thr: float):
    """score [B, H, W] -> (idx [B, k] flat interior indices in rank order,
    valid [B], interior score [B, H-2, W-2], 3×3 max-pooled score
    [B, H-2, W-2], refined pixel coords [B, H-2, W-2, 2]). The NMS winners
    above ``thr`` ranked by score, ties to the lower index; past them the
    rest of the map at score 0 in index order."""
    interior = score[:, 1:-1, 1:-1]
    keep = nms_mask(interior, nms_radius) & (interior > thr)
    valid = keep.flatten(1).sum(1)
    masked = torch.where(keep, interior, torch.zeros_like(interior)).flatten(1)
    k = min(num_pts, masked.shape[1])
    idx = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
    pooled = F.max_pool2d(score[:, None], 3, 1)[:, 0]
    return idx, valid, interior, pooled, refined_coords(score)


def emitted(valid: int, num_pts: int) -> int:
    """How many of the ranked points an image's slate keeps."""
    return int(max(min(num_pts, valid), 128))


def sample_descriptors(local_map: torch.Tensor, coords_px: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """local_map NCHW [B, C, h, w] at pixel coords [B, N, 2] of the H×W
    image -> unit descriptors [B, N, C]."""
    c = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=coords_px.device)
    grid = ((coords_px - c) / c)[:, None]
    d = F.grid_sample(local_map, grid, mode="bilinear", padding_mode="zeros", align_corners=False)[:, :, 0]
    d = d.transpose(1, 2)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


def slate(score: torch.Tensor, local_map: torch.Tensor, num_pts: int, nms_radius: int, thr: float):
    """One image's slate as the reference extracts it: score [H, W],
    local_map NCHW [1, C, h, w] -> (keypoints [n, 2] px, scores [n, 1],
    descriptors [n, C]), n = max(min(num_pts, valid), 128)."""
    H, W = score.shape
    idx, valid, _interior, pooled, grids = detect(score[None], num_pts, nms_radius, thr)
    idx = idx[0, : emitted(int(valid[0]), num_pts)]
    kpt = grids[0].reshape(-1, 2)[idx]
    scores = pooled[0].reshape(-1)[idx][:, None]
    return kpt, scores, sample_descriptors(local_map, kpt[None], H, W)[0]
