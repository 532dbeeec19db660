"""Stochastic keypoint samplers of the stage-2 loss, the stage-1 grid
sampler and the detectors' Gumbel selection (posfeat_tpu/ops/samplers.py;
reference kploss.py:20-48, preprocess_utils.py:467-476, 598-659).

Drawing and scoring are split: the ``draw_*`` functions take a
``torch.Generator`` and return indices or accepts without a graph, and
the ``*_logp`` functions take those draws and return their log
probabilities, where the gradient flows. ``jax.random`` and torch give
different bits from one seed, so a test can hand JAX's draws to the
scoring functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.distributed import uniform
from .coords import gen_grid
from .grid_sample import grid_sample


def unfold(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/g, W/g, C, g·g] cell unfold, row-major over
    (dy, dx) inside a cell; trailing rows and columns that fill no cell
    are dropped (torch ``unfold`` semantics)."""
    B, H, W, C = x.shape
    g = grid_size
    hg, wg = H // g, W // g
    x = x[:, : hg * g, : wg * g, :].reshape(B, hg, g, wg, g, C)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, hg, wg, C, g * g)


def draw_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One Categorical(logits) draw over the trailing axis (Gumbel-max),
    int64 indices. ``generator``: a ``torch.Generator`` or a ``RowShard``."""
    u = uniform(logits.shape, generator, logits.device)
    gumbel = -torch.log((-torch.log(u.clamp_min(1e-20))).clamp_min(1e-20))
    return (logits.detach().float() + gumbel).argmax(dim=-1)


def categorical_logp(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[idx] over the trailing axis."""
    return torch.gather(F.log_softmax(logits, dim=-1), -1, idx[..., None].long())[..., 0]


def categorical_sample_logp(logits: torch.Tensor, generator: torch.Generator):
    """Sample the trailing axis of logits; return (idx, log_prob)."""
    idx = draw_categorical(logits, generator)
    return idx, categorical_logp(logits, idx)


def gumbel_noise(shape, generator: torch.Generator, dtype=torch.float32, device=None,
                 eps: float = 1e-20) -> torch.Tensor:
    """Gumbel(0, 1) noise -log(-log(u + eps) + eps), u ~ U[0, 1), drawn
    from ``generator`` (samplers.py:157-159)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_topk_select(prob: torch.Tensor, num_points: int, noise: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """Soft Gumbel selection matrix [B, num_points, H·W] of the map prob
    [B, H, W, 1] on given noise [B, num_points, H·W]: softmax over the
    pixels of (prob + noise) / temperature (samplers.py:162-170;
    putils:467-476)."""
    B, H, W, _ = prob.shape
    if tuple(noise.shape) != (B, num_points, H * W):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(B, num_points, H * W)}")
    y = prob.reshape(B, 1, H * W) + noise
    return torch.softmax(y / temperature, dim=2)


def draw_bernoulli(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(sigmoid(logits)) draws as booleans."""
    u = uniform(logits.shape, generator, logits.device)
    return u < torch.sigmoid(logits.detach().float())


def bernoulli_logp(logits: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """log p(sample) under Bernoulli(logits), from the logits stably:
    log sigmoid(l) = -softplus(-l), log(1 - sigmoid(l)) = -softplus(l)."""
    return torch.where(sample.bool(), -F.softplus(-logits), -F.softplus(logits))


def bernoulli_sample_logp(logits: torch.Tensor, generator: torch.Generator):
    """Bernoulli(logits) sample in {0., 1.} and its log-prob."""
    sample = draw_bernoulli(logits, generator)
    return sample.to(logits.dtype), bernoulli_logp(logits, sample)


def grid_cells(kp_map: torch.Tensor, grid_size: int) -> torch.Tensor:
    """kp_map [B, H, W, 1] -> per-cell logits [B, hg, wg, g·g]."""
    return unfold(kp_map, grid_size)[:, :, :, 0, :]


def grid_categorical_sample(kp_map: torch.Tensor, grid_size: int, generator: torch.Generator):
    """Per-cell Categorical(logits=scores) pixel proposal (kploss.py:20-27):
    (proposals [B, hg, wg] int64, logp [B, hg, wg], cell logits
    [B, hg, wg, g·g])."""
    cells = grid_cells(kp_map, grid_size)
    idx, logp = categorical_sample_logp(cells, generator)
    return idx, logp, cells


def accept_logits(cells: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
    """The proposed pixel's own logit in each cell, [B, hg, wg]."""
    return torch.gather(cells, -1, proposals[..., None].long())[..., 0]


def grid_bernoulli_accept(cells: torch.Tensor, proposals: torch.Tensor,
                          generator: torch.Generator):
    """Bernoulli accept/reject of the proposed pixels (kploss.py:26-31):
    (accept bool, accept logp)."""
    logits = accept_logits(cells, proposals)
    accept = draw_bernoulli(logits, generator)
    return accept, bernoulli_logp(logits, accept)


def cell_coords_pixel(H: int, W: int, grid_size: int, proposals: torch.Tensor) -> torch.Tensor:
    """Pixel (x, y) of the proposed pixels, [B, hg, wg, 2] f32
    (kploss.py:42-47). The JAX version gathers from a linspace grid whose
    values are the integer pixel indices; this computes them."""
    g = grid_size
    B, hg, wg = proposals.shape
    dev = proposals.device
    cy = torch.arange(hg, device=dev)[None, :, None] * g + proposals // g
    cx = torch.arange(wg, device=dev)[None, None, :] * g + proposals % g
    return torch.stack([cx, cy], dim=-1).float()


def cell_coords_normalized(H: int, W: int, grid_size: int, proposals: torch.Tensor) -> torch.Tensor:
    """Normalized (x, y) of the proposed pixels, [B, hg, wg, 2], read from
    the [-1, 1] linspace grid as the JAX version gathers them."""
    g = grid_size
    B, hg, wg = proposals.shape
    dev = proposals.device
    cy = torch.arange(hg, device=dev)[None, :, None] * g + proposals // g
    cx = torch.arange(wg, device=dev)[None, None, :] * g + proposals % g
    xs = torch.linspace(-1, 1, W, device=dev)
    ys = torch.linspace(-1, 1, H, device=dev)
    return torch.stack([xs[cx], ys[cy]], dim=-1)


def draw_grid_random(kp_map: torch.Tensor, grid_size: int, random_select: str,
                     generator: torch.Generator) -> torch.Tensor:
    """The stage-1 grid sampler's draw for one image, without a graph:
    ``random``, a Categorical pixel per cell (proposals [B, hg, wg]
    int64); ``regular_random``, one uniform [0, 1) pair per image
    ([B, 1, 1, 2]) that jitters the regular grid."""
    if random_select == "random":
        return draw_categorical(grid_cells(kp_map, grid_size), generator)
    if random_select == "regular_random":
        return uniform((kp_map.shape[0], 1, 1, 2), generator, kp_map.device)
    raise ValueError(f"unsupported random_select: {random_select}")


def regular_grid_random_single(kp_map: torch.Tensor, grid_size: int, random_select: str,
                               draw: torch.Tensor):
    """Stage-1 grid sampler on a given draw (putils:624-659): kp_map
    [B, H, W, 1] -> (kps_n [B, hg, wg, 2], score [B, hg, wg, 1]).
    ``random``: the drawn pixel of each cell, scored by its raw map value;
    ``regular_random``: the regular grid shifted by the image's jitter,
    scored by bilinear sampling."""
    B, H, W, _ = kp_map.shape
    if random_select == "random":
        score = torch.gather(grid_cells(kp_map, grid_size), -1, draw[..., None])
        return cell_coords_normalized(H, W, grid_size, draw), score
    if random_select == "regular_random":
        start = 0.5 * grid_size / H
        num_h, num_w = H // grid_size, W // grid_size
        base = gen_grid(-1 + start, 1 - start, -1 + start, 1 - start, num_h, num_w,
                        dtype=kp_map.dtype, device=kp_map.device).reshape(1, num_h, num_w, 2)
        kps = base.expand(B, num_h, num_w, 2) + start * (2 * draw.to(kp_map.dtype) - 1)
        return kps, grid_sample(kp_map, kps, padding_mode="zeros")
    raise ValueError(f"unsupported random_select: {random_select}")


@torch.no_grad()
def generate_kpts_regular_grid_random(kp_map1: torch.Tensor, kp_map2: torch.Tensor, grid_size: int,
                                      draws, random_select: str = "random", keep_spatial: bool = True):
    """Two-image grid sampler on given draws (putils:598-622), without a
    graph: (kps1, kps2, score1, score2), [B, hg, wg, ...] or, without
    ``keep_spatial``, [B, hg·wg, ...]."""
    kps1, s1 = regular_grid_random_single(kp_map1, grid_size, random_select, draws[0])
    kps2, s2 = regular_grid_random_single(kp_map2, grid_size, random_select, draws[1])
    if not keep_spatial:
        B = kps1.shape[0]
        kps1, kps2 = kps1.reshape(B, -1, 2), kps2.reshape(B, -1, 2)
        s1, s2 = s1.reshape(B, -1, 1), s2.reshape(B, -1, 1)
    return kps1, kps2, s1, s2
