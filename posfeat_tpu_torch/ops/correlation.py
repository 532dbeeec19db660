"""Descriptor correlation, match distributions and the alternative
matchers: log-space Sinkhorn OT and dual softmax
(posfeat_tpu/ops/correlation.py:32-153; reference
preprocess_utils.py:55-194). The m×n products are f32 matmuls, which
stay out of TF32 on the card (``core/device.py``); a bf16 operand is
widened first, as JAX's ``preferred_element_type=float32`` products take
it (correlation.py:20-31)."""

from __future__ import annotations

import math

import torch

from .coords import gen_grid


def compute_prob(feat1: torch.Tensor, feat2: torch.Tensor, loss_distance: str = "cos",
                 with_scale: bool = False, return_sim: bool = False):
    """Softmax match distribution between feature sets (putils:89-115):
    feat1 [B, m, d] queries, feat2 [B, n, d] references -> prob
    [B, m, n] (and the similarity, with ``return_sim``)."""
    if loss_distance not in ("cos", "euc"):
        raise ValueError(f"unsupported loss_distance {loss_distance!r}")
    if return_sim and loss_distance != "cos":
        raise ValueError("return_sim needs loss_distance 'cos'")
    feat1, feat2 = feat1.float(), feat2.float()
    if loss_distance == "cos":
        sim = torch.bmm(feat1, feat2.transpose(1, 2))
        scale = math.sqrt(feat2.shape[1]) if with_scale else 1.0
        prob = torch.softmax(scale * sim, dim=-1)
    else:
        dist = (
            (feat1 ** 2).sum(-1, keepdim=True)
            + (feat2 ** 2).sum(-1, keepdim=True).transpose(1, 2)
            - 2 * torch.bmm(feat1, feat2.transpose(1, 2))
        )
        prob = torch.softmax(-dist, dim=-1)
    if return_sim:
        return prob, sim
    return prob


def get_expected_correspondence_locs(feat1: torch.Tensor, featmap2: torch.Tensor,
                                     with_std: bool = False):
    """Softmax-expected correspondence over a whole map (putils:55-82):
    feat1 [B, n, d], featmap2 [B, H, W, d] -> expected normalized locs
    [B, n, 2] (and, with ``with_std``, std [B, n], kurtosis [B, n] and
    the prob [B, n, H·W])."""
    B, h2, w2, d = featmap2.shape
    g = gen_grid(-1, 1, -1, 1, h2, w2, dtype=featmap2.dtype, device=featmap2.device)[None, None]
    prob = compute_prob(feat1, featmap2.reshape(B, h2 * w2, d))  # [B, n, hw]
    expected = (g * prob[..., None]).sum(2)
    if not with_std:
        return expected
    var = (g ** 2 * prob[..., None]).sum(2) - expected ** 2
    std = var.clamp_min(1e-10).sqrt().sum(-1)
    kurt = (g - expected[:, :, None, :]).pow(4).mean(-2) / var.pow(2)
    kurt = (kurt / 10.0).clamp(0, 1)
    return expected, std, kurt.mean(-1), prob


def _sinkhorn(P: torch.Tensor, log_m: torch.Tensor, log_n: torch.Tensor, iters: int) -> torch.Tensor:
    u = torch.zeros_like(log_m)
    v = torch.zeros_like(log_n)
    for _ in range(iters):
        u = log_m - torch.logsumexp(P + v, dim=2, keepdim=True)
        v = log_n - torch.logsumexp(P + u, dim=1, keepdim=True)
    return P + u + v


def ot_sinkhorn_log(costs: torch.Tensor, iters: int = 20, temperature: float = None):
    """Log-space Sinkhorn normalization of a cost matrix (putils:117-140):
    (plan [B, m, n], None)."""
    b, m, n = costs.shape
    norm = -math.log(float(m + n))
    log_m = torch.full((b, m, 1), norm, dtype=costs.dtype, device=costs.device)
    log_n = torch.full((b, 1, n), norm, dtype=costs.dtype, device=costs.device)
    P = _sinkhorn(-temperature * costs, log_m, log_n, iters)
    return torch.exp(P - norm), None


def ot_sinkhorn_log_unmatch(costs: torch.Tensor, iters: int = 20, temperature: float = None):
    """Sinkhorn with a dustbin row and column for unmatched points
    (putils:142-174): (plan [B, m, n], augmented plan [B, m+1, n+1])."""
    b, m, n = costs.shape
    bins1 = 1 - costs.amin(dim=2, keepdim=True)  # [b, m, 1]
    bins2 = 1 - costs.amin(dim=1, keepdim=True)  # [b, 1, n]
    corner = (bins1.mean(1, keepdim=True) + bins2.mean(2, keepdim=True)) / 2
    costs = torch.cat([torch.cat([costs, bins1], -1), torch.cat([bins2, corner], -1)], 1)
    norm = -math.log(float(m + n))
    log_m = torch.full((b, m + 1, 1), norm, dtype=costs.dtype, device=costs.device)
    log_n = torch.full((b, 1, n + 1), norm, dtype=costs.dtype, device=costs.device)
    log_m[:, -1, :] = math.log(float(n)) + norm
    log_n[:, :, -1] = math.log(float(m)) + norm
    optimal = torch.exp(_sinkhorn(-temperature * costs, log_m, log_n, iters) - norm)
    return optimal[:, :-1, :-1], optimal


def dual_softmax(costs: torch.Tensor, iters=None, temperature: float = None):
    """Dual-softmax matcher (putils:176-194): the product is
    prob_col · prob_col, as the reference writes it (putils:192)."""
    t = 15.0 if temperature is None else temperature
    prob_col = torch.softmax(-t * costs, dim=2)
    return prob_col * prob_col, None
