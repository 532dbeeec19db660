"""Stage-2 training (the detector head by REINFORCE, DISK-style) in plain
float32 PyTorch, from the reference code's semantics (losses/kploss.py):
for each pair, one Categorical pixel per grid cell and its Bernoulli
accept on both score maps (the draws are given), descriptors sampled at
the proposals, the dual-softmax match distribution over the detached
m×n cost at temperature T, a constant epipolar reward (good where both
point-to-line distances are under the threshold), and

    loss = -Σ accept·reward·p·(logp_I + logp_T + logp1 + logp2)
           - kp_penalty · (Σ accept1·logp1 + Σ accept2·logp2),

summed over the batch. The backbone is frozen and its input detached;
the head's gradient flows through the log-probabilities only. One SGD
step (no momentum) updates the head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import extraction


def _cells(score: torch.Tensor, g: int) -> torch.Tensor:
    """score [H, W] -> [hg, wg, g·g], row-major inside a cell."""
    H, W = score.shape
    hg, wg = H // g, W // g
    return score[: hg * g, : wg * g].reshape(hg, g, wg, g).permute(0, 2, 1, 3).reshape(hg, wg, g * g)


def _point_logp(score, proposals, accept, g):
    cells = _cells(score, g)
    logp = torch.gather(F.log_softmax(cells, -1), -1, proposals[..., None])[..., 0]
    logit = torch.gather(cells, -1, proposals[..., None])[..., 0]
    logp = logp + torch.where(accept, -F.softplus(-logit), -F.softplus(logit))
    hg, wg = proposals.shape
    y = torch.arange(hg, device=score.device)[:, None] * g + proposals // g
    x = torch.arange(wg, device=score.device)[None, :] * g + proposals % g
    return torch.stack([x, y], -1).reshape(-1, 2).float(), logp.reshape(-1)


def _line_dist(fm, c_from, c_to, q):
    """Distance of each c_to point to the epipolar line of each c_from
    point under fm: [m, n]."""
    hom = lambda c: torch.cat([c, torch.ones_like(c[:, :1])], 1)
    a, b = hom(c_from), fm
    if q is not None:
        a, b = q(a), q(b)
    lines = b @ a.T  # [3, m]
    lines = lines / torch.linalg.vector_norm(lines[:2], dim=0, keepdim=True).clamp_min(1e-8)
    lt, ht = lines.T, hom(c_to).T
    if q is not None:
        lt, ht = q(lt), q(ht)
    return (lt @ ht).abs()


def pair_loss(head_p, maps, im1, im2, F1, F2, draws, cfg, epoch=1, q=None):
    """The loss of one pair. ``maps``: the frozen backbone's (local_map,
    small) of both images, NCHW [2, ...]; im1, im2 NCHW [1, 3, H, W];
    F1 [3, 3] maps image-1 points to image-2 lines, F2 the other way;
    ``draws`` ((proposals1, accept1), (proposals2, accept2)) [hg, wg]."""
    local, small = maps
    fine = torch.cat([local, small], 1).detach()
    s1 = extraction.head(head_p, fine[:1], im1, q)[0, 0]
    s2 = extraction.head(head_p, fine[1:], im2, q)[0, 0]
    g = cfg["grid_size"]
    (p1, a1), (p2, a2) = draws
    c1, lp1 = _point_logp(s1, p1, a1, g)
    c2, lp2 = _point_logp(s2, p2, a2, g)
    H, W = s1.shape
    f1 = extraction.sample_descriptors(local[:1], c1[None], H, W)[0]
    f2 = extraction.sample_descriptors(local[1:], c2[None], H, W)[0]
    with torch.no_grad():
        x, y = (q(f1), q(f2)) if q is not None else (f1, f2)
        T = min(cfg["temperature_base"] + epoch, cfg["temperature_max"])
        aff = -T * (1.0 - x @ y.T)
        logp_i = F.log_softmax(aff, 1)
        logp_t = F.log_softmax(aff, 0)
        p = torch.exp(logp_i) * torch.exp(logp_t)
        thr = cfg["reward_config"]["reward_thr"]
        good = (_line_dist(F1, c1, c2, q) < thr) & (_line_dist(F2, c2, c1, q).T < thr)
        reward = torch.where(good, float(cfg["good_reward"]), float(cfg["bad_reward"]))
        w = (a1.reshape(-1)[:, None] & a2.reshape(-1)[None, :]).float() * reward * p
        s0 = (w * (logp_i + logp_t)).sum()
    a1f, a2f = a1.reshape(-1).float(), a2.reshape(-1).float()
    reinforce = s0 + (lp1 * w.sum(1)).sum() + (lp2 * w.sum(0)).sum()
    penalty = cfg["kp_penalty"] * ((a1f * lp1).sum() + (a2f * lp2).sum())
    return -reinforce - penalty


def train_steps(params, batches, draws, cfg, lrs, encoder="resnet50", q=None, pairs=None):
    """SGD steps of the head from ``params`` (the full model's tensors),
    one per batch at its learning rate ``lrs[i]``: batches[i] = (im1, im2
    NHWC normalized [B, H, W, 3], F1, F2 [B, 3, 3]), draws[i] = ((prop1,
    acc1), (prop2, acc2)) [B, hg, wg].
    Pairs one at a time, gradients summed. ``pairs``, where given, picks
    which pairs of each batch enter the loss and scales it by B / len
    (a fault: part of the batch left out, the mean taken over the rest).
    Returns (losses, first gradient {leaf: tensor}, head after each step)."""
    bb, hd = extraction.split_params(params)
    head_p = {k: v.detach().clone().requires_grad_(True) for k, v in hd.items()}
    losses, first_grad, states = [], None, []
    for (im1, im2, F1, F2), ((pr1, ac1), (pr2, ac2)), lr in zip(batches, draws, lrs):
        B = im1.shape[0]
        chosen = range(B) if pairs is None else pairs
        scale = B / len(chosen)
        for t in head_p.values():
            t.grad = None
        total = 0.0
        for b in chosen:
            ims = torch.stack([im1[b], im2[b]]).permute(0, 3, 1, 2)
            with torch.no_grad():
                maps = extraction.backbone(bb, ims, encoder, q)
            loss = scale * pair_loss(head_p, maps, ims[:1], ims[1:], F1[b], F2[b],
                                     ((pr1[b], ac1[b]), (pr2[b], ac2[b])), cfg, q=q)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: t.grad.detach().clone() for k, t in head_p.items()}
        if first_grad is None:
            first_grad = grads
        with torch.no_grad():
            for k, t in head_p.items():
                t -= lr * grads[k]
        states.append({k: t.detach().clone() for k, t in head_p.items()})
    return losses, first_grad, states
