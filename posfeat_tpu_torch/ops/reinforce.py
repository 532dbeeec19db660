"""Streamed stage-2 REINFORCE reduction over the m×n match volume
(posfeat_tpu/ops/pallas/reinforce.py).

In the shipped stage-2 configuration (cor_detach, no match_grad) the
DiskLoss match volume carries no gradient, and the loss reduces to

    reinforce = s0 + Σ_i logp1_i·rowW_i + Σ_j logp2_j·colW_j,
    W = accept1 ⊗ accept2 · reward · p,   s0 = Σ W·dense_logp,

with p = exp(dense_logp), dense_logp = 2·aff − row_lse − col_lse and
aff = T·f1·f2ᵀ − T. Two kernels compute it without an m×n tensor
(``csrc/reinforce.cu``):

- ``lse_pass`` (replaces the TPU passes 1 and 2, reinforce.py:66 and :88):
  the row log-sum-exp of aff and per-row-tile (max, Σexp) column partials,
  which the wrapper merges into the column log-sum-exp;
- ``reward_pass`` (replaces pass 3, reinforce.py:110): p, the epipolar
  distances, the reward, W and every statistic the loss and its
  diagnostics need, with per-row-tile partials that the wrapper sums.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it. There is no backward:
every output is detached, as the JAX reduction stops gradients.
"""

from __future__ import annotations

import ctypes

import torch

TILE_M = 64  # rows of f1 per CUDA block (csrc/reinforce.cu TM)
MAX_D = 128


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from ._build import load_kernels

        msg = load_kernels().posfeat_reinforce_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({rc}): {msg}")


def _shapes(f1, f2):
    B, m, D = f1.shape
    n = f2.shape[1]
    if f2.shape != (B, n, D):
        raise ValueError(f"f2 has shape {tuple(f2.shape)}, expected ({B}, n, {D})")
    if D % 4 or D > MAX_D:
        raise ValueError(f"the kernels need D % 4 == 0 and D <= {MAX_D}; got D = {D}")
    return B, m, n, D


def _affinity(f1, f2, temperature):
    """aff = T·f1·f2ᵀ − T, [B, m, n] f32."""
    return temperature * torch.bmm(f1, f2.transpose(1, 2)) - temperature


def _line_dist(a, b):
    """|a_i · b_j| for a [B, m, 3], b [B, n, 3] -> [B, m, n]: three
    rounded products and two rounded sums, in the kernel's order."""
    a, b = a[:, :, None, :], b[:, None, :, :]
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]).abs()


# ------------------------------------------------------------- lse pass


def lse_pass_plain(f1, f2, temperature: float):
    """Plain version of the lse pass: (row_lse [B, m], col_lse [B, n]) of
    aff, Σexp clipped at 1e-30 as reinforce.py:277-278 does."""
    aff = _affinity(f1, f2, temperature)

    def lse(dim):
        mx = aff.amax(dim=dim, keepdim=True)
        se = torch.exp(aff - mx).sum(dim=dim)
        return mx.squeeze(dim) + torch.log(se.clamp_min(1e-30))

    return lse(2), lse(1)


def lse_pass(f1, f2, temperature: float):
    """The lse-pass kernel (replaces posfeat_tpu/ops/pallas/reinforce.py:66
    ``_pass1_kernel`` and :88 ``_pass2_kernel``); same contract as
    ``lse_pass_plain``."""
    if f1.device.type == "cpu":
        return lse_pass_plain(f1, f2, temperature)
    from ._build import load_kernels

    B, m, n, D = _shapes(f1, f2)
    dev = f1.device
    _check(f1, "f1", (B, m, D), dev)
    _check(f2, "f2", (B, n, D), dev)
    mt = -(-m // TILE_M)
    row_lse = torch.empty((B, m), dtype=torch.float32, device=dev)
    col_max = torch.empty((B, mt, n), dtype=torch.float32, device=dev)
    col_sum = torch.empty_like(col_max)
    rc = load_kernels().posfeat_lse_pass(
        _ptr(f1), _ptr(f2), _ptr(row_lse), _ptr(col_max), _ptr(col_sum),
        B, m, n, D, float(temperature), _stream(),
    )
    lse_pass.launches += 1
    _raise_on(rc, "lse_pass")
    mx = col_max.amax(dim=1, keepdim=True)
    se = (col_sum * torch.exp(col_max - mx)).sum(dim=1)
    return row_lse, mx.squeeze(1) + torch.log(se.clamp_min(1e-30))


lse_pass.launches = 0


# ---------------------------------------------------------- reward pass


def reward_pass_plain(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                      *, temperature, thr, good_reward, bad_reward):
    """Plain version of the reward pass, dense in f32. Returns (s0 [B],
    rowW [B, m], colW [B, n], p_rowsum [B, m], p_colsum [B, n], p_max [B],
    p_sum [B], n_good [B]); n_good counts the pairs with both epipolar
    distances under ``thr``, so a card run can count flipped decisions."""
    aff = _affinity(f1, f2, temperature)
    lp = (aff - row_lse[:, :, None]) + (aff - col_lse[:, None, :])
    p = torch.exp(lp)
    good = (_line_dist(line1, c2h) < thr) & (_line_dist(c1h, line2) < thr)
    reward = torch.where(good, good_reward, bad_reward)
    w = accept1[:, :, None] * accept2[:, None, :] * reward * p
    return (
        (w * lp).sum(dim=(1, 2)), w.sum(2), w.sum(1), p.sum(2), p.sum(1),
        p.flatten(1).amax(1), p.sum(dim=(1, 2)), good.sum(dim=(1, 2)).float(),
    )


def reward_pass(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                *, temperature, thr, good_reward, bad_reward):
    """The reward-pass kernel (replaces posfeat_tpu/ops/pallas/reinforce.py:110
    ``_pass3_kernel``); same contract as ``reward_pass_plain``."""
    kw = dict(temperature=temperature, thr=thr, good_reward=good_reward, bad_reward=bad_reward)
    if f1.device.type == "cpu":
        return reward_pass_plain(f1, f2, line1, c2h, line2, c1h, accept1, accept2,
                                 row_lse, col_lse, **kw)
    from ._build import load_kernels

    B, m, n, D = _shapes(f1, f2)
    dev = f1.device
    for t, name, shape in (
        (f1, "f1", (B, m, D)), (f2, "f2", (B, n, D)), (line1, "line1", (B, m, 3)),
        (c2h, "c2h", (B, n, 3)), (line2, "line2", (B, n, 3)), (c1h, "c1h", (B, m, 3)),
        (accept1, "accept1", (B, m)), (accept2, "accept2", (B, n)),
        (row_lse, "row_lse", (B, m)), (col_lse, "col_lse", (B, n)),
    ):
        _check(t, name, shape, dev)
    mt = -(-m // TILE_M)
    f32 = dict(dtype=torch.float32, device=dev)
    row_w, p_rowsum = torch.empty((B, m), **f32), torch.empty((B, m), **f32)
    colw_part, pcol_part = torch.empty((B, mt, n), **f32), torch.empty((B, mt, n), **f32)
    stats = torch.empty((B, mt, 4), **f32)
    rc = load_kernels().posfeat_reward_pass(
        *map(_ptr, (f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                    row_w, p_rowsum, colw_part, pcol_part, stats)),
        B, m, n, D, float(temperature), float(thr), float(good_reward), float(bad_reward),
        _stream(),
    )
    reward_pass.launches += 1
    _raise_on(rc, "reward_pass")
    return (
        stats[..., 0].sum(1), row_w, colw_part.sum(1), p_rowsum, pcol_part.sum(1),
        stats[..., 1].amax(1), stats[..., 2].sum(1), stats[..., 3].sum(1),
    )


reward_pass.launches = 0


# ------------------------------------------------------------ the driver


def _prepare(tensors):
    return [t.detach().float().contiguous() for t in tensors]


def reinforce_reduction_plain(f1, f2, line1, c2h, line2, c1h, accept1, accept2, *,
                              temperature, thr, good_reward, bad_reward):
    """Dense f32 formulation of ``reinforce_reduction`` (the reference's
    ``_naive``, tests/test_pallas_reinforce.py:16-36)."""
    f1, f2, line1, c2h, line2, c1h, accept1, accept2 = _prepare(
        (f1, f2, line1, c2h, line2, c1h, accept1, accept2))
    row_lse, col_lse = lse_pass_plain(f1, f2, temperature)
    return reward_pass_plain(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                             temperature=temperature, thr=thr, good_reward=good_reward,
                             bad_reward=bad_reward)[:7]


def reinforce_reduction(f1, f2, line1, c2h, line2, c1h, accept1, accept2, *,
                        temperature, thr, good_reward, bad_reward):
    """Streamed stage-2 reduction (posfeat_tpu/ops/pallas/reinforce.py:184).

    f1 [B, m, D], f2 [B, n, D] cos-normalized descriptors; line1 [B, m, 3]
    normalized epipolar lines of coord1 and c2h [B, n, 3] homogeneous
    coord2; line2 [B, n, 3] and c1h [B, m, 3] the other direction;
    accept1/2 [B, m]/[B, n] Bernoulli accepts. Returns the detached
    (s0 [B], rowW [B, m], colW [B, n], p_rowsum [B, m], p_colsum [B, n],
    p_max [B], p_sum [B]). Each pass launches its kernel on CUDA tensors
    and runs its plain version on CPU tensors."""
    f1, f2, line1, c2h, line2, c1h, accept1, accept2 = _prepare(
        (f1, f2, line1, c2h, line2, c1h, accept1, accept2))
    row_lse, col_lse = lse_pass(f1, f2, temperature)
    return reward_pass(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                       temperature=temperature, thr=thr, good_reward=good_reward,
                       bad_reward=bad_reward)[:7]
