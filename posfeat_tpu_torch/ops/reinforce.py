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

Both run one product, f1·f2ᵀ as 3×TF32 on the tensor cores, from f1 and
f2 split into TF32 hi and lo tiles by a third kernel (``_split_operands``).
``reinforce_reduction`` splits once and hands the tiles to both passes;
each pass called alone splits for itself. They take any descriptor width
D, as the JAX reduction does: up to ``RESIDENT_D`` a block keeps its f1
tile in shared memory, beyond it f1's tile streams in ``CHUNK``-deep
chunks beside f2's, the split lays f1 out accordingly, and each half of
a block's rows writes its own column partials (``_partials``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it. There is no backward:
every output is detached, as the JAX reduction stops gradients.
"""

from __future__ import annotations

import ctypes

import torch

TILE_M = 128  # rows of f1 per block, columns of f2 per tile (csrc/reinforce.cu LM)
CHUNK = 16  # depth of one f2 chunk of the split tiles (csrc/reinforce.cu LKC)
RESIDENT_D = 128  # widest f1 tile a block keeps whole (csrc/reinforce.cu RESIDENT_D)


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


def kernels_take(D: int) -> bool:
    """Whether the kernels take descriptors of width D (csrc/reinforce.cu
    ``check_shape``): any positive width."""
    return D > 0


def _shapes(f1, f2):
    B, m, D = f1.shape
    n = f2.shape[1]
    if f2.shape != (B, n, D):
        raise ValueError(f"f2 has shape {tuple(f2.shape)}, expected ({B}, n, {D})")
    if not kernels_take(D):
        raise ValueError(f"the kernels need D > 0; got D = {D}")
    return B, m, n, D


def _affinity(f1, f2, temperature):
    """aff = T·f1·f2ᵀ − T, [B, m, n] f32."""
    return temperature * torch.bmm(f1, f2.transpose(1, 2)) - temperature


def _line_dist(a, b):
    """|a_i · b_j| for a [B, m, 3], b [B, n, 3] -> [B, m, n]: three
    rounded products and two rounded sums, in the kernel's order."""
    a, b = a[:, :, None, :], b[:, None, :, :]
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]).abs()


# ------------------------------------------------------------ the split


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 rounds it,
    to nearest with ties away from zero, kept as f32: half of the last
    kept bit added to the magnitude's bits, the 13 dropped bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def f1_resident(D: int) -> bool:
    """Whether a block keeps f1's tile whole at width D (its split is then
    one chunk of the whole depth), or streams it in CHUNK-deep chunks."""
    return D <= RESIDENT_D


def _chunks(D):
    """CHUNK-deep chunks of a tile's depth at width D, zero-filled beyond
    D: an even count where f1 streams, which the streamed loop takes in
    pairs (csrc/reinforce.cu ``tile_chunks``)."""
    nck = -(-D // CHUNK)
    return nck if f1_resident(D) else nck + nck % 2


def _split_plain(x, whole: bool):
    """Plain version of the split of x [B, rows, D]: x = hi + lo, both
    TF32, flat in the kernels' tile layout [B][tile][chunk][hi, lo][cq][128][4]
    (tiles of TILE_M rows, ``_chunks(D)`` CHUNK deep in all, chunks of
    ``cq`` groups of 4 depths, zero beyond rows and D). ``whole``: one
    chunk of the whole depth (f1 where ``f1_resident``), else chunks CHUNK
    deep (f2, and a wider f1)."""
    B, rows, D = x.shape
    depth, tiles = CHUNK * _chunks(D), -(-rows // TILE_M)
    xp = x.new_zeros((B, tiles * TILE_M, depth))
    xp[:, :rows, :D] = x
    hi = _tf32_rna(xp)
    lo = _tf32_rna(xp - hi)
    chunk = depth if whole else CHUNK

    def lay(y):  # [B, tiles, chunks, 1, cq, 128, 4]
        return y.view(B, tiles, TILE_M, depth // chunk, chunk // 4, 4).permute(0, 1, 3, 4, 2, 5)[:, :, :, None]

    return torch.cat([lay(hi), lay(lo)], 3).flatten()


MAX_SPLITS = 4  # column ranges of a row tile in the streamed passes, at most (csrc/reinforce.cu)


def _column_splits(blocks, n_ct, sms):
    """How many column-tile ranges (one block each) the streamed passes cut
    a row tile's n_ct column tiles into, for ``blocks`` (row tile, batch
    element) pairs on ``sms`` SMs, one block an SM: the count s, up to
    MAX_SPLITS and n_ct / 4, that gives the fewest tiles on the longest
    path, ceil(blocks s / sms) waves of ceil(n_ct / s) tiles; the smallest
    on ties. At B = 6, m = n = 4800 (228 blocks of 38 tiles on 132 SMs):
    4, 7 waves of 10 tiles where one range takes 2 waves of 38."""
    cands = range(1, max(1, min(MAX_SPLITS, n_ct // 4)) + 1)
    return min(cands, key=lambda s: (-(-blocks * s // sms) * -(-n_ct // s), s))


def _splits(B, m, n, D, device):
    """The column ranges of a pass at these shapes on ``device``: 1 where
    f1 stays resident, else ``_column_splits`` at its SM count."""
    if f1_resident(D):
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _column_splits(B * -(-m // TILE_M), -(-n // TILE_M), sms)


def _partials(m, D):
    """Rows of column partials the passes write per batch element: one
    per row tile of TILE_M rows while f1 stays resident, one per half tile
    (a warpgroup's 64 rows) where it streams."""
    return -(-m // TILE_M) * (1 if f1_resident(D) else 2)


def _split_floats(B, rows, D):
    return B * -(-rows // TILE_M) * 2 * CHUNK * _chunks(D) * TILE_M


def _split_operands(f1, f2):
    """f1 [B, m, D] and f2 [B, n, D] split into TF32 hi and lo tiles, the
    operands of both passes (csrc/reinforce.cu ``lse_split_kernel``, two
    launches, counted as one split). Returns flat (f1s, f2s) in the layout
    of ``_split_plain``, which runs on CPU tensors."""
    if f1.device.type == "cpu":
        return _split_plain(f1, f1_resident(f1.shape[-1])), _split_plain(f2, False)
    from ._build import load_kernels

    B, m, n, D = _shapes(f1, f2)
    dev = f1.device
    _check(f1, "f1", (B, m, D), dev)
    _check(f2, "f2", (B, n, D), dev)
    f1s = torch.empty(_split_floats(B, m, D), dtype=torch.float32, device=dev)
    f2s = torch.empty(_split_floats(B, n, D), dtype=torch.float32, device=dev)
    rc = load_kernels().posfeat_reinforce_split(_ptr(f1), _ptr(f2), _ptr(f1s), _ptr(f2s), B, m, n, D,
                                                _stream())
    _split_operands.launches += 1
    _raise_on(rc, "split")
    return f1s, f2s


_split_operands.launches = 0


def _tiles(tiles, f1, f2, B, m, n, D):
    """The split tiles a pass reads: ``tiles`` as ``_split_operands``
    returned them, checked, or f1 and f2 split now."""
    if tiles is None:
        return _split_operands(f1, f2)
    for t, name, rows in zip(tiles, ("f1s", "f2s"), (m, n)):
        _check(t, name, (_split_floats(B, rows, D),), f1.device)
    return tiles


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


def merge_col_partials(col_max, col_sum):
    """Log-sum-exp along dim 1 of (max, Σexp) partials, Σexp clipped at
    1e-30 as ``lse_pass_plain`` does: the lse pass's column partials
    [B, rows, n] (``_partials``) into the column log-sum-exp [B, n], and
    beyond RESIDENT_D its row partials [B, ranges, m] (``_splits``) into
    the row log-sum-exp [B, m]."""
    mx = col_max.amax(dim=1, keepdim=True)
    se = (col_sum * torch.exp(col_max - mx)).sum(dim=1)
    return mx.squeeze(1) + torch.log(se.clamp_min(1e-30))


def lse_pass(f1, f2, temperature: float, *, tiles=None):
    """The lse-pass kernel (replaces posfeat_tpu/ops/pallas/reinforce.py:66
    ``_pass1_kernel`` and :88 ``_pass2_kernel``); same contract as
    ``lse_pass_plain``. ``tiles``: f1 and f2 as ``_split_operands``
    returned them, or None to split them here."""
    if f1.device.type == "cpu":
        return lse_pass_plain(f1, f2, temperature)
    from ._build import load_kernels

    B, m, n, D = _shapes(f1, f2)
    dev = f1.device
    _check(f1, "f1", (B, m, D), dev)
    _check(f2, "f2", (B, n, D), dev)
    f1s, f2s = _tiles(tiles, f1, f2, B, m, n, D)
    mt, splits = _partials(m, D), _splits(B, m, n, D, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    col_max, col_sum = torch.empty((B, mt, n), **f32), torch.empty((B, mt, n), **f32)
    if f1_resident(D):
        row_lse, row_sum = torch.empty((B, m), **f32), None
    else:  # each column range's (max, Σexp) per row
        row_lse, row_sum = torch.empty((B, splits, m), **f32), torch.empty((B, splits, m), **f32)
    rc = load_kernels().posfeat_lse_pass(
        _ptr(f1s), _ptr(f2s), _ptr(row_lse), None if row_sum is None else _ptr(row_sum), _ptr(col_max),
        _ptr(col_sum), B, m, n, D, splits, float(temperature), _stream(),
    )
    lse_pass.launches += 1
    _raise_on(rc, "lse_pass")
    if row_sum is not None:
        row_lse = merge_col_partials(row_lse, row_sum)
    return row_lse, merge_col_partials(col_max, col_sum)


lse_pass.launches = 0


# ---------------------------------------------------------- reward pass


def reward_pass_plain(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                      *, temperature, thr, good_reward, bad_reward):
    """Plain version of the reward pass, dense in f32. Returns (s0 [B],
    rowW [B, m], colW [B, n], p_rowsum [B, m], p_colsum [B, n], p_max [B],
    p_sum [B], n_good [B]); n_good counts the pairs with both epipolar
    distances under ``thr``, so a card run can count flipped decisions."""
    return _reward_of_affinity(_affinity(f1, f2, temperature), line1, c2h, line2, c1h, accept1,
                               accept2, row_lse, col_lse, thr=thr, good_reward=good_reward,
                               bad_reward=bad_reward)


def _reward_of_affinity(aff, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse, *,
                        thr, good_reward, bad_reward):
    """``reward_pass_plain`` on a given affinity aff [B, m, n]."""
    lp = (aff - row_lse[:, :, None]) + (aff - col_lse[:, None, :])
    p = torch.exp(lp)
    good = (_line_dist(line1, c2h) < thr) & (_line_dist(c1h, line2) < thr)
    reward = torch.where(good, good_reward, bad_reward)
    w = accept1[:, :, None] * accept2[:, None, :] * reward * p
    return (
        (w * lp).sum(dim=(1, 2)), w.sum(2), w.sum(1), p.sum(2), p.sum(1),
        p.flatten(1).amax(1), p.sum(dim=(1, 2)), good.sum(dim=(1, 2)).float(),
    )


def _pack_columns(c2h, line2, accept2, col_lse):
    """The reward pass's column operands [B, n_tiles, 8, TILE_M],
    structure of arrays per column tile (c2h x, y, z, line2 x, y, z,
    accept2, col_lse), one bulk copy each. Columns beyond n get NaN lines
    (never good), accept 0 (W = 0) and col_lse 1e30 (p = 0), so the
    kernel needs no mask per pair."""
    B, n = accept2.shape
    n_ct = -(-n // TILE_M)

    def pad(x, value):
        return torch.nn.functional.pad(x, (0, 0, 0, n_ct * TILE_M - n), value=value)

    nan = float("nan")
    cols = torch.cat([pad(c2h, nan), pad(line2, nan), pad(accept2[..., None], 0.0),
                      pad(col_lse[..., None], 1e30)], -1)
    return cols.view(B, n_ct, TILE_M, 8).transpose(2, 3).contiguous()


def reward_pass(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                *, temperature, thr, good_reward, bad_reward, tiles=None):
    """The reward-pass kernel (replaces posfeat_tpu/ops/pallas/reinforce.py:110
    ``_pass3_kernel``); same contract as ``reward_pass_plain``. ``tiles``:
    f1 and f2 as ``_split_operands`` returned them, or None to split them
    here."""
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
    f1s, f2s = _tiles(tiles, f1, f2, B, m, n, D)
    cols = _pack_columns(c2h, line2, accept2, col_lse)
    mt, splits = _partials(m, D), _splits(B, m, n, D, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # the rows' sums over each column range
    row_w, p_rowsum = torch.empty((B, splits, m), **f32), torch.empty((B, splits, m), **f32)
    colw_part, pcol_part = torch.empty((B, mt, n), **f32), torch.empty((B, mt, n), **f32)
    stats = torch.empty((B, mt * splits, 4), **f32)
    rc = load_kernels().posfeat_reward_pass(
        *map(_ptr, (f1s, f2s, line1, c1h, accept1, row_lse, cols,
                    row_w, p_rowsum, colw_part, pcol_part, stats)),
        B, m, n, D, splits, float(temperature), float(thr), float(good_reward), float(bad_reward),
        _stream(),
    )
    reward_pass.launches += 1
    _raise_on(rc, "reward_pass")
    row_w, p_rowsum = (x[:, 0] if splits == 1 else x.sum(1) for x in (row_w, p_rowsum))
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
    p_max [B], p_sum [B]). Each pass launches its kernel on CUDA tensors,
    both on one split of f1 and f2, and runs its plain version on CPU
    tensors."""
    f1, f2, line1, c2h, line2, c1h, accept1, accept2 = _prepare(
        (f1, f2, line1, c2h, line2, c1h, accept1, accept2))
    tiles = _split_operands(f1, f2) if f1.is_cuda else None
    row_lse, col_lse = lse_pass(f1, f2, temperature, tiles=tiles)
    return reward_pass(f1, f2, line1, c2h, line2, c1h, accept1, accept2, row_lse, col_lse,
                       temperature=temperature, thr=thr, good_reward=good_reward,
                       bad_reward=bad_reward, tiles=tiles)[:7]
