"""Instance-norm moments from per-row partial sums, in an order that does
not depend on how many rows a call holds.

The head's instance norms (models/keypoint_det.py ``instance_norm``,
parallel/banded_ops.py ``instance_norm``) normalise over every axis of an
NHWC map but the batch and the channels. ``row_moments`` sums Σx and Σx²
of each row (axis 1) in f32, [B, R, C]; ``moments`` adds those partials
over the rows and forms the mean and rsqrt(var + eps), and ``normalize``
applies them. Each row's sums come out the same whether the map is whole
or a band of its rows, so the H-banded program, which concatenates its
bands' partials on one device, gets the unsharded program's moments bit
for bit.

On a CUDA tensor ``row_moments`` launches ``csrc/moments.cu``
``row_moments_kernel`` (the lane plan) or ``row_moments_slots_kernel``
(the slot plan), as ``launch_shape`` picks from the row's length,
channels and dtype (counted in ``row_moments.launches``), or raises;
on a CPU tensor it runs ``row_moments_plain``, a pairwise tree of
elementwise adds over each row's positions, whose every sum likewise
depends on the row alone. Its gradient is the plain broadcast of 1 and
2x (``_RowMoments``), so stage-2 training goes through it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

THREADS = 512  # slot plan: most threads a block
MAX_SLOTS = 4096  # slot plan: csrc/moments.cu kMaxSlots
VECTORS_A_THREAD = 32  # slot plan: a row takes about this many vectors a thread, or THREADS
LANES = (32, 64, 128, 256, 512)  # lane plan: threads a row (csrc/moments.cu kMaxLanes)
VECTORS_A_LANE = 16  # lane plan: a row takes about this many vectors a lane
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class Plan(NamedTuple):
    """How the kernel sums a row: ``vec`` elements a load (16 bytes, or 1),
    ``lane`` 1 for the lane plan (``threads`` threads a row, several rows a
    block) or 0 for the slot plan (``threads`` threads a block, one row)."""

    vec: int
    lane: int
    threads: int


def _rows(shape):
    """(B, R, row elements, C) of a map [B, R, ..., C] of ``shape``."""
    if len(shape) < 3:
        raise ValueError(f"row moments take a map [B, R, ..., C], got shape {tuple(shape)}")
    return shape[0], shape[1], math.prod(shape[2:]), shape[-1]


def launch_shape(dtype: torch.dtype, row_elems: int, C: int) -> Plan:
    """The launch plan of rows of ``row_elems`` elements and C channels: a
    function of the row alone (never of how many rows a call holds), which
    fixes every add's order. The lane plan where a row is whole 16-byte
    vectors and C a power of two up to 32 · vec, with threads a row from
    the row's vectors, about ``VECTORS_A_LANE`` a lane (one warp for short
    rows, ``LANES[-1]`` for long ones); otherwise ``slot_plan``."""
    vec = 16 // dtype.itemsize
    if row_elems % vec == 0 and C & (C - 1) == 0 and C <= 32 * vec:
        lanes = LANES[0]
        while lanes < LANES[-1] and 2 * lanes * VECTORS_A_LANE <= row_elems // vec:
            lanes *= 2
        return Plan(vec, 1, lanes)
    return slot_plan(dtype, row_elems, C)


def slot_plan(dtype: torch.dtype, row_elems: int, C: int) -> Plan:
    """The slot plan of such rows: 16-byte vectors where a row is a whole
    number of them and lcm(C, vec) fits the slots; threads the least count
    whose slots (threads · vec) are a multiple of C, doubled to a warp or
    more and while the row holds ``VECTORS_A_THREAD`` vectors a thread, up
    to ``THREADS``: a power of two of slots a channel to fold."""
    vec = 16 // dtype.itemsize
    if row_elems % vec or math.lcm(C, vec) > MAX_SLOTS:
        vec = 1
    base = math.lcm(C, vec) // vec
    if base * vec > MAX_SLOTS:
        raise ValueError(f"row moments take at most {MAX_SLOTS} channels, got {C}")
    threads = base
    while 2 * threads <= THREADS and 2 * threads * vec <= MAX_SLOTS and (
            threads < 32 or 2 * threads * VECTORS_A_THREAD * vec <= row_elems):
        threads *= 2
    return Plan(vec, 0, threads)


def plan_of(x: torch.Tensor) -> Plan:
    """The plan a launch on the map x [B, R, ..., C] takes."""
    _, _, E, C = _rows(x.shape)
    return launch_shape(x.dtype, E, C)


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[B, R, S, C] -> [B, R, C]: the sum over S as a pairwise tree of
    elementwise adds (element i + element i + ⌈S/2⌉ ... ), so each output is
    a function of its own row alone."""
    while t.shape[2] > 1:
        n = t.shape[2]
        h = n // 2
        head = t[:, :, :h] + t[:, :, n - h :]
        t = torch.cat([head, t[:, :, h : n - h]], dim=2) if n % 2 else head
    return t[:, :, 0]


def row_moments_plain(x: torch.Tensor):
    """Plain version of the row-moments kernel: (Σx, Σx²) of each row of
    x [B, R, ..., C] in f32, [B, R, C] each."""
    B, R, E, C = _rows(x.shape)
    xf = x.float().reshape(B, R, E // C, C)
    return _fold(xf), _fold(xf * xf)


def _row_moments_kernel(x: torch.Tensor):
    from ._build import load_kernels

    if x.dtype not in _DTYPES:
        raise TypeError(f"row moments on the card take {tuple(_DTYPES)}, got {x.dtype}")
    B, R, E, C = _rows(x.shape)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    s = torch.empty((2, B, R, C), dtype=torch.float32, device=x.device)  # Σx, then Σx²
    if B * R == 0:
        return s[0], s[1]
    lib = load_kernels()
    # the launch goes to the current device: x's, on a band's own card
    with torch.cuda.device(x.device):
        rc = lib.posfeat_row_moments(x.data_ptr(), s.data_ptr(), _DTYPES[x.dtype], B * R, E, C,
                                     *launch_shape(x.dtype, E, C), torch.cuda.current_stream(x.device).cuda_stream)
    row_moments.launches += 1
    if rc != 0:
        raise RuntimeError(f"row moments launch failed ({rc}): {lib.posfeat_moments_error_string(rc).decode()}")
    return s[0], s[1]


class _RowMoments(torch.autograd.Function):
    """(Σx, Σx²) per row, differentiable: the gradient of Σx is 1 and of
    Σx² is 2x, broadcast over each row's elements."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _row_moments_kernel(x) if x.device.type == "cuda" else row_moments_plain(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        B, R, C = x.shape[0], x.shape[1], x.shape[-1]
        shape = (B, R) + (1,) * (x.ndim - 3) + (C,)
        g = torch.zeros(shape, dtype=torch.float32, device=x.device)
        if g1 is not None:
            g = g + g1.reshape(shape)
        if g2 is not None:
            g = g + 2.0 * x.float() * g2.reshape(shape)
        return g.expand(x.shape).to(x.dtype)


def row_moments(x: torch.Tensor):
    """(Σx, Σx²) of each row of x [B, R, ..., C] over every axis but the
    batch, the row and the channels, f32 [B, R, C] each: the kernel on a
    CUDA tensor (or an error), ``row_moments_plain`` on a CPU tensor."""
    return _RowMoments.apply(x)


row_moments.launches = 0


def moments(s1: torch.Tensor, s2: torch.Tensor, n: int, eps: float):
    """(mean, rsqrt(var + eps)) [B, C] from row partials [B, R, C] of n
    elements a channel: one sum over the rows, the biased variance as
    E[x²] − E[x]², clamped at 0."""
    mean = s1.sum(dim=1) / n
    var = torch.clamp(s2.sum(dim=1) / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def normalize(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """(x − mean) · rstd in f32, back in x's dtype; mean and rstd [B, C]."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return ((x.float() - mean.reshape(shape)) * rstd.reshape(shape)).to(x.dtype)


def check_dims(x: torch.Tensor, dims) -> None:
    """The instance norm's axes must be every one between the batch and the
    channels, the row axis 1 first (the head's (1, 2) and (1, 2, 3, 4))."""
    if tuple(dims) != tuple(range(1, x.ndim - 1)):
        raise ValueError(f"instance_norm normalises over axes 1 .. {x.ndim - 2} of a map [B, R, ..., C]; "
                         f"got dims {tuple(dims)} for shape {tuple(x.shape)}")
