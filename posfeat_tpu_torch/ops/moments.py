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
``row_moments_kernel`` (counted in ``row_moments.launches``) or raises;
on a CPU tensor it runs ``row_moments_plain``, a pairwise tree of
elementwise adds over each row's positions, whose every sum likewise
depends on the row alone. Its gradient is the plain broadcast of 1 and
2x (``_RowMoments``), so stage-2 training goes through it.
"""

from __future__ import annotations

import ctypes
import math

import torch

THREADS = 256  # threads a block aims at; the kernel needs threads · vec to be a multiple of C
MAX_SLOTS = 2048  # csrc/moments.cu kMaxSlots
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rows(x: torch.Tensor):
    """(B, R, row elements, C) of a map [B, R, ..., C]."""
    if x.ndim < 3:
        raise ValueError(f"row moments take a map [B, R, ..., C], got shape {tuple(x.shape)}")
    B, R, C = x.shape[0], x.shape[1], x.shape[-1]
    return B, R, math.prod(x.shape[2:]), C


def launch_shape(dtype: torch.dtype, row_elems: int, C: int):
    """(vec, threads) of a launch over rows of ``row_elems`` elements and
    C channels: 16-byte vectors where a row is a whole number of them,
    threads · vec a multiple of C, about ``THREADS`` threads."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if row_elems % vec or math.lcm(C, vec) > MAX_SLOTS:
        vec = 1
    base = math.lcm(C, vec) // vec
    if base * vec > MAX_SLOTS:
        raise ValueError(f"row moments take at most {MAX_SLOTS} channels, got {C}")
    return vec, base * max(1, THREADS // base)


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
    """Plain version of ``row_moments_kernel``: (Σx, Σx²) of each row of
    x [B, R, ..., C] in f32, [B, R, C] each."""
    B, R, E, C = _rows(x)
    xf = x.float().reshape(B, R, E // C, C)
    return _fold(xf), _fold(xf * xf)


def _row_moments_kernel(x: torch.Tensor):
    from ._build import load_kernels

    if x.dtype not in _DTYPES:
        raise TypeError(f"row moments on the card take {tuple(_DTYPES)}, got {x.dtype}")
    B, R, E, C = _rows(x)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    vec, threads = launch_shape(x.dtype, E, C)
    s1 = torch.empty((B, R, C), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    if B * R == 0:
        return s1, s2
    lib = load_kernels()
    # the launch goes to the current device: x's, on a band's own card
    with torch.cuda.device(x.device):
        rc = lib.posfeat_row_moments(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(s1.data_ptr()),
                                     ctypes.c_void_p(s2.data_ptr()), _DTYPES[x.dtype], B * R, E, C, vec, threads,
                                     ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    row_moments.launches += 1
    if rc != 0:
        raise RuntimeError(f"row moments launch failed ({rc}): {lib.posfeat_moments_error_string(rc).decode()}")
    return s1, s2


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
