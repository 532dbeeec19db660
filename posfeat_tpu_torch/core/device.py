"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the
    port never moves work to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        # The JAX reference runs f32 at Precision.HIGHEST. cuDNN convs
        # default to TF32 (about 3 decimal digits), so f32 work on the
        # card keeps both convs and matmuls in full f32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


# The autotune times cuDNN's first candidates in its heuristic's order. At
# the stage-2 step's shapes on an H100 the first three hold the head's trunk
# conv's direct kernel (2.7 ms a call against 380 ms on the heuristic's FFT
# pick) and cost a process's first step 4.6 s against 2.7 s; torch's default
# of ten cost 158.6 s, 137 s of it timing one backward conv on the head's
# 480x640 maps, for a 4% faster step (PERF.md §6).
AUTOTUNE_CANDIDATES = 3


@contextlib.contextmanager
def cudnn_autotune():
    """cuDNN's autotune (``torch.backends.cudnn.benchmark``) over its first
    ``AUTOTUNE_CANDIDATES`` candidates for the convs of the body: the first
    call of each conv shape in the process times them and keeps the
    fastest, later calls run it. Every other cuDNN flag, TF32 among them,
    stays as it is, and the prior values come back when the body returns
    or raises."""
    flags = torch.backends.cudnn
    saved = flags.benchmark, flags.benchmark_limit
    flags.benchmark, flags.benchmark_limit = True, AUTOTUNE_CANDIDATES
    try:
        yield
    finally:
        flags.benchmark, flags.benchmark_limit = saved
