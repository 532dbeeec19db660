"""Device resolution for the port's entry points."""

from __future__ import annotations

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
