"""The plain reference of the flagship PoSFeat in float32 PyTorch,
written from the published architecture and the reference code's
semantics. It imports nothing of posfeat_tpu_torch and takes nothing the
program made: the benchmark hands both the same weights and inputs.

``PRECISIONS`` rounds every convolution's and product's operands to a
lower precision: the controls, which stand in the program's place to
show that the comparison fails a run computed below the configuration's
stated precision."""

import torch


def full_f32() -> None:
    """Keep float32 convolutions and products out of TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
