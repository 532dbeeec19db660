"""Operand rounding for the controls: TF32 (10 mantissa bits, rounded to
nearest with ties away from zero, as the card's cvt.rna.tf32.f32), the
precision below the float32 that the configuration states. The rounding
passes the gradient straight through, so a control trains as the
rounded forward dictates."""

import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


_ROUND = {"tf32": _tf32}
PRECISIONS = tuple(_ROUND)


def rounder(precision):
    """None for float32, else the operand rounding of ``precision``."""
    if precision is None:
        return None
    fn = _ROUND[precision]

    def q(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = fn(x)
        return x + (r - x).detach() if x.requires_grad else r

    return q
