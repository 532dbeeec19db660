"""K1 (``conv_phase_kernel``): the fused head's trunk conv in phase
layout plus the image term, one launch a batch. M = B·h·w trunk cells,
N = 16·Cout phase channels, 9·C trunk taps plus KP image-patch columns."""

KP = 192  # the stride-4 8x8x3 image patches of the v3 dataflow


def ops(B: int, h: int, w: int, C: int, cout: int) -> float:
    return 2.0 * B * h * w * (16 * cout) * (9 * C + KP)


def nbytes(B: int, h: int, w: int, C: int, cout: int, itemsize: int = 2) -> float:
    """Each operand read once and each output written once: the padded
    trunk, the phase kernel, the patches, the per-image patch weights and
    z in the compute dtype; the bias and the per-tile moments in f32."""
    N = 16 * cout
    tiles = -(-h // 8) * -(-w // 16)
    operands = B * (h + 2) * (w + 2) * C + 9 * C * N + B * h * w * KP + B * KP * N + B * h * w * N
    return itemsize * operands + 4 * (B * N + 2 * B * tiles * N)
