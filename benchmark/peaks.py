"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

PEAK_FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores
}
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def bound_s(ops: float, peak_flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES_PER_S)
