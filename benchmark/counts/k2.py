"""K2 (``head_tail_kernel``): the head's tail on z, one launch a batch;
bound by the bytes of z."""

BLOCKS = 1024  # about this many blocks in all (the wrapper's plan)
MIN_ROWS = 256  # at least this many phase rows a block


def _partials(B: int, rows_per_image: int) -> int:
    per_image = max(1, min(-(-BLOCKS // B), rows_per_image // MIN_ROWS))
    rows = -(-rows_per_image // per_image)
    return -(-rows_per_image // rows)


def ops(B: int, h: int, w: int, cout: int, out_ch: int = 1) -> float:
    return B * h * w * 16 * cout * (3.0 + 2 * out_ch)


def nbytes(B: int, h: int, w: int, cout: int, out_ch: int = 1, itemsize: int = 2) -> float:
    """z in the compute dtype; the IN statistics, the slope, w3, b3, the
    score and its per-block moments in f32."""
    R = h * w * 16
    z = B * R * cout
    f32 = 2 * B * cout + 1 + cout * out_ch + out_ch + B * R * out_ch + 2 * B * _partials(B, R) * out_ch
    return itemsize * z + 4 * f32
