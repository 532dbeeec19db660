"""The row-moments kernel (``row_moments_kernel``,
``row_moments_slots_kernel``): Σx and Σx² of each row of an NHWC map,
bound by its bytes: the map read once and [2, B, R, C] f32 written."""


def nbytes(B: int, R: int, row_elems: int, C: int, itemsize: int) -> float:
    return itemsize * B * R * row_elems + 4 * 2 * B * R * C


def head_norms(B: int, H: int, W: int, C: int, fused: bool, itemsize: int) -> list:
    """The bytes of each launch a batch of the head's instance norms: the
    fused head (K1, K2) normalises its trunk only; the reference dataflow
    its trunk, convimg, conv2 and score maps."""
    h, w = H // 4, W // 4
    trunk = nbytes(B, h, w * C, C, itemsize)
    if fused:
        return [trunk]
    return [trunk, nbytes(B, H, W * 64, 64, itemsize), nbytes(B, H, W * 128, 128, itemsize),
            nbytes(B, H, W, 1, itemsize)]
