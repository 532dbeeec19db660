"""The row-moments kernel's launch plans (``ops/moments.py``
``launch_shape``, ``csrc/moments.cu``).

On the CPU: the plan is a function of a row's length, channels and dtype
alone (the same at any number of rows or batch).

On the card (marked ``gpu``; this file does not import JAX, so run it
with ``python -m pytest --noconftest -m gpu tests/test_torch_moments_plans.py``):
the kernel against ``row_moments_plain`` in every plan the launch takes,
each row split over 2, 3 and 4 parts bit for bit the whole map's, and
every thread count of the lane plan within the same limit.
"""

import pytest
import torch

from posfeat_tpu_torch.ops import moments as mo

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
DTYPE_IDS = ["f32", "bf16", "f16"]
# (pixels a row, channels): the one-channel score norms' rows of 640, 3072
# and 12288 elements; 64 and 128 channels in rows that take one warp, a few
# and 256 lanes; rows that take the slot plan (192, 7 and 520 channels, a
# row not of whole vectors)
ROWS = [(640, 1), (3072, 1), (12288, 1), (5, 64), (160, 64), (640, 64), (5, 128), (160, 128), (640, 128),
        (5, 192), (160, 192), (640, 192), (33, 7), (3, 520), (641, 1)]
ROW_IDS = [f"{w}x{c}" for w, c in ROWS]
# the kernel's per-row sums against the plain version's pairwise tree:
# within 1e-5 of each row-channel's sum of |x| (Σx) or of Σx² (chip_smoke.py
# MOMENTS_RTOL)
RTOL = 1e-5


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("row", ROWS, ids=ROW_IDS)
def test_plan_is_the_rows_alone(dtype, row):
    """The plan of a map [B, R, pixels, C] is the same at any B and R, and
    for the phase layout's inner dims of the same row length."""
    pixels, C = row
    plans = {mo.plan_of(torch.empty((B, R, pixels, C), dtype=dtype)) for B, R in ((1, 1), (2, 12), (16, 7), (1, 512))}
    assert plans == {mo.launch_shape(dtype, pixels * C, C)}
    if pixels % 4 == 0:
        assert mo.plan_of(torch.empty((3, 5, pixels // 4, 2, 2, C), dtype=dtype)) in plans


def _check(x, s1, s2):
    p1, p2 = mo.row_moments_plain(x)
    a1 = mo.row_moments_plain(x.abs())[0]
    assert ((s1 - p1).abs() <= RTOL * a1 + 1e-6).all(), ((s1 - p1).abs() / a1).max().item()
    assert ((s2 - p2).abs() <= RTOL * p2 + 1e-6).all(), ((s2 - p2).abs() / p2).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("row", ROWS, ids=ROW_IDS)
def test_kernel_matches_plain_and_splits_bit_for_bit(dtype, row):
    """Each plan on the card: within ``RTOL`` of the plain version; the
    partials of each row over 2, 3 and 4 splits of the rows, and of the
    batch alone, the whole map's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pixels, C = row
    g = torch.Generator(device="cuda").manual_seed(pixels * C)
    x = (torch.randn((2, 12, pixels, C), generator=g, device="cuda") * 2 + 0.5).to(dtype)
    n = mo.row_moments.launches
    s1, s2 = mo.row_moments(x)
    torch.cuda.synchronize()
    assert mo.row_moments.launches == n + 1
    _check(x, s1, s2)
    for k in (2, 3, 4):
        cuts = [12 * i // k for i in range(k)] + [12]
        parts = [mo.row_moments(x[:, a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        assert torch.equal(torch.cat([p[0] for p in parts], 1), s1), k
        assert torch.equal(torch.cat([p[1] for p in parts], 1), s2), k
    one = mo.row_moments(x[1:])
    assert torch.equal(one[0], s1[1:]) and torch.equal(one[1], s2[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("row", [(640, 1), (12288, 1), (160, 64), (160, 128)],
                         ids=["640x1", "12288x1", "160x64", "160x128"])
def test_every_lane_count_matches_plain(dtype, row, monkeypatch):
    """The lane plan at each of its thread counts, one warp to 512 lanes a
    row (the launch picks one of them by the row's length; here ``LANES``
    is narrowed to one count), within ``RTOL`` of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pixels, C = row
    g = torch.Generator(device="cuda").manual_seed(C)
    x = (torch.randn((3, 9, pixels, C), generator=g, device="cuda") * 2 + 0.5).to(dtype)
    assert mo.plan_of(x).lane
    for lanes in mo.LANES:
        monkeypatch.setattr(mo, "LANES", (lanes,))
        assert mo.plan_of(x).threads == lanes
        s1, s2 = mo.row_moments(x)
        torch.cuda.synchronize()
        _check(x, s1, s2)
        monkeypatch.undo()
