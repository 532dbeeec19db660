"""The row-moments kernel on a map that lies on another card than the
current one, as the H-banded program's bands do: the launch must go to
the map's own card and stream. Needs two CUDA cards; run on such a
machine with ``python -m pytest tests/test_torch_moments_cards.py -m gpu``.
"""

import pytest
import torch

from posfeat_tpu_torch.ops import moments as mo


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_row_moments_launch_on_the_maps_card(dtype):
    """On every card but the current cuda:0, a map written just after a
    spin of that card's stream: its partials equal cuda:0's bit for bit
    (a launch on cuda:0's stream would read the map before it is
    written)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    g = torch.Generator(device="cuda:0").manual_seed(0)
    x0 = torch.randn((2, 96, 128, 64), generator=g, device="cuda:0").to(dtype)
    want = [s.cpu() for s in mo.row_moments(x0)]
    for i in range(1, torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        x1 = x0.to(dev)
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            torch.cuda._sleep(200_000_000)  # this card's stream busy for about 0.1 s
        x = x1 * 1
        n = mo.row_moments.launches
        got = mo.row_moments(x)
        assert mo.row_moments.launches == n + 1
        assert all(s.device == dev for s in got)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), i
