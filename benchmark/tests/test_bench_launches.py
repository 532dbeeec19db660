"""``launches_per_step.train`` counts every kernel of the traced window
over the window's steps, and reads nothing where the window made none."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.trace import Records  # noqa: E402


def _read(kernels, units):
    rec = Records([(name, 0.0, 1.0, layer) for name, layer in kernels], {}, 1.0, 0.5,
                  {"units": units, "batch": 6})
    return harness.metric_module("launches_per_step.train").read(rec)


def test_the_count_over_the_steps():
    kernels = [("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n", "localheader")] * 9 + [("lse_pass_kernel", "")] * 3
    assert _read(kernels, 18) == pytest.approx(4.0)  # 12 launches in 3 steps of 6 pairs


def test_no_steps_no_reading():
    assert _read([("lse_pass_kernel", "")], 0) is None
