"""The FLOP and byte counts reproduce the kernel table's bounds at the
flagship point (B = 16, 120×160, Cin 192, Cout 128; B = 6, m = n = 4800,
D = 128), and the model's count adds up."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import peaks  # noqa: E402
from benchmark.counts import k1, k2, model, moments, reinforce  # noqa: E402


def ms(ops, peak, nbytes):
    return 1e3 * peaks.bound_s(ops, peak, nbytes)


def test_k1_bound():
    assert ms(k1.ops(16, 120, 160, 192, 128), peaks.PEAK_FLOPS["bfloat16"], k1.nbytes(16, 120, 160, 192, 128)) == \
        pytest.approx(2.4428, abs=5e-5)


def test_k2_bound():
    assert ms(k2.ops(16, 120, 160, 128), peaks.PEAK_FLOPS["float32"], k2.nbytes(16, 120, 160, 128)) == \
        pytest.approx(0.3815, abs=5e-5)


def test_k4_to_k6_bound():
    assert ms(reinforce.pass_ops(6, 4800, 4800, 128), peaks.PEAK_FLOPS["tf32"], 0) == pytest.approx(0.2145, abs=5e-5)


def test_moments_bound_of_the_trunk_norm():
    # the kernel table's row M: 0.0361 ms at 16×120×160×192 bf16
    (trunk,) = moments.head_norms(16, 480, 640, 192, True, 2)
    assert 1e3 * trunk / peaks.PEAK_BYTES_PER_S == pytest.approx(0.0361, abs=5e-5)
    assert len(moments.head_norms(16, 480, 640, 192, False, 4)) == 4


def test_model_flops():
    cfg = {"backbone_config": {"encoder": "resnet50", "coarse_out_ch": 128, "fine_out_ch": 128},
           "localheader_config": {"in_channels": 192}}
    head = model.head_convs(480, 640, 192)
    # conv2's trunk half alone is 136 GFLOP; its image half and the decoder add the rest
    assert model.conv_flops(480, 640, 192, 128, 3) == pytest.approx(135.9e9, rel=1e-3)
    assert head["conv2"] == pytest.approx(181.2e9, rel=1e-3)
    assert model.extract_flops(480, 640, cfg) == pytest.approx(417.98e9, rel=1e-4)
    step = model.train_kp_flops(480, 640, cfg, 6, 4800, 4800, 128)
    assert step > 12 * model.extract_flops(480, 640, cfg)


def _records(kernels, spans, info):
    from benchmark.trace import Records

    return Records([(n, 0.0, d, layer) for n, d, layer in kernels], spans, 1.0, 0.5, info)


def _read(name, rec):
    from benchmark import harness

    return harness.metric_module(name).read(rec)


EXTRACT_INFO = {"batch": 16, "height": 480, "width": 640, "in_channels": 192, "itemsize": 2, "fused_head": True,
                "units": 60, "flops_per_unit": 4e11, "peak_flops": 989e12, "window_peak_bytes": 2**30}


def test_moments_reader_needs_the_heads_launches():
    one = 1e3 * 0.0361
    rec = _records([("row_moments_slots_kernel<...>", one, "localheader")] * 2, {"localheader": 2}, EXTRACT_INFO)
    assert _read("moments_roofline.extract", rec) == pytest.approx(100.0, rel=2e-3)
    rec = _records([("row_moments_kernel<...>", one, "localheader")] * 3, {"localheader": 2}, EXTRACT_INFO)
    assert _read("moments_roofline.extract", rec) is None


def test_reduction_readers():
    info = {"batch": 6, "m": 4800, "n": 4800, "D": 128}
    rec = _records([("lse_split_kernel", 100.0, ""), ("lse_pass_kernel", 114.5, ""),
                    ("reward_pass_kernel", 429.0, "")], {}, info)
    assert _read("lse_roofline.train", rec) == pytest.approx(100.0, rel=1e-3)
    assert _read("reward_roofline.train", rec) == pytest.approx(50.0, rel=1e-3)


def test_layer_and_device_readers():
    rec = _records([("a", 3000.0, "backbone"), ("b", 1000.0, "localheader"), ("c", 500.0, "")],
                   {"backbone": 2, "localheader": 2}, EXTRACT_INFO)
    assert _read("backbone_ms_per_image.extract", rec) == pytest.approx(3.0 / 32)
    assert _read("head_ms_per_image.extract", rec) == pytest.approx(1.0 / 32)
    assert _read("device_idle_pct.extract", rec) == pytest.approx(50.0)
    assert _read("peak_mem_gib.extract", rec) == pytest.approx(1.0)
    assert _read("mfu.extract", rec) == pytest.approx(100 * 60 * 4e11 / 989e12)
