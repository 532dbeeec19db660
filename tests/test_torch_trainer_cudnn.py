"""The Trainer's step runs its convs on cuDNN's autotune
(``core/device.py`` ``cudnn_autotune``), and only there: inside
``train_step``'s loss and backward ``torch.backends.cudnn.benchmark`` is
True over ``AUTOTUNE_CANDIDATES`` candidates while ``enabled`` and
``allow_tf32`` keep the caller's values; after the step, and after a step
whose loss or backward raises, all four are as before; an extraction outside a step sees the autotune off. The CPU
runs no cuDNN conv, so the flags are read where the card would read
them. The per-conv table of tools/profile_torch_train.py --convs gives
each conv call of a step the kernels it launched."""

import sys
from pathlib import Path

import pytest
import torch

from posfeat_tpu_torch.core.device import AUTOTUNE_CANDIDATES, cudnn_autotune
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.train import Trainer
from test_torch_train import _config as _train_config

CUDNN = torch.backends.cudnn
# (benchmark, benchmark_limit, allow_tf32) before the step: as resolve_device
# leaves them on the card (autotune and TF32 off, torch's limit), and a
# caller that had the autotune over every candidate and TF32 on
PRIORS = [(False, 10, False), (True, 0, True)]


def _flags() -> tuple:
    return CUDNN.benchmark, CUDNN.benchmark_limit, CUDNN.enabled, CUDNN.allow_tf32


def _inside(prior: tuple) -> tuple:
    return (True, AUTOTUNE_CANDIDATES) + prior[2:]


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tr = Trainer(_train_config(checkpoint_name="cudnn"), ckpt_root=str(tmp_path_factory.mktemp("cudnn")),
                 device="cpu")
    return tr, tr.to_device(collate([tr.train_dataset[i] for i in range(2)]))


@pytest.fixture(params=PRIORS, ids=["as_resolve_device", "caller_on"])
def prior(request, monkeypatch):
    benchmark, limit, tf32 = request.param
    monkeypatch.setattr(CUDNN, "benchmark", benchmark)
    monkeypatch.setattr(CUDNN, "benchmark_limit", limit)
    monkeypatch.setattr(CUDNN, "allow_tf32", tf32)
    return _flags()


def _probe(tr, seen: dict) -> list:
    """Record the flags at each forward of the head and at its first
    parameter's gradient in the backward."""
    head = tr.model.localheader

    def forward(*_a):
        seen["loss"].append(_flags())

    def backward(_grad):
        seen["backward"].append(_flags())

    return [head.register_forward_hook(forward), next(head.parameters()).register_hook(backward)]


def test_the_step_autotunes_its_loss_and_backward(trainer, prior):
    tr, batch = trainer
    seen = {"loss": [], "backward": []}
    handles = _probe(tr, seen)
    try:
        tr.train_step(batch, 1)
    finally:
        for h in handles:
            h.remove()
    inside = _inside(prior)
    assert seen["loss"] == [inside, inside]  # the head runs once a view
    assert seen["backward"] == [inside]
    assert _flags() == prior


@pytest.mark.parametrize("where", ["loss", "backward"])
def test_the_flags_come_back_when_the_step_raises(trainer, prior, where, monkeypatch):
    tr, batch = trainer
    seen = []

    def fail(*_a):
        seen.append(_flags())
        raise RuntimeError(f"planted in the {where}")

    if where == "loss":
        monkeypatch.setattr(tr, "loss", fail)
        handles = []
    else:
        handles = [next(tr.model.localheader.parameters()).register_hook(fail)]
    try:
        with pytest.raises(RuntimeError, match="planted"):
            tr.train_step(batch, 1)
    finally:
        for h in handles:
            h.remove()
    assert seen == [_inside(prior)]
    assert _flags() == prior


def test_extraction_outside_a_step_keeps_the_heuristic(trainer, monkeypatch):
    tr, batch = trainer
    monkeypatch.setattr(CUDNN, "benchmark", False)
    monkeypatch.setattr(CUDNN, "allow_tf32", False)
    tr.train_step(batch, 1)
    seen = []
    handle = tr.model.backbone.register_forward_hook(lambda *_a: seen.append(_flags()))
    try:
        tr.model.extract(batch["im1"])
    finally:
        handle.remove()
    assert [(b, tf32) for b, _limit, _enabled, tf32 in seen] == [(False, False)]


def test_cudnn_autotune_nests_and_restores(monkeypatch):
    monkeypatch.setattr(CUDNN, "benchmark", False)
    monkeypatch.setattr(CUDNN, "benchmark_limit", 10)
    with cudnn_autotune():
        with cudnn_autotune():
            assert (CUDNN.benchmark, CUDNN.benchmark_limit) == (True, AUTOTUNE_CANDIDATES)
        assert (CUDNN.benchmark, CUDNN.benchmark_limit) == (True, AUTOTUNE_CANDIDATES)
    assert (CUDNN.benchmark, CUDNN.benchmark_limit) == (False, 10)


def _step_events(t0: int, corr: int, fwd_us: tuple, bwd_us: float) -> list:
    """One profiled step of tools/profile_torch_train.py --convs: a forward
    conv in the head's span on the main thread launching ``fwd_us``
    kernels (one through the CUDA runtime API, the rest through the CUDA
    driver API), a launch outside any conv, and a backward conv on
    autograd's thread."""
    conv = {"Input Dims": [[6, 160, 480, 640], [128, 160, 3, 3], [], [], [], [], [], [], []],
            "Concrete Inputs": ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]}
    back = {"Input Dims": [[6, 128, 480, 640], [6, 160, 480, 640], [128, 160, 3, 3]] + [[]] * 8,
            "Concrete Inputs": ["", "", "", "[128]", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1",
                                "[False, True, True]"]}
    ev = [{"cat": "user_annotation", "name": "convs.step", "ts": t0, "dur": 900, "tid": 1},
          {"cat": "cpu_op", "name": "model.head", "ts": t0 + 10, "dur": 300, "tid": 1},
          {"cat": "cpu_op", "name": "aten::convolution", "ts": t0 + 20, "dur": 100, "tid": 1, "args": conv},
          {"cat": "cpu_op", "name": "aten::convolution_backward", "ts": t0 + 500, "dur": 100, "tid": 2,
           "args": back}]
    launches = [(t0 + 30, 1, "cuda_runtime", "implicit_gemm", fwd_us[0])]
    launches += [(t0 + 31 + i, 1, "cuda_driver", "fft_cf32", us) for i, us in enumerate(fwd_us[1:])]
    launches += [(t0 + 400, 1, "cuda_runtime", "elementwise", 7.0),  # outside every conv
                 (t0 + 550, 2, "cuda_driver", "wgrad", bwd_us)]
    for i, (ts, tid, cat, name, us) in enumerate(launches):
        ev.append({"cat": cat, "name": "launch", "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr + i}})
        ev.append({"cat": "kernel", "name": name, "ts": ts + 50, "dur": us, "tid": 7,
                   "args": {"correlation": corr + i}})
    return ev


def test_the_profile_tool_gives_each_conv_call_its_kernels():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from profile_torch_train import conv_rows

    events = _step_events(0, 100, (10.0, 30.0, 30.0), 40.0) + _step_events(1000, 200, (20.0, 50.0, 50.0), 60.0)
    fwd, bwd = conv_rows(events, 2)
    assert (fwd["pass"], fwd["module"], fwd["input"], fwd["weight"], fwd["stride"], fwd["padding"]) == \
        ("fwd", "head", [6, 160, 480, 640], [128, 160, 3, 3], "[1, 1]", "[1, 1]")
    assert fwd["launches"] == 3 and fwd["device_ms"] == pytest.approx(0.095)
    assert fwd["top_kernel"] == "fft_cf32" and fwd["top_share"] == pytest.approx(160 / 190)
    assert (bwd["pass"], bwd["module"], bwd["input"], bwd["weight"], bwd["padding"]) == \
        ("bwd", "", [6, 160, 480, 640], [128, 160, 3, 3], "[1, 1]")
    assert bwd["launches"] == 1 and bwd["device_ms"] == pytest.approx(0.05)
    with pytest.raises(RuntimeError, match="ranges"):
        conv_rows(events, 3)
