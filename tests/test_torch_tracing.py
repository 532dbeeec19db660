"""posfeat_tpu_torch's host spans (``core/profiling.span``) on the CPU:
under a torch.profiler session the Extractor's batch loop, the Trainer's
step and the model record their named ranges in the Chrome trace and
their counts and host seconds in ``span_totals()``; with no session a
span opens no range and counts nothing; a span whose body raises still
closes and counts; the table survives many threads."""

import glob
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.core import profiling
from posfeat_tpu_torch.data.loader import collate
from posfeat_tpu_torch.extract import Extractor
from posfeat_tpu_torch.train import Trainer
from test_torch_extract import H, W, _config as _extract_config
from test_torch_train import _config as _train_config

BATCH = 2
IMAGES = 5  # two and a half batches: two full buckets, then the partial one


@pytest.fixture(scope="module")
def extractor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    cfg = _extract_config(tmp, "spans", tmp / "no_ckpt")
    cfg["data_config_extract"] = {"batch_size": BATCH, "workers": 2}
    rng = np.random.RandomState(3)
    images = [{"im1_ori": (rng.rand(H, W, 3) * 255).astype(np.uint8), "name1": f"seq/{i}.ppm"}
              for i in range(IMAGES)]
    return Extractor(cfg, ckpt_root=str(tmp), device="cpu", dataset=images)


@pytest.fixture()
def fresh_totals():
    profiling.reset_span_totals()
    yield
    profiling.reset_span_totals()


def _ranges(trace_dir) -> list:
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    return [e for e in json.load(open(files[0]))["traceEvents"] if e.get("cat") in ("cpu_op", "user_annotation")]


def test_extraction_records_its_spans(extractor, tmp_path, fresh_totals):
    t0 = time.perf_counter()
    with profiling.trace(str(tmp_path / "tr"), "cpu"):
        n, _ = extractor.extract()
    wall = time.perf_counter() - t0
    assert n == IMAGES
    totals = profiling.span_totals()
    batches = -(-IMAGES // BATCH)
    counts = {name: count for name, (count, _s) in totals.items()}
    assert counts["extract.dispatch"] == batches
    assert counts["extract.feed_wait"] == IMAGES
    assert counts["model.backbone"] == counts["model.head"] == batches
    # after each dispatch, then the last drain and the pools' shutdown
    assert counts["extract.card_wait"] == batches + 2
    assert set(counts) == {"extract.dispatch", "extract.feed_wait", "extract.card_wait", "model.backbone",
                           "model.head"}
    for name, (_count, seconds) in totals.items():
        assert 0 < seconds < wall, name
    main = sum(totals[k][1] for k in ("extract.dispatch", "extract.feed_wait", "extract.card_wait"))
    assert main < wall  # the main thread's spans do not overlap
    ranges = _ranges(tmp_path / "tr")
    assert {e["name"] for e in ranges} >= set(counts)
    seqs = [e["args"]["seq"] for e in sorted(ranges, key=lambda e: e["ts"]) if e["name"] == "extract.dispatch"]
    assert seqs == list(range(batches))


def test_trainer_step_records_its_spans(tmp_path, fresh_totals):
    tr = Trainer(_train_config(checkpoint_name="spans"), ckpt_root=str(tmp_path), device="cpu")
    batch = tr.to_device(collate([tr.train_dataset[i] for i in range(2)]))
    steps = 2
    with profiling.trace(str(tmp_path / "tr"), "cpu"):
        for _ in range(steps):
            tr.train_step(batch, 1)
    counts = {name: count for name, (count, _s) in profiling.span_totals().items()}
    assert counts == {"train.forward": steps, "train.backward": steps, "train.guard": steps,
                      "model.backbone": 2 * steps, "model.head": 2 * steps}  # two views a step
    seqs = [e["args"]["seq"] for e in sorted(_ranges(tmp_path / "tr"), key=lambda e: e["ts"])
            if e["name"] == "train.forward"]
    assert seqs == list(range(steps))


def test_no_profiler_no_range_no_count(extractor, tmp_path, monkeypatch, fresh_totals):
    def refuse(*_a, **_k):
        raise AssertionError("a range was opened with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)  # the spans' range opener
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b", seq=3)  # one shared no-op: nothing made
    n, _ = extractor.extract()
    tr = Trainer(_train_config(checkpoint_name="off"), ckpt_root=str(tmp_path), device="cpu")
    tr.train_step(tr.to_device(collate([tr.train_dataset[i] for i in range(2)])), 1)
    assert n == IMAGES and profiling.span_totals() == {}


def test_a_span_that_raises_closes_and_counts(fresh_totals):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with profiling.span("test.raises", seq=4):
                raise KeyError("from the body")
        with profiling.span("test.after"):
            pass
    totals = profiling.span_totals()
    assert totals["test.raises"][0] == 1 and totals["test.raises"][1] >= 0
    assert totals["test.after"][0] == 1
    names = [e.name for e in prof.events()]
    assert names.count("test.raises") == 1 and names.count("test.after") == 1


def test_reset_empties_the_table(fresh_totals):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("test.reset"):
                pass
    assert profiling.span_totals()["test.reset"][0] == 3
    copy = profiling.span_totals()
    profiling.reset_span_totals()
    assert profiling.span_totals() == {} and copy["test.reset"][0] == 3  # the copy is the caller's


def test_totals_lose_no_update_across_threads(monkeypatch, fresh_totals):
    """Many threads closing spans at once, the interpreter switching as
    often as it can: every count lands."""
    class NoRange:
        def __init__(self, *_a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_exc):
            return False

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", NoRange)
    threads, each = 16, 5000
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=60)
        for i in range(each):
            with profiling.span("test.threads", seq=i):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    count, seconds = profiling.span_totals()["test.threads"]
    assert count == threads * each and seconds > 0
