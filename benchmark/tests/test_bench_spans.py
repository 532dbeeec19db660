"""The six readers of the program's span totals: seconds × 1e3 over the
count of the span that counts the window's batches or steps, and None
where the span or that count is absent (a program without spans)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# metric: (its span, the span that counts the window's units)
READERS = {
    "dispatch_ms_per_batch.extract": ("extract.dispatch", "extract.dispatch"),
    "card_wait_ms_per_batch.extract": ("extract.card_wait", "extract.dispatch"),
    "feed_wait_ms_per_batch.extract": ("extract.feed_wait", "extract.dispatch"),
    "forward_host_ms_per_step.train": ("train.forward", "train.forward"),
    "backward_host_ms_per_step.train": ("train.backward", "train.forward"),
    "guard_wait_ms_per_step.train": ("train.guard", "train.forward"),
}
TOTALS = {"extract.dispatch": (22, 5.5), "extract.card_wait": (24, 0.33), "extract.feed_wait": (352, 0.011),
          "train.forward": (8, 3.2), "train.backward": (8, 2.4), "train.guard": (8, 0.4),
          "model.backbone": (22, 1.0)}


@pytest.fixture()
def totals(monkeypatch):
    from posfeat_tpu_torch.core import profiling

    table = {}
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(table))
    return table


def test_every_reader_is_listed():
    spec = harness.load_spec()
    assert {m["name"] for m in spec["per_layer"] if m["source"] == "program_counter"
            and m["unit"] == "ms"} == set(READERS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_ms_per_unit(metric, totals):
    span, unit = READERS[metric]
    totals.update(TOTALS)
    value = harness.metric_module(metric).read(None)
    assert value == pytest.approx(TOTALS[span][1] * 1e3 / TOTALS[unit][0])


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_none_without_its_span_or_unit(metric, totals):
    span, unit = READERS[metric]
    mod = harness.metric_module(metric)
    assert mod.read(None) is None  # no span at all: a program without spans
    for gone in {span, unit}:
        totals.clear()
        totals.update({k: v for k, v in TOTALS.items() if k != gone})
        assert mod.read(None) is None, gone
    totals.clear()
    totals.update({**TOTALS, unit: (0, 0.0)})
    assert mod.read(None) is None


def test_reader_is_none_without_the_program_api(monkeypatch):
    """A program that predates the spans (no ``span_totals``) reads None
    and raises nothing."""
    from posfeat_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "span_totals")
    for metric in READERS:
        assert harness.metric_module(metric).read(None) is None
