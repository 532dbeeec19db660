"""``correct`` comes out false when the timed path is broken underneath,
and when the control (the reference at the configuration's control
precision) stands in the program's place: each cell's run driven on the
CPU at a small size, past the harness's look for a card, with the
cell's own limits."""

import copy
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, run  # noqa: E402

EXTRACT_CELLS = ("r50-f32.extract-480x640",)
TRAIN_CELL = "r50-f32.train-kp-480x640"
CPU = torch.device("cpu")
WINDOW_S = 5.0  # some batches even on a loaded CPU


def _ctx(cell_name, seed=2**31 + 5):
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, cell_name)
    tr = copy.deepcopy(harness.traffic_of(cell))
    if tr["job"] == "extract":
        tr.update(height=96, width=128, batch_size=2, pool_images=4, warmup_batches=1, check_images=2)
        tr["detector_config"]["num_pts"] = 256
    else:
        tr.update(height=64, width=96, batch_size=2, pool_batches=4)
    return spec, harness.Context(cell_name, seed, CPU, harness.config_of(spec, cell), tr, tempfile.mkdtemp())


def _correct(cell_name) -> bool:
    spec, ctx = _ctx(cell_name)
    result, _rows = run.execute(ctx, spec, WINDOW_S, False, time.perf_counter())
    return result["correct"]


@pytest.mark.parametrize("cell", EXTRACT_CELLS + (TRAIN_CELL,))
def test_sound_run_is_correct(cell):
    assert _correct(cell)


@pytest.mark.parametrize("cell", EXTRACT_CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    """Two points' descriptors swapped where the sampler makes them."""
    from posfeat_tpu_torch.extract import extractor

    sample = extractor.sample_feat_by_coord

    def swapped(*args, **kwargs):
        out = sample(*args, **kwargs).clone()
        out[:, [0, 1]] = out[:, [1, 0]]
        return out

    monkeypatch.setattr(extractor, "sample_feat_by_coord", swapped)
    assert not _correct(cell)


@pytest.mark.parametrize("cell", EXTRACT_CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    """The program runs the first half of each batch and hands its slates
    out for the other half too."""
    from posfeat_tpu_torch.extract.extractor import Extractor

    learned = Extractor._learned_fn

    def halved(self, shape, key):
        program = learned(self, shape, key)

        def run_half(im_u8):
            h = max(1, im_u8.shape[0] // 2)
            out = program(im_u8[:h])
            return tuple(torch.cat([t] * (im_u8.shape[0] // h) + [t[: im_u8.shape[0] % h]]) for t in out)

        return run_half

    monkeypatch.setattr(Extractor, "_learned_fn", halved)
    assert not _correct(cell)


@pytest.mark.parametrize("cell", EXTRACT_CELLS)
def test_control_fails(cell):
    spec, ctx = _ctx(cell)
    job = harness.job_module(ctx.traffic).Job(ctx)
    job.setup()
    limits = harness.limits_of(harness.cell_entry(spec, cell))
    for read in job.controls().values():
        correct, _rows = harness.judge(read(), limits)
        assert not correct


def test_training_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    assert not _correct(TRAIN_CELL)


def _in_the_window_only(monkeypatch, plant):
    """Call ``plant(job)`` as the window opens, after set-up's checked
    steps."""
    from benchmark.jobs import train_kp

    window = train_kp.Job.window

    def planted(self, seconds):
        plant(self)
        return window(self, seconds)

    monkeypatch.setattr(train_kp.Job, "window", planted)


def test_training_window_state_left_unchanged(monkeypatch):
    """A step that returns its state unchanged in the window alone (the
    optimizer's own step, which the scheduler has wrapped)."""
    _in_the_window_only(monkeypatch, lambda job: monkeypatch.setattr(
        job.trainer.optimizers["localheader"], "step", lambda closure=None: None))
    assert not _correct(TRAIN_CELL)


def test_training_window_loss_altered(monkeypatch):
    """The loss doubled where it is produced, in the window alone."""
    from posfeat_tpu_torch.train.trainer import Trainer

    loss = Trainer.loss

    def doubled(self, batch, epoch, draws=None, preprocess_draws=None):
        total, comps = loss(self, batch, epoch, draws, preprocess_draws)
        return 2 * total, comps

    _in_the_window_only(monkeypatch, lambda job: monkeypatch.setattr(Trainer, "loss", doubled))
    assert not _correct(TRAIN_CELL)


def test_training_half_the_batch_left_out(monkeypatch):
    """The loss of the first half of each batch, doubled: the mean taken
    over the rest."""
    from posfeat_tpu_torch.train.trainer import Trainer

    loss = Trainer.loss

    def halved(self, batch, epoch, draws=None, preprocess_draws=None):
        h = batch["im1"].shape[0] // 2
        half = {k: v[:h] for k, v in batch.items()}
        hd = tuple((p[:h], a[:h]) for p, a in draws)
        total, comps = loss(self, half, epoch, hd, preprocess_draws)
        return 2 * total, comps

    monkeypatch.setattr(Trainer, "loss", halved)
    assert not _correct(TRAIN_CELL)


def test_training_control_fails():
    spec, ctx = _ctx(TRAIN_CELL)
    job = harness.job_module(ctx.traffic).Job(ctx)
    job.setup()
    limits = harness.limits_of(harness.cell_entry(spec, TRAIN_CELL))
    for name, read in job.controls().items():
        correct, _rows = harness.judge(read(), limits)
        assert not correct, name
