"""posfeat_tpu_torch's launcher (train/launch.py) on the CPU: training
over several local devices from one command, as the JAX trainer's
single-process data-parallel mesh (posfeat_tpu/train/trainer.py:99-125).

Two gloo ranks on ``["cpu", "cpu"]``, fed from the launcher's one loader,
take ``Trainer.train``'s steps of the one-process run of the same config
on the global batch: stage 2 on a dataset that filters pairs at known
indices (so per-rank index streams would compose other batches) and
stage 1 (BatchNorm on the global batch's moments), both on SyntheticPairs
at the small config, 2 steps, held at tests/test_torch_multihost.py's
tolerance, rtol 1e-3 / atol 2e-4 (stage 1's backbone update, as its
gradient there, at an atol of 2e-4 × its largest entry). Stage 1 steps
with SGD here, whose update is its gradient's multiple (Adam's first
steps move every entry by about its rate whatever the gradient's size,
so rounding flips the sign of the tiny ones); its loss is
configs/train_desc.yaml's without ``use_std_as_weight``
(tests/test_torch_multihost.py says why).

Also: the device-count rule against JAX's, the refusal of a
``multihost:`` config, no quiet fall back to the CPU without a card, and
the CLI's dispatch.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.data.synthetic import SyntheticPairs
from posfeat_tpu_torch.train import Trainer
from posfeat_tpu_torch.train import launch as launch_mod
from test_torch_stage1_train import EPIPOLAR, _stage1_config
from test_torch_train import _config as _stage2_config

RTOL, ATOL = 1e-3, 2e-4
DEVICES = ["cpu", "cpu"]
FILTERED = (1, 4)  # indices whose pairs the dataset drops
LR1 = 0.05  # stage 1's SGD rate


class FilteringPairs(SyntheticPairs):
    """SyntheticPairs whose pairs at ``FILTERED`` are filtered out (None),
    as MegaDepth_SIFT drops pairs that decoding finds unusable."""

    def __getitem__(self, i):
        return None if i in FILTERED else super().__getitem__(i)


def _configs():
    kp = _stage2_config(checkpoint_name="kp")
    kp["data_config_train"]["num_pairs"] = 8
    # stage 1: two epochs of one step, so that epoch 1's checkpoint holds the first update
    desc = _stage1_config(checkpoint_name="desc", optimizer="SGD", optimal_lrs=[LR1], epoch=2, epoch_step=1,
                          EpipolarLoss_full_config={**EPIPOLAR, "use_std_as_weight": False})
    return {"kp": kp, "desc": desc}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each stage launched over two CPU ranks and run in one process; the
    launches run while this process trains the references."""
    tmp = tmp_path_factory.mktemp("launch")
    cfgs = _configs()
    datasets = {"kp": lambda: FilteringPairs(cfgs["kp"]["data_config_train"]), "desc": lambda: None}
    plans, errors = {}, []

    def launched():
        try:
            for name, cfg in cfgs.items():
                plans[name] = launch_mod.launch(cfg, devices=DEVICES, ckpt_root=str(tmp / "two"),
                                                dataset=datasets[name]())
        except Exception as e:  # surfaced on the test's thread
            errors.append(e)

    worker = threading.Thread(target=launched)
    worker.start()
    try:
        for name, cfg in cfgs.items():
            Trainer(cfg, ckpt_root=str(tmp / "one"), device="cpu", dataset=datasets[name]()).train()
    finally:
        worker.join()
    if errors:
        raise errors[0]
    return tmp, plans


def _state(root, name, module, epoch="001"):
    return torch.load(os.path.join(root, name, epoch, f"{module}.pth"), weights_only=True)


def _metrics(root, name):
    return [json.loads(x) for x in open(os.path.join(root, name, "metrics.jsonl"))]


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


@pytest.mark.parametrize("name, module", [("kp", "localheader"), ("desc", "backbone")])
def test_launched_run_takes_the_one_process_steps(runs, name, module):
    """Every logged loss, component and gradient norm of 2 steps, and the
    trained module (stage 2 after both steps; stage 1 after its first, and
    its BatchNorm running statistics after both) against the one-process
    run's; the launcher's plan and the run's files."""
    tmp, plans = runs
    ranks = plans[name].pop("ranks")
    assert plans[name] == {"devices": DEVICES, "of": 2, "backend": "gloo"}
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:  # on the CPU the kernels' plain versions run, and no kernel is launched
        assert r["seconds"] > 0 and set(r["launches"].values()) == {0}, r
    one, two = tmp / "one", tmp / "two"
    m1, m2 = _metrics(one, name), _metrics(two, name)
    assert [r["global_step"] for r in m2] == [r["global_step"] for r in m1] == [1, 2]
    assert {"grad_norm/" + module, "total_loss"} <= set(m1[0])
    for a, b in zip(m2, m1):
        for k, v in b.items():
            if k == "total_loss" or not (k.startswith(("step_time", "sec_per")) or k in ("epoch", "global_step")):
                _close(a[k], v, f"{name} step {b['global_step']} {k}")
    got, want = _state(two, name, module), _state(one, name, module)
    before = _state(one, name, module, "000")
    before_two = _state(two, name, module, "000")
    assert set(got) == set(want) and all(torch.equal(before[k], before_two[k]) for k in got)
    for k in want:
        if "num_batches" in k:
            assert int(got[k]) == int(want[k]), k
        elif name == "desc" and "running" not in k:
            # the backbone's first update, SGD's multiple of the gradient, as
            # tests/test_torch_multihost.py holds the gradient: at atol scaled
            # by its largest entry; the conv biases before BatchNorm, whose
            # gradient is 0 up to rounding, within 1e-6 of the gradient's norm
            d_got, d_want = (got[k] - before[k]).numpy(), (want[k] - before[k]).numpy()
            if k.endswith("conv.bias"):
                bound = LR1 * 1e-6 * m1[0]["grad_norm/backbone"]
                assert np.abs(d_got).max() <= bound and np.abs(d_want).max() <= bound, k
            else:
                np.testing.assert_allclose(d_got, d_want, rtol=RTOL, atol=ATOL * np.abs(d_want).max(), err_msg=k)
        else:
            _close(got[k], want[k], f"{name} {k}")
    if name == "desc":
        # after the second step, the running statistics; the backbone's
        # second update reads maps that step 1's rounding moved, where the
        # line search's argmax flips for a few queries (PERF.md §6), so
        # it is held by the logged loss and gradient norm above
        got2, want2 = _state(two, name, module, "002"), _state(one, name, module, "002")
        for k in want2:
            if "running" in k:
                _close(got2[k], want2[k], f"{name} step 2 {k}")
    moved = [k for k in want if want[k].is_floating_point() and not torch.equal(want[k], before[k])]
    assert moved, "the one-process run did not train"
    if name == "desc":
        assert any("running" in k for k in moved)
    # rank 0 alone wrote the run, without the launcher's process group in its config
    names = set(os.listdir(two / name))
    assert {"config.yaml", "logging_file.txt", "logging_file.proc1.txt", "000", "001"} <= names, names
    assert not any(n.startswith("logging_file.proc0") for n in names)
    assert "multihost" not in (two / name / "config.yaml").read_text()
    # each rank's wait for its batches
    times = [json.loads(x) for x in open(two / name / "step_times.jsonl")]
    assert sorted((t["rank"], t["step"]) for t in times) == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert all(t["data_wait_s"] >= 0 for t in times)


@pytest.mark.parametrize("batch_size", range(1, 17))
def test_device_count_follows_jax(batch_size):
    """The largest count of 8 devices that divides the batch, as the JAX
    trainer picks it (posfeat_tpu/train/trainer.py:118-122)."""
    n = 8
    while batch_size % n:
        n -= 1
    assert launch_mod.data_parallel_count(batch_size, 8) == n


def test_multihost_config_and_no_card_are_refused(monkeypatch, tmp_path):
    """A config with ``multihost:`` (the multi-host path) is refused, and
    with no card and no devices given the launcher raises instead of
    training on the CPU; neither starts a rank or writes a run."""
    started = []
    monkeypatch.setattr(launch_mod.Trainer, "__init__", lambda *a, **k: started.append(a))
    cfg = _stage2_config()
    with pytest.raises(ValueError, match="multihost: block"):
        launch_mod.launch({**cfg, "multihost": {"num_processes": 2}}, devices=DEVICES, ckpt_root=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_mod.launch(cfg, ckpt_root=str(tmp_path))
    assert started == [] and not os.listdir(tmp_path)


def test_failed_rank_ends_the_run(tmp_path):
    """A rank that raises ends the launch with an error naming it, and no
    rank process is left running."""
    import multiprocessing

    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0, 1\] failed|rank\(s\) \[[01]\] failed"):
        launch_mod.launch(_stage2_config(optimizer="Bogus"), devices=DEVICES, ckpt_root=str(tmp_path))
    assert not multiprocessing.active_children()


def test_cli_dispatch(monkeypatch, tmp_path):
    """``--device`` trains in one process; without it the launcher spreads
    the batch over ``--devices`` (every visible card by default); a
    ``multihost:`` config runs as one rank of its multi-host run."""
    import yaml

    from posfeat_tpu_torch.train import __main__ as cli

    calls = []
    monkeypatch.setattr(cli, "Trainer", lambda cfg, overwrite, device: calls.append(("one", device)) or
                        type("T", (), {"train": lambda self: None})())
    monkeypatch.setattr(cli, "launch", lambda cfg, devices, overwrite: calls.append(("launch", devices)))
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(_stage2_config()))
    cli.main(["--config", str(path), "--device", "cpu"])
    cli.main(["--config", str(path)])
    cli.main(["--config", str(path), "--devices", "cuda:0,cuda:1"])
    path.write_text(yaml.safe_dump({**_stage2_config(), "multihost": {"num_processes": 2}}))
    cli.main(["--config", str(path)])
    assert calls == [("one", "cpu"), ("launch", None), ("launch", ["cuda:0", "cuda:1"]), ("one", None)]
