"""Sharded extraction with posfeat_tpu_torch on the CPU, as
tests/test_multihost_extract.py holds the JAX package's: two processes
(tools/multihost_torch.py) extract disjoint shards of 8 images into one
output_root, with one name list per shard and each feature file once;
the FileExistsError check applies to single-shard runs only; a
shard_index outside [0, num_shards) raises."""

import os
import sys

import cv2
import numpy as np
import pytest

from posfeat_tpu.data.synthetic import _texture
from posfeat_tpu_torch.extract import Extractor
from test_torch_extract import H, W, _config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import multihost_torch  # noqa: E402


def _hpatches(root, rng, n_seq=2, n_img=4):
    for s in range(n_seq):
        seq = root / f"i_{s}"
        seq.mkdir(parents=True)
        for i in range(n_img):
            cv2.imwrite(str(seq / f"{i + 1}.ppm"), cv2.cvtColor(_texture(rng, H, W), cv2.COLOR_RGB2BGR))
    return sorted(f"i_{s}/{i + 1}.ppm" for s in range(n_seq) for i in range(n_img))


def test_two_process_extraction_shards(tmp_path):
    names = _hpatches(tmp_path / "hp", np.random.RandomState(0))
    cfg = _config(tmp_path, "mh", tmp_path / "none")
    spec = {"world": 2, "device": "cpu", "out": str(tmp_path / "run"),
            "jobs": [{"kind": "extract", "name": "ex", "config": cfg}]}
    rcs, outs, _ = multihost_torch.launch(spec, 180)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0 and f"RANK_OK {r}" in out, f"shard {r} failed ({rc}):\n{out[-4000:]}"
    root = tmp_path / "run" / "ckpts" / "ex_mh"
    lists = {}
    for i in range(2):
        lines = (root / "image" / f"name_list.shard{i}.txt").read_text().splitlines()
        lists[i] = [line.split(" ", 1)[1] for line in lines]
        assert lists[i] == names[i::2]  # image i, i + 2, ... of the sorted list
    assert not (root / "image" / "name_list.txt").exists()
    assert sorted(lists[0] + lists[1]) == names  # disjoint and complete
    written = sorted(os.path.relpath(os.path.join(d, f), root / "desc")
                     for d, _, fs in os.walk(root / "desc") for f in fs)
    assert written == [n + ".pf" for n in names]
    for n in names:
        f = np.load(root / "desc" / (n + ".pf"))
        assert f["keypoints"].shape[0] >= 128 and f["descriptors"].dtype == np.float32
    assert (root / "config.yaml").exists() and (root / "logging_file.txt").exists()

    # the shards share output_root: a multi-shard run into it goes ahead, a
    # single-shard one stops unless resume: True
    shard = _config(tmp_path, "mh", tmp_path / "none")
    shard["data_config_extract"].update(num_shards=2, shard_index=1)
    Extractor(shard, ckpt_root=str(tmp_path / "run" / "ckpts"), device="cpu", dataset=[])
    with pytest.raises(FileExistsError):
        Extractor(cfg, ckpt_root=str(tmp_path / "run" / "ckpts"), device="cpu", dataset=[])


@pytest.mark.parametrize("index", [-1, 2])
def test_shard_index_out_of_range_raises(tmp_path, index):
    cfg = _config(tmp_path, f"bad{index}", tmp_path / "none")
    cfg["data_config_extract"].update(num_shards=2, shard_index=index)
    with pytest.raises(ValueError, match="shard_index"):
        Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu", dataset=[])
    from posfeat_tpu_torch.data import DATASETS

    with pytest.raises(ValueError, match="shard_index"):
        DATASETS["HPatch_SIFT"]({**cfg["data_config_extract"], "data_path": str(tmp_path)})
