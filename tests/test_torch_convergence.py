"""The port's proof that it learns: tests/test_training_convergence.py's
regime and assertions for posfeat_tpu_torch, through
tools/convergence_experiment_torch.py.

Stage 1 (500 steps, lr 3e-4, 512 distinct pairs, rotation 20, scale 0.18,
photometric 1.15, grid and window terms) from random init, then stage 2
(250 steps) on its checkpoint, on the card. Its margins are the JAX
test's: stage 1 raises SIFT-keypoint MMA@3 by 0.03 and MMA@1 by 0.02;
stage 2 raises n_pairs, lowers the REINFORCE objective and raises the
learned detector's MMA@3 by 0.03 over the untrained head. It needs
tests/conftest.py's JAX no more than the port does:

    POSFEAT_RUN_CONVERGENCE=1 python -m pytest --noconftest tests/test_torch_convergence.py -x -q -s

``test_stage1_from_the_jax_init`` needs JAX (run it on the CPU, with the
conftest): the port's stage 1 started from the JAX package's seed-0
initial weights, which tests/test_training_convergence.py trains from,
held to the same stage-1 margins. It separates the start from the
training when the two packages' proofs differ.
"""

import json
import os
import sys

import pytest

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        os.environ.get("POSFEAT_RUN_CONVERGENCE") != "1",
        reason="a training run of minutes on the card; set POSFEAT_RUN_CONVERGENCE=1",
    ),
]


def test_two_stage_training_improves_matching(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import convergence_experiment_torch as ce

    rec = ce.run(str(tmp_path), steps=500, rot=20.0, scale=0.18, photo=1.15, lr1=3e-4, pairs=512)
    print("convergence record:", json.dumps(rec))
    assert rec["mma3_sift_stage1"] >= rec["mma3_sift_random_init"] + 0.03, rec
    assert rec["mma1_sift_stage1"] >= rec["mma1_sift_random_init"] + 0.02, rec
    assert rec["n_pairs_last"] > rec["n_pairs_first"], rec
    assert rec["reinforce_last"] < rec["reinforce_first"], rec
    assert rec["mma3_learned_stage2"] >= rec["mma3_learned_stage1"] + 0.03, rec


def test_stage1_from_the_jax_init(tmp_path):
    pytest.importorskip("jax")
    from torch_port_helpers import write_jax_init

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import convergence_experiment_torch as ce

    init = write_jax_init(str(tmp_path / "jax_init" / "000"), ce.MODEL_CONFIG, seed=0)
    rec = ce.run(str(tmp_path), steps=500, rot=20.0, scale=0.18, photo=1.15, lr1=3e-4, pairs=512,
                 device="cpu", init=init, stage2=False)
    print("convergence record from the JAX init:", json.dumps(rec))
    assert rec["mma3_sift_stage1"] >= rec["mma3_sift_random_init"] + 0.03, rec
    assert rec["mma1_sift_stage1"] >= rec["mma1_sift_random_init"] + 0.02, rec
