"""The reward pass (K6: ``reward_pass_kernel``, csrc/reinforce.cu) as a
share of its roofline: its 3xTF32 product at TF32's peak
(counts/reinforce.py, from the step's shapes: one pass a step), over the
trace's time of the pass."""

from benchmark import peaks
from benchmark.counts import reinforce

UNIT = "%"
LAYER = "reinforce kernels"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(rec):
    seconds, passes = rec.kernel_time("reward_pass")
    if not passes:
        return None
    i = rec.info
    bound = reinforce.pass_ops(i["batch"], i["m"], i["n"], i["D"]) / peaks.PEAK_FLOPS["tf32"]
    return 100.0 * passes * bound / seconds
