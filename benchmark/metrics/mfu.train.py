"""The model FLOPs of the window's stage-2 steps (counts/model.py: the
frozen backbone's and the head's forward, the head's gradients, the
reduction's products) over the window's seconds, as a share of the
configuration's peak."""

UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "train_pairs_per_s"


def read(rec):
    i = rec.info
    return 100.0 * i["units"] * i["flops_per_unit"] / rec.window_s / i["peak_flops"]
