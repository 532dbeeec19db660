"""The device kernels the traced window launched a stage-2 step: every
kernel of the trace over the window's steps (pairs over the batch). A
step on cuDNN's FFT convolutions launches tens of thousands; the count
shows how far that path still engages."""

UNIT = "launches"
LAYER = "model step"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(rec):
    steps = rec.info["units"] / rec.info["batch"]
    if not steps:
        return None
    return len(rec.kernels) / steps
