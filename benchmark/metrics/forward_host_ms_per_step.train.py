"""The host time a step in the Trainer's forward (``train.forward``: the
model, the preprocess and DiskLoss), over the window's steps."""

from benchmark.spans import ms_per

UNIT = "ms"
LAYER = "Trainer loop"
SOURCE = "program_counter"
MOVES = "train_pairs_per_s"


def read(rec):
    return ms_per("train.forward", "train.forward")
