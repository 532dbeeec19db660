"""The host time a step in the Trainer's non-finite guard (``train.guard``:
the finite flags and the host's read of them, where it waits for the card),
over the window's steps."""

from benchmark.spans import ms_per

UNIT = "ms"
LAYER = "Trainer loop"
SOURCE = "program_counter"
MOVES = "train_pairs_per_s"


def read(rec):
    return ms_per("train.guard", "train.forward")
