"""torch.cuda.max_memory_allocated() over the window, the allocator's
statistics reset at its start."""

UNIT = "GiB"
LAYER = "device"
SOURCE = "program_counter"
MOVES = "train_pairs_per_s"


def read(rec):
    return rec.info["window_peak_bytes"] / 2**30
