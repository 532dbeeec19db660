"""The main thread's wait a batch for the fetch thread, which waits for
the card (``extract.card_wait``: the bound of two batches in flight, the
last drain, the pools' shutdown), over the window's batches."""

from benchmark.spans import ms_per

UNIT = "ms"
LAYER = "Extractor pipeline"
SOURCE = "program_counter"
MOVES = "extract_images_per_s"


def read(rec):
    return ms_per("extract.card_wait", "extract.dispatch")
