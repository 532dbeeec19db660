"""The main thread's wait a batch for the decode prefetcher's images
(``extract.feed_wait``), over the window's batches."""

from benchmark.spans import ms_per

UNIT = "ms"
LAYER = "Extractor pipeline"
SOURCE = "program_counter"
MOVES = "extract_images_per_s"


def read(rec):
    return ms_per("extract.feed_wait", "extract.dispatch")
