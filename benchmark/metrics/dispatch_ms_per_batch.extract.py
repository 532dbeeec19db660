"""The main thread's host time a batch inside the Extractor's dispatch
(``extract.dispatch``: stacking the batch, the pinned upload, the device
program's enqueue, the device-to-host copies), over the window's batches."""

from benchmark.spans import ms_per

UNIT = "ms"
LAYER = "Extractor pipeline"
SOURCE = "program_counter"
MOVES = "extract_images_per_s"


def read(rec):
    return ms_per("extract.dispatch", "extract.dispatch")
