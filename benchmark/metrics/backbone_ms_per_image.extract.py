"""The device time of the kernels launched inside the backbone's forward
(models/resunet.py), per image: the ranges are opened by forward hooks of the
benchmark around model.backbone."""

UNIT = "ms"
LAYER = "backbone"
SOURCE = "device_trace"
MOVES = "extract_images_per_s"
LAYER_RANGE = "backbone"


def read(rec):
    calls = rec.spans.get(LAYER_RANGE, 0)
    if not calls:
        return None
    seconds, _n = rec.kernel_time("", layer=LAYER_RANGE)
    return 1e3 * seconds / (calls * rec.info["batch"])
