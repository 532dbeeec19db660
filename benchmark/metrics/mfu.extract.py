"""The model FLOPs of the window's images (counts/model.py, the published
dataflow) over the window's seconds, as a share of the configuration's
peak (TF32's for float32, bfloat16's for bfloat16)."""

UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "extract_images_per_s"


def read(rec):
    i = rec.info
    return 100.0 * i["units"] * i["flops_per_unit"] / rec.window_s / i["peak_flops"]
