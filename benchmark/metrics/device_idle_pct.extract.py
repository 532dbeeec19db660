"""The share of the traced window in which no kernel, copy or set ran on
the card: one minus the union of their intervals over the window."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "extract_images_per_s"


def read(rec):
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
