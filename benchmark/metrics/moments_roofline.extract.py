"""The row-moments kernel (csrc/moments.cu: ``row_moments_kernel``,
``row_moments_slots_kernel``) as a share of its roofline: the bytes of
the head's instance norms a batch (counts/moments.py: the fused head's
trunk norm, or the reference dataflow's four) at 3.35 TB/s, times the
head's calls, over the trace's time of the kernel. Silent where the
launches are not the head's norms, a batch at a time."""

from benchmark import peaks
from benchmark.counts import moments

UNIT = "%"
LAYER = "row moments kernel"
SOURCE = "device_trace"
MOVES = "extract_images_per_s"


def read(rec):
    seconds, launches = rec.kernel_time("row_moments_kernel", "row_moments_slots_kernel")
    calls = rec.spans.get("localheader", 0)
    i = rec.info
    per_call = moments.head_norms(i["batch"], i["height"], i["width"], i["in_channels"], i["fused_head"],
                                  i["itemsize"])
    if not launches or launches != calls * len(per_call):
        return None
    return 100.0 * calls * sum(per_call) / peaks.PEAK_BYTES_PER_S / seconds
