"""The program's own span totals (``posfeat_tpu_torch.core.profiling``),
read by the per-layer metrics of its host layers. The program counts a
span only while a torch.profiler session records, and a traced run's
session covers the window alone, so the totals are the window's."""


def ms_per(span: str, unit: str):
    """Milliseconds of ``span`` per count of ``unit`` (the span that counts
    the window's batches or steps), or None where the program has no such
    span: a program without spans, or a window that never reached it."""
    try:
        from posfeat_tpu_torch.core.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    if span not in totals or not totals.get(unit, (0, 0.0))[0]:
        return None
    return 1e3 * totals[span][1] / totals[unit][0]
