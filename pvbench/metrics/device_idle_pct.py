"""device_idle_pct: the share of the traced span (the first chunk kernel's
start to the last one's end) in which the card ran neither a kernel nor a
copy: the union of the profiler's device records against the span."""

UNIT = "%"
LAYER = "device: H100"
MOVES = "track_fps"


def read(run):
    t = run.trace
    if not t or t["span_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["span_us"])
