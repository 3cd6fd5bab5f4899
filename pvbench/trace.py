"""The traced run: torch.profiler over a steady span of the window.

`Tracer` starts the profiler once the window has run `start` of its seconds
and stops it `length` seconds later, both at the end of a unit (a call or a
drained chunk) and after a device synchronisation, reading the program's
launch counter at both ends.  `read` turns the session into the per-layer
record: the chunk kernel's records, their device time and the span from the
first one's start to the last one's end, the union of every device record
inside that span, and the breakdown.  It raises when the profiler recorded
another number of chunk kernels than the counter says were launched: the
profiler drops records at times, and a number taken from a short count is
never printed.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

KERNEL = "chunk_kernel"


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    # acc_events: the events of the one session stay readable after stop().
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)


def warm(fn: Callable[[], None]) -> None:
    """Run fn under a short profiler session and discard it: the first
    session of a process sets the profiler up."""
    with _profiler():
        fn()
        torch.cuda.synchronize()


class Tracer:
    """Profile the window's steady span: from `start` to `start + length`
    seconds after the window opened, at unit ends (`tick`)."""

    def __init__(self, seconds: float, launches: Callable[[], int]):
        self.start = 0.3 * seconds
        self.length = min(3.0, 0.4 * seconds)
        self.launches = launches
        self.prof = None
        self.state = "before"
        self.count: Tuple[int, int] = (0, 0)  # the launch counter at start and stop

    def tick(self, now: float, opened: float) -> None:
        if self.state == "before" and now - opened >= self.start:
            torch.cuda.synchronize()
            self.count = (self.launches(), 0)
            self.prof = _profiler()
            self.prof.start()
            self.t_on = time.perf_counter()
            self.state = "on"
        elif self.state == "on" and now - self.t_on >= self.length:
            self.stop()

    def stop(self) -> None:
        if self.state != "on":
            return
        torch.cuda.synchronize()
        self.prof.stop()
        self.count = (self.count[0], self.launches())
        self.state = "done"


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _is_device_work(e) -> bool:
    """A kernel, copy or set on the card: a device record that is not the
    device-side shadow of a host span (record_function)."""
    return (_is_device(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("pvbench."))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def read(tracer: Tracer) -> Optional[dict]:
    """The traced span's record (times in us), or None if the profiler never
    ran.  Raises when its chunk-kernel records and the launch counter
    disagree."""
    if tracer.state != "done":
        return None
    events = list(tracer.prof.events())
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if _is_device_work(e)]
    kernels = sorted((s, e) for s, e, n in device if KERNEL in n)
    launched = tracer.count[1] - tracer.count[0]
    if len(kernels) != launched or not kernels:
        raise RuntimeError(f"the profiler recorded {len(kernels)} chunk kernels where the "
                           f"launch counter counted {launched}: no per-layer number is taken")
    lo, hi = kernels[0][0], kernels[-1][1]
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    busy = _union([(s, e) for s, e, _ in inside])
    by_op: Dict[str, float] = {}
    for s, e, n in inside:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if not _is_device(e) and e.time_range.end > lo and e.time_range.start < hi)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        # The innermost host event the gap's middle falls in: the latest to
        # start of those still running.
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][1] < mid:
            i -= 1
        name = host[i][2] if i >= 0 else "(no host event)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernel_records": len(kernels),
        "launches": tracer.count,
        "kernel_us": sum(e - s for s, e in kernels),
        "span_us": hi - lo,
        "busy_us": sum(e - s for s, e in busy),
        "breakdown": {
            "device_ops": [[n, us * 1e-6] for n, us in top],
            "idle_gaps": [[n, us * 1e-6]
                          for n, us in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
