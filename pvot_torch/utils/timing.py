"""Timing and FPS instrumentation (pvot/utils/timing.py).

The reference measures per-frame instantaneous FPS with cv::getTickCount
deltas and prints an end-of-run summary (tracker_ghc/src/main.cpp:243-246,
482-488); its CPU baseline times each pipeline stage
(baseline_cpu/cpub.cpp:101-148).  Launches on the card are asynchronous, so a
stage that ends in device work names its output tensors (`block=`) and the
timer waits for their device's current CUDA stream before it reads the
clock; otherwise it times the launch, not the work.

Spans (`span`) mark the port's host layers on torch.profiler's timeline:
while a profiler session is on in the calling thread, each span is a
`record_function` there (a host event on the profiler's clock, beside the
device's records) and one `Span` record kept in memory (`spans`).  With no
session on, a span reads one flag and does nothing else.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from time import perf_counter_ns
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function


class FpsCounter:
    """Per-frame instantaneous FPS and running totals (main.cpp:243-246)."""

    def __init__(self):
        self._last = time.perf_counter()
        self._start = self._last
        self.total_frames = 0
        self.instant_fps = 0.0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        delta = now - self._last
        self._last = now
        self.total_frames += n
        self.instant_fps = (n / delta) if delta > 0 else 0.0
        return self.instant_fps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    @property
    def average_fps(self) -> float:
        e = self.elapsed
        return self.total_frames / e if e > 0 else 0.0

    def summary(self, kind: str = "Interactive") -> str:
        """The reference's summary line (main.cpp:485-488)."""
        return (f"{kind} tracking summary: frames={self.total_frames}, "
                f"time={self.elapsed:.6g} s, FPS={self.average_fps:.6g}")


def _wait_for(block) -> None:
    """Wait for the current CUDA stream of the device of every CUDA tensor
    in `block` (a tensor, or tuples, lists and dicts of them, NamedTuples
    such as TrackerState included)."""
    if isinstance(block, torch.Tensor):
        if block.is_cuda:
            torch.cuda.current_stream(block.device).synchronize()
    elif isinstance(block, dict):
        for v in block.values():
            _wait_for(v)
    elif isinstance(block, (tuple, list)):
        for v in block:
            _wait_for(v)


class StageTimer:
    """Accumulating per-stage wall clock (cpub.cpp's decode / track / draw /
    write breakdown): `with timer.stage("decode"): ...`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    class _Section:
        def __init__(self, timer: "StageTimer", name: str, block):
            self._timer = timer
            self._name = name
            self._block = block

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self._block is not None:
                _wait_for(self._block)
            self._timer.totals[self._name] += time.perf_counter() - self._t0
            self._timer.counts[self._name] += 1

    def stage(self, name: str, block=None) -> "StageTimer._Section":
        """`block`: the tensors the stage's device work writes, waited for
        before the section closes (needed for work on the card, else the
        section times the launch)."""
        return StageTimer._Section(self, name, block)

    def report(self) -> str:
        lines = ["Stage timing:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name:12s} total={total * 1e3:9.1f} ms  "
                         f"calls={n:6d}  mean={total / n * 1e3:8.3f} ms")
        return "\n".join(lines)


def profile_trace(log_dir: str):
    """A torch.profiler context (pvot/utils/timing.py:97, over
    torch.profiler in place of jax.profiler): the host's and, where there is
    a card, the device's activity inside the block, written as a Chrome /
    TensorBoard trace (`*.pt.trace.json`) under `log_dir` when it closes."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


SPANS_KEPT = 100_000  # the newest span records kept in memory


class Span(NamedTuple):
    """One span recorded while a profiler session was on: its name, the
    unit of work it belongs to (a call's or a served chunk's identifier,
    shared by every span of that unit), the id of the span it ran inside
    (None at the top of its thread), its start and end on
    time.perf_counter_ns, and the unit's frames and lanes where the code
    that opened it knows them."""

    id: int
    name: str
    unit: Optional[Hashable]
    parent: Optional[int]
    start_ns: int
    end_ns: int
    frames: Optional[int]
    lanes: Optional[int]


_kept: deque = deque(maxlen=SPANS_KEPT)
_ids = itertools.count(1)
_units = itertools.count()
_local = threading.local()  # each thread's stack of open spans


class _Off:
    """The span of a thread with no profiler session on."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "unit", "frames", "lanes", "id", "parent", "start_ns", "_rf",
                 "_stack")

    def __init__(self, name, unit, frames, lanes):
        self.name, self.unit, self.frames, self.lanes = name, unit, frames, lanes

    def __enter__(self):
        stack = self._stack = _local.__dict__.setdefault("stack", [])
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            if self.unit is None:
                self.unit = stack[-1].unit
        self.id = next(_ids)
        stack.append(self)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        self._rf.__exit__(*exc)
        self._stack.pop()
        _kept.append(Span(self.id, self.name, self.unit, self.parent, self.start_ns, end,
                          self.frames, self.lanes))
        return False


def span(name: str, unit: Optional[Hashable] = None, frames: Optional[int] = None,
         lanes: Optional[int] = None):
    """A context that marks a span of the port's host work, named `name`.

    While a torch.profiler session is on in this thread (`profile_trace`,
    or any `torch.profiler.profile`), the span is a
    `torch.profiler.record_function(name)` and, when it closes, a `Span`
    record kept in memory (`spans`); its unit is `unit`, or when None the
    unit of the span it runs inside.  Whether it records is decided as it
    opens.  With no session on it returns one shared context that does
    nothing: one flag read a span."""
    if not _profiler_enabled():
        return _OFF
    return _On(name, unit, frames, lanes)


def new_unit() -> int:
    """A fresh unit identifier (the sequence number of a call)."""
    return next(_units)


def spans() -> List[Span]:
    """The span records kept, oldest first (at most SPANS_KEPT, each added
    as its span closed)."""
    return list(_kept)


def reset_spans() -> None:
    """Forget every span record kept."""
    _kept.clear()
