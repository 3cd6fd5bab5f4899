"""Timing and FPS instrumentation (pvot/utils/timing.py).

The reference measures per-frame instantaneous FPS with cv::getTickCount
deltas and prints an end-of-run summary (tracker_ghc/src/main.cpp:243-246,
482-488); its CPU baseline times each pipeline stage
(baseline_cpu/cpub.cpp:101-148).  Launches on the card are asynchronous, so a
stage that ends in device work names its output tensors (`block=`) and the
timer waits for their device's current CUDA stream before it reads the
clock; otherwise it times the launch, not the work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


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
    import torch

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
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
