"""The reference put in the program's place, for the control and for the
planted faults: the same entry surfaces as the drivers' programs (a call a
segment of S streams; a serve of one stream for K objects), computed by the
plain reference tracker.

`tf32=True` is the control: the correlation's operands rounded to TF32, the
precision below the configuration's float32.  `fault` plants one fault:
"stale_state" (every call or chunk returns the state it was given),
"half_lanes" (the second half of the lanes is left out and given the first
half's records), "altered" (one box of the second call or chunk moved by a
pixel where it is produced).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from pvbench.reference import tracker as ref

FAULTS = ("stale_state", "half_lanes", "altered")


class _Reference:
    def __init__(self, p: ref.Params, tf32: bool = False, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.p, self.tf32, self.fault = p, tf32, fault
        self.calls = 0

    @staticmethod
    def init(templates: torch.Tensor, boxes: np.ndarray) -> List[ref.Lane]:
        return [ref.Lane([int(v) for v in b], t.clone()) for t, b in zip(templates, boxes)]

    def launches(self) -> int:
        return self.calls

    @staticmethod
    def final(lanes: List[ref.Lane]):
        return (np.array([ln.bbox for ln in lanes]), torch.stack([ln.template for ln in lanes]),
                np.array([ln.lost for ln in lanes]), np.array([ln.use_global for ln in lanes]))

    def _track(self, frames_at, n: int, lanes: List[ref.Lane]):
        """n frames of every lane, with the planted fault: (lanes after, records)."""
        start = [ln.copy() for ln in lanes]
        n_l = len(lanes)
        work = lanes[: n_l // 2] if self.fault == "half_lanes" else lanes
        recs = ref.track(lambda t: frames_at(t)[: len(work)], n, work, self.p, self.tf32)
        if self.fault == "half_lanes":
            recs = np.concatenate([recs, recs[:, np.arange(n_l - len(work)) % len(work)]],
                                  axis=1)
        if self.fault == "stale_state":
            lanes = start
        if self.fault == "altered" and self.calls == 1 and n:
            recs[n // 2, 0, 0] += 1
        self.calls += 1
        return lanes, recs


class ReferenceStreams(_Reference):
    """In place of the multi-stream chunk driver: segment (S, F, H, W)."""

    def __call__(self, segment: torch.Tensor, lanes: List[ref.Lane]):
        return self._track(lambda t: segment[:, t], segment.shape[1], lanes)


class ReferenceObjects(_Reference):
    """In place of the serving path for K objects: frames from the iterator
    in chunks, each chunk's (frames, seconds) appended to `timings` once its
    records are ready."""

    def __init__(self, p: ref.Params, chunk: int, device: torch.device, **kw):
        super().__init__(p, **kw)
        self.chunk, self.device = chunk, device

    def serve(self, frames, lanes: List[ref.Lane], timings):
        recs, buf = [], []
        mark = time.perf_counter()

        def run(buf, lanes):
            nonlocal mark
            dev = torch.from_numpy(np.stack(buf)).to(self.device)
            lanes, r = self._track(lambda t: dev[t].expand(len(lanes), -1, -1), len(buf), lanes)
            recs.append(r)
            now = time.perf_counter()
            timings.append((len(buf), now - mark))
            mark = now
            return lanes

        for f in frames:
            buf.append(f)
            if len(buf) == self.chunk:
                lanes, buf = run(buf, lanes), []
        if buf:
            lanes = run(buf, lanes)
        return lanes, (np.concatenate(recs) if recs else np.zeros((0, len(lanes), 7)))
