"""Host streaming pipeline: decode -> native gray -> ring -> chunks.

A copy of pvot/io/pipeline.py:22 `FramePipeline` (copied, not imported:
importing `pvot` imports JAX).  A background thread decodes and
gray-converts (native C++ kernels, pvot_torch.runtime.native) into a
lock-free ring; the consumer pops chunk-sized uint8 arrays and ships them to
the device while the card tracks the previous chunk.  The tail chunk is
padded with the final frame and carries its count of real frames.
`fill` is the port's addition: it pops the next chunk straight into a
buffer the caller owns (the serving loop's pinned staging), where `chunks`
allocates and concatenates arrays for every chunk.

`track_stream` and `track_stream_batched` (pvot/io/pipeline.py:150, :345)
track a stream through the pipeline on the per-frame engines, or, for
backend="mega" with the fused strategy, on the chunk kernel a chunk at a
time (`track_video_mega`; global frames run in the kernel, so nothing rolls
back: ROADMAP R1).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


class FramePipeline:
    """Background decode/convert into a frame ring; iterate device chunks.

    frame_iter: yields uint8 BGR (H, W, 3) or gray (H, W) frames.
    Produces (chunk (chunk_size, H, W) uint8, n_real) pairs; the last chunk
    may be padded (repeat of the final frame) with n_real < chunk_size.
    `ring` says which frame ring runs: "native" (libpvot's, when the native
    library loads) or "python" (a deque, its fallback).
    """

    def __init__(
        self,
        frame_iter: Iterable[np.ndarray],
        frame_shape: Tuple[int, int],
        chunk_size: int = 32,
        capacity: int = 256,
        use_native: bool = True,
    ):
        self._iter = iter(frame_iter)
        self._shape = tuple(frame_shape)
        self.chunk_size = chunk_size
        self._done = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._use_native = use_native
        from pvot_torch.runtime import native

        if use_native and native.available():
            self.ring = "native"
            self._ring = native.FrameRing(capacity, self._shape)
            self._convert = native.bgr_to_gray_u8
        else:  # pure-Python fallback ring
            self.ring = "python"
            from collections import deque

            self._ring = None
            self._queue = deque()
            self._qlock = threading.Lock()
            self._capacity = capacity
            from pvot_torch.io.gray import bgr_to_gray_u8

            self._convert = bgr_to_gray_u8
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- producer -----------------------------------------------------------
    def _push(self, frame: np.ndarray) -> None:
        if self._ring is not None:
            while not self._ring.push(frame):
                if self._stop.is_set():
                    return
                time.sleep(0.0005)
        else:
            while not self._stop.is_set():
                with self._qlock:
                    if len(self._queue) < self._capacity:
                        self._queue.append(frame)
                        return
                time.sleep(0.0005)

    def _worker(self) -> None:
        try:
            for frame in self._iter:
                if self._stop.is_set():
                    return
                if frame.ndim == 3:
                    frame = self._convert(frame)
                if frame.shape != self._shape:
                    raise ValueError(
                        f"frame shape {frame.shape} != pipeline {self._shape}"
                    )
                self._push(np.ascontiguousarray(frame, np.uint8))
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._done.set()

    # -- consumer -----------------------------------------------------------
    def _pop(self, max_frames: int) -> np.ndarray:
        if self._ring is not None:
            return self._ring.pop(max_frames)
        out = []
        with self._qlock:
            while self._queue and len(out) < max_frames:
                out.append(self._queue.popleft())
        return (
            np.stack(out) if out else np.zeros((0, *self._shape), np.uint8)
        )

    def chunks(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (padded chunk, n_real) until the stream is exhausted."""
        pending = np.zeros((0, *self._shape), np.uint8)
        while True:
            got = self._pop(self.chunk_size - len(pending))
            pending = np.concatenate([pending, got]) if len(got) else pending
            stream_over = self._done.is_set() and self._pop_peek_empty()
            if len(pending) == self.chunk_size:
                yield pending, self.chunk_size
                pending = pending[:0]
            elif stream_over:
                if self._error is not None:
                    raise self._error
                if len(pending):
                    n_real = len(pending)
                    pad = np.repeat(
                        pending[-1:], self.chunk_size - n_real, axis=0
                    )
                    yield np.concatenate([pending, pad]), n_real
                return
            else:
                time.sleep(0.0005)

    def _pop_into(self, out: np.ndarray) -> int:
        if self._ring is not None:
            return self._ring.pop_into(out)
        with self._qlock:
            got = [self._queue.popleft() for _ in range(min(len(out), len(self._queue)))]
        for k, frame in enumerate(got):
            out[k] = frame
        return len(got)

    def fill(self, out: np.ndarray) -> int:
        """Write the next chunk into `out` ((chunk_size, H, W) uint8,
        C-contiguous), padded with its final frame as `chunks` pads it, and
        return its count of real frames; 0 once the stream is exhausted (then
        `out` is left as it was)."""
        n = 0
        while True:
            n += self._pop_into(out[n:])
            stream_over = self._done.is_set() and self._pop_peek_empty()
            if n == self.chunk_size:
                return n
            if stream_over:
                if self._error is not None:
                    raise self._error
                if n:
                    out[n:] = out[n - 1]
                return n
            time.sleep(0.0005)

    def _pop_peek_empty(self) -> bool:
        if self._ring is not None:
            return len(self._ring) == 0
        with self._qlock:
            return not self._queue

    def close(self) -> None:
        """Stop the producer, join it, THEN free the native ring.

        Destroying the ring while the decode thread is still blocked inside
        _push would hand a freed C struct to pvot_ring_push (use-after-free);
        the stop event breaks that spin first and the join guarantees no
        native call is in flight when the ring is destroyed."""
        self._stop.set()
        self._thread.join(timeout=30)
        if self._ring is not None:
            self._ring.close()
            self._ring = None


def _stream_device(state, device):
    import torch

    return torch.device(device) if device is not None else state.template.device


def track_stream(
    frame_iter: Iterable[np.ndarray],
    state,
    frame_shape: Tuple[int, int],
    config=None,
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    device=None,
):
    """Track a frame stream end to end, decode and gray conversion overlapped
    with tracking; returns (final state, StepOutput) like track_video.

    frame_iter yields uint8 BGR (H, W, 3) or gray (H, W) frames.  The stream
    runs on `device` (default: the state's device).  timings, when given a
    list, receives one (frames, seconds) pair per chunk in output order."""
    import torch

    from pvot_torch.config import TrackerConfig
    from pvot_torch.tracker.scan import concat_outputs, records_to_output
    from pvot_torch.tracker.step import cached_step, carry_from_state, state_from_carry

    config = config or TrackerConfig()
    device = _stream_device(state, device)
    h, w = frame_shape
    mega = backend == "mega" and strategy == "fused"
    if not mega:
        c = carry_from_state(state.to(device))
        step = cached_step((h, w), tuple(c.template.shape), config, strategy, backend)
    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=chunk_size)
    outs = []
    mark = time.perf_counter()
    try:
        for chunk, n_real in pipe.chunks():
            dev_chunk = torch.from_numpy(chunk[:n_real]).to(device)
            if mega:
                from pvot_torch.tracker.mega import track_video_mega

                state, out = track_video_mega(dev_chunk, state, config, chunk_size=n_real,
                                              device=device)
            else:
                recs = []
                for frame in dev_chunk:
                    c, rec = step(c, frame)
                    recs.append(rec)
                out = records_to_output(recs)
            outs.append(out)
            now = time.perf_counter()
            if timings is not None:
                timings.append((n_real, now - mark))
            mark = now
    finally:
        pipe.close()
    return (state if mega else state_from_carry(c)), concat_outputs(outs)


def track_stream_batched(
    frame_iter: Iterable[np.ndarray],
    state,
    frame_shape: Tuple[int, int],
    config=None,
    batch_size: Optional[int] = None,
    strategy: str = "fused",
    backend: str = "xla",
    chunks_per_dispatch: int = 8,
    timings: Optional[list] = None,
    device=None,
):
    """Reference-parity batch mode (--batch=N) over a frame stream, the
    semantics of track_video_batched (C10).  backend="mega" with the fused
    strategy runs the chunk kernel's in-kernel cadence: each pipeline chunk
    of n x chunks_per_dispatch frames is one track_video_mega(batch=n) call
    (pvot/io/pipeline.py:380-395); only the last chunk may be partial, and
    its leftover frames get the look-ahead records in the kernel."""
    import torch

    from pvot_torch.config import TrackerConfig
    from pvot_torch.tracker.scan import (
        concat_outputs, leftover_tail, make_batched_step, records_to_output,
    )
    from pvot_torch.tracker.step import carry_from_state, state_from_carry

    config = config or TrackerConfig()
    n = batch_size or config.batch_size
    device = _stream_device(state, device)
    h, w = frame_shape
    if backend == "mega" and strategy == "fused":
        return _track_stream_mega_batched(frame_iter, state, frame_shape, config, n,
                                          n * max(1, chunks_per_dispatch), timings, device)
    c = carry_from_state(state.to(device))
    batch_step = make_batched_step((h, w), tuple(c.template.shape), config, n, strategy,
                                   backend)
    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=n * max(1, chunks_per_dispatch))
    outs = []
    leftover = 0
    mark = time.perf_counter()
    try:
        for chunk, n_real in pipe.chunks():
            k_full = n_real // n
            leftover = n_real - k_full * n
            if not k_full:
                continue
            dev_chunk = torch.from_numpy(chunk[: k_full * n]).to(device)
            recs = []
            for batch in dev_chunk.reshape(k_full, n, h, w):
                c, batch_recs = batch_step(c, batch)
                recs.extend(batch_recs)
            outs.append(records_to_output(recs))
            now = time.perf_counter()
            if timings is not None:
                timings.append((k_full * n, now - mark))
            mark = now
    finally:
        pipe.close()
    if leftover:
        outs.append(leftover_tail(c, leftover))
    return state_from_carry(c), concat_outputs(outs)


def _track_stream_mega_batched(frame_iter, state, frame_shape, config, n: int, group: int,
                               timings: Optional[list], device):
    """track_stream_batched's mega route: every pipeline chunk of `group`
    frames (a multiple of n) through track_video_mega(batch=n)."""
    import torch

    from pvot_torch.tracker.mega import track_video_mega
    from pvot_torch.tracker.scan import concat_outputs

    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=group)
    outs = []
    state = state.to(device)
    mark = time.perf_counter()
    try:
        for chunk, n_real in pipe.chunks():
            dev_chunk = torch.from_numpy(chunk[:n_real]).to(device)
            state, out = track_video_mega(dev_chunk, state, config, chunk_size=group,
                                          device=device, batch=n)
            outs.append(out)
            now = time.perf_counter()
            if timings is not None:
                timings.append((n_real, now - mark))
            mark = now
    finally:
        pipe.close()
    return state, concat_outputs(outs)
