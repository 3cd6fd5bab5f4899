"""End-to-end serving on one card: S live video streams, or K objects in one
live stream (the port of pvot/io/serving.py `serve_streams`,
`serve_streams_grouped`, `serve_objects`).

  decode   one background decode/gray thread per stream
           (pvot_torch.io.pipeline.FramePipeline: native C++ ring +
           bgr_to_gray_u8), all running concurrently with the card
  stage    lockstep (S, C, H, W) uint8 chunks popped from the rings straight
           into pinned host buffers, one pool thread per stream (the ring's
           copies release the GIL); each chunk's copy to the card runs on a
           side CUDA stream and ends in an event that the compute stream
           waits on
  compute  every chunk of every stream is one mega_track_chunk_multi call
           (one persistent launch for all S streams), global search
           included; serve_objects: every chunk of the one stream is one
           mega_track_chunk_objects call for all K objects
  records  come back with a non-blocking copy into pinned host memory and
           are read `pipeline_depth` chunks later; a staging slot (its host
           frames, device frames and host records) is reused only after the
           event recorded behind the kernels that read it has completed

Streams may end at different times: an ended stream's lanes carry n_valid = 0
(the kernel commits nothing for them) until every stream is drained.
serve_objects runs the same loop over one feed, with a lane per object.
Heterogeneous inputs (mixed frame sizes or template sizes) serve through
serve_streams_grouped: one serve_streams call per geometry group, the groups
in host threads of their own, each on its own CUDA streams.

Several devices (pvot/io/serving.py:217 `_serve_streams_multidevice`):
serve_streams(devices=[...]) splits the streams into contiguous groups whose
sizes are within one of each other, one group a device, and serves each
group through the one-device path (the kernel or the scan engines, as the
geometry routes it) in a host thread of its own.  Streams are independent,
so there are no collectives, and each stream's records are those of serving
its group alone (on the card K2's float sums depend on the lanes in its
launch, so a score can move by a few ulps against serving all the streams
together; boxes and flags do not).  A device may repeat in the list (two
groups on one card).
serve_streams_grouped places its geometry groups round-robin on the devices.

The scan engines.  backend != "mega" serves on that per-frame engine, and
backend="mega" serves there on `scan_backend` when the geometry lies outside
the JAX mega envelope (MegaGeometry.supported: a span over 512, a template
side over 256, or a map smaller than the span), as pvot/io/serving.py:187-214
routes it; the route is a test of the geometry, never a fallback on error.
Each lockstep chunk then runs the lockstep multi-lane step
(pvot_torch.parallel.multi.make_multi_stream_step, strategy "fused"; on the
CUDA engine one K5 launch a frame step for every lane, and one K4 launch on a
step where a lane searches globally or the span is over 128) under the
per-stream validity mask (make_stream_masked_scan_fn), so an ended stream's
padding frames leave its state as it was; serve_objects runs
parallel.multi.objects_step (the bucketed step for templates of mixed
sizes), as track_video_multi does.  The step reads the
device once a frame, so this path is bound by the host, not the card.

On the CPU the same loops run the kernels' plain versions, with plain host
buffers and no streams.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.pipeline import FramePipeline
from pvot_torch.ops.backends import MODE_TO_BACKEND
from pvot_torch.ops.ncc_mega import N_LANES, MegaGeometry
from pvot_torch.ops.ncc_reference import score_tier
from pvot_torch.parallel.multi import (
    lane_records_to_output, make_multi_stream_step, make_stream_masked_scan_fn,
    multi_carry_from_state, num_streams, objects_step, stack_states, state_from_multi_carry,
    unstack_state,
)
from pvot_torch.tracker.mega import (
    _rows_to_output, bucket_extents, mega_chunk_step_multi, mega_chunk_step_objects,
)
from pvot_torch.tracker.state import StepOutput, TrackerState
from pvot_torch.utils import timing


class _StreamFeed:
    """One stream's decode pipeline + lockstep chunk cursor
    (pvot/io/serving.py:48).

    next_chunk(out) always fills a full (chunk_size, H, W) uint8 buffer;
    once the stream is exhausted it keeps filling it with the held last
    frame and returning n_real = 0, so the lockstep loop can carry live
    streams to their own ends.  The buffer is the caller's (the serving
    loop's pinned staging): frames go from the decode ring straight into it."""

    def __init__(self, frame_iter: Iterable[np.ndarray], frame_shape, chunk_size: int):
        self.pipe = FramePipeline(frame_iter, frame_shape, chunk_size=chunk_size)
        self._last: Optional[np.ndarray] = None
        self.done = False

    def next_chunk(self, out: np.ndarray) -> int:
        if not self.done:
            n = self.pipe.fill(out)
            if n:
                self._last = out[n - 1].copy()
                return n
            self.done = True
        out[:] = self._last if self._last is not None else 0
        return 0

    def close(self) -> None:
        self.pipe.close()


def _check_options(backend: str, scan_backend: str, highest: bool, score_passes: int) -> None:
    """The score tier must be one the kernels have (score_passes 1, 2 or 3,
    checked even when highest=True, as in JAX), the backend "mega" or an
    engine the registry knows, and the scan engine one the registry knows."""
    score_tier(highest, score_passes)
    if backend != "mega" and backend not in MODE_TO_BACKEND:
        raise ValueError(f"unknown backend: {backend!r}")
    if scan_backend not in MODE_TO_BACKEND:
        raise ValueError(f"unknown scan backend: {scan_backend!r}")


def _concat_outputs(outs: List[StepOutput]) -> StepOutput:
    if not outs:
        return StepOutput(
            bbox=np.zeros((0, 4), np.int32), score=np.zeros((0,), np.float32),
            used_global=np.zeros((0,), bool), updated=np.zeros((0,), bool),
        )
    return StepOutput(*(np.concatenate(xs) for xs in zip(*outs)))


def serve_streams(
    frame_iters: Sequence[Iterable[np.ndarray]],
    states: TrackerState,
    frame_shape: Tuple[int, int],
    config: Optional[TrackerConfig] = None,
    backend: str = "mega",
    scan_backend: str = "pallas_shear",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    highest: bool = True,
    pipeline_depth: int = 2,
    devices: Optional[Sequence] = None,
    score_passes: int = 3,
):
    """Serve S live frame streams end to end with decode, copy and compute
    overlapped.

    frame_iters: S iterables yielding uint8 BGR (H, W, 3) or gray (H, W)
    frames (different lengths allowed).  states: a stacked TrackerState with
    a leading S axis (pvot_torch.parallel.multi.init_multi_state).  The
    streams are served on devices[0] when given one device, else on the
    states' device; given several (a device may repeat), they spread over
    them in contiguous groups, one group a device in a host thread of its
    own (module docstring), and the final state comes back to the states'
    device.

    Returns (final stacked TrackerState on that device, list of S host
    StepOutputs, one per stream, each with that stream's own frame count).
    timings, when given a list, receives one (frames_committed, seconds) pair
    per lockstep chunk (several devices: each group's pairs, group after
    group).

    backend="mega" serves every chunk through the multi-stream kernel K2
    inside the JAX mega envelope, and on `scan_backend` outside it; any other
    backend names the per-frame engine to serve on (module docstring).  On
    the kernel, pipeline_depth is how many chunks may be in flight before the
    oldest one's records are read (1 = synchronous), and highest=False scores
    at `score_passes` bf16 passes (pvot/io/serving.py:94-104, the kernels'
    tiers); each stream's records are then track_video_mega's at that tier.
    The scan engines take neither: each engine has its own tier."""
    _check_options(backend, scan_backend, highest, score_passes)
    config = config or TrackerConfig()
    n = num_streams(states)
    if len(frame_iters) != n:
        raise ValueError(f"{len(frame_iters)} frame iterators for {n} states")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if devices is not None and len(devices) > 1:
        return _serve_streams_multidevice(
            frame_iters, states, frame_shape, config, backend, scan_backend, chunk_size,
            timings, highest, pipeline_depth, list(devices), score_passes)
    device = torch.device(devices[0]) if devices else states.template.device
    frame_shape = tuple(frame_shape)
    templ_shape = tuple(states.template.shape[-2:])
    if backend == "mega":
        g = MegaGeometry(frame_shape, templ_shape, config)
        if g.supported():
            g.check(n)

            def step(frames, st, n_real):
                return mega_chunk_step_multi(frames, st, n_real, config, highest, score_passes)

            return _serve_mega(frame_iters, states, frame_shape, np.arange(n), step,
                               chunk_size, timings, max(1, pipeline_depth), device)
        backend = scan_backend
    return _serve_streams_scan(frame_iters, states, frame_shape, config, backend, chunk_size,
                               timings, device)


def _serve_streams_multidevice(frame_iters, states, frame_shape, config, backend: str,
                               scan_backend: str, chunk_size: int, timings: Optional[list],
                               highest: bool, pipeline_depth: int, devices: list,
                               score_passes: int):
    """pvot/io/serving.py:217: contiguous stream groups whose sizes are
    within one of each other (empty groups drop), group g on devices[g],
    each through serve_streams on its one device in a host thread of its
    own; the finals restacked on the states' device, the outputs in stream
    order.  The per-group rollback of JAX's poison mode is not ported
    (ROADMAP R1): global frames run in the kernel."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(frame_iters)
    n_dev = min(len(devices), n)
    bounds = [round(g * n / n_dev) for g in range(n_dev + 1)]
    groups = [(bounds[g], bounds[g + 1], devices[g]) for g in range(n_dev)
              if bounds[g + 1] > bounds[g]]

    def run_group(lo, hi, device):
        group_timings: Optional[list] = [] if timings is not None else None
        final, outs = serve_streams(
            frame_iters[lo:hi], TrackerState(*(v[lo:hi] for v in states)), frame_shape,
            config, backend=backend, scan_backend=scan_backend, chunk_size=chunk_size,
            timings=group_timings, highest=highest, pipeline_depth=pipeline_depth,
            devices=[device], score_passes=score_passes)
        return final, outs, group_timings

    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        futures = [pool.submit(run_group, *g) for g in groups]
        results = [f.result() for f in futures]
    home = states.template.device
    final = TrackerState(*(torch.cat([v.to(home) for v in vs])
                           for vs in zip(*(r[0] for r in results))))
    if timings is not None:
        for _, _, gt in results:
            timings.extend(gt)
    return final, [o for _, outs, _ in results for o in outs]


def serve_objects(
    frame_iter: Iterable[np.ndarray],
    states: TrackerState,
    frame_shape: Tuple[int, int],
    config: Optional[TrackerConfig] = None,
    backend: str = "mega",
    scan_backend: str = "pallas_shear",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    highest: bool = True,
    pipeline_depth: int = 2,
    devices: Optional[Sequence] = None,
    score_passes: int = 3,
):
    """Serve ONE live frame stream with K trackers end to end
    (pvot/io/serving.py:570): one decode thread, every chunk through the
    multi-object kernel for all K objects, the chunks' copies and records
    overlapped as in serve_streams.

    states: a stacked TrackerState with a leading K axis, one template size
    (pvot_torch.parallel.multi.init_multi_state) or mixed sizes in a shared
    bucket (init_multi_state_bucketed).  The objects are served on
    devices[0] when given, else on the states' device: one stream runs on
    one device (JAX's serve_objects takes no devices), so several raise.

    Returns (final stacked TrackerState on that device, host StepOutput with
    the (F, K) leading layout, F = 0 included).  timings, when given a list,
    receives one (frames, seconds) pair per chunk.  The backends, the route
    out of the envelope (on the bucket's geometry, which binds JAX's
    `supported` too) and the score tier are as in serve_streams;
    mixed template sizes serve on the bucketed torch-ops engine there,
    whatever the scan engine, as in JAX."""
    _check_options(backend, scan_backend, highest, score_passes)
    if devices is not None and len(devices) > 1:
        raise ValueError(f"serve_objects serves one stream on one device, not {len(devices)}")
    config = config or TrackerConfig()
    k = num_streams(states)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    device = torch.device(devices[0]) if devices else states.template.device
    frame_shape = tuple(frame_shape)
    templ_shape = tuple(states.template.shape[-2:])
    if backend == "mega":
        g = MegaGeometry(frame_shape, templ_shape, config)
        if g.supported():
            g.check(k)
            extents = bucket_extents(states)

            def step(frames, st, n_real):
                return mega_chunk_step_objects(frames[0], st, int(n_real[0]), config, extents,
                                               highest, score_passes)

            final, outs = _serve_mega([frame_iter], states, frame_shape, np.zeros(k, int), step,
                                      chunk_size, timings, max(1, pipeline_depth), device)
            return final, StepOutput(*(np.stack(xs, axis=1) for xs in zip(*outs)))
        backend = scan_backend
    multi_step = objects_step(states, frame_shape, config, "fused", backend)
    mc = multi_carry_from_state(states.to(device))
    per_frame: list = []
    mark = time.perf_counter()
    for frames, n_real in _lockstep_chunks([frame_iter], frame_shape, chunk_size, device):
        for frame in frames[0, : int(n_real[0])]:  # every lane shares the stream's frames
            mc, recs = multi_step(mc, frame)
            per_frame.append(recs)
        mark = _time_chunk(timings, int(n_real[0]), mark)
    return state_from_multi_carry(mc), lane_records_to_output(per_frame, k)


def _time_chunk(timings: Optional[list], n: int, mark: float) -> float:
    """Append (frames, seconds since `mark`) to `timings` when given; the new
    mark."""
    now = time.perf_counter()
    if timings is not None:
        timings.append((n, now - mark))
    return now


def _lockstep_chunks(frame_iters, frame_shape, chunk_size: int, device: torch.device):
    """The scan engines' lockstep feed: (frames (N, chunk_size, H, W) uint8 on
    `device`, n_real (N,)) a chunk until every one of the N streams has
    ended; an ended stream holds its last frame with n_real 0 (_StreamFeed).
    The decode threads run ahead of the step; the feeds close however the
    loop ends."""
    feeds: List[_StreamFeed] = []
    host = np.empty((len(frame_iters), chunk_size, *frame_shape), np.uint8)
    try:
        feeds.extend(_StreamFeed(it, frame_shape, chunk_size) for it in frame_iters)
        while True:
            n_real = np.array([f.next_chunk(host[s]) for s, f in enumerate(feeds)], np.int32)
            if not n_real.any():
                return
            yield torch.from_numpy(host).to(device, copy=True), n_real
    finally:
        for f in feeds:
            f.close()


def _serve_streams_scan(frame_iters, states, frame_shape, config, backend: str,
                        chunk_size: int, timings: Optional[list], device: torch.device):
    """pvot/io/serving.py:853 `_serve_streams_scan`: every lockstep chunk
    through the multi-stream step of `backend` under the per-stream validity
    mask, each stream's records cut to its own length.  A chunk runs up to
    its longest stream's last frame: frames that no stream has would change
    no state.  Returns (final stacked state on `device`, S host
    StepOutputs)."""
    scan = make_stream_masked_scan_fn(make_multi_stream_step(
        frame_shape, tuple(states.template.shape[-2:]), config, "fused", backend))
    st = states.to(device)
    outs: List[list] = [[] for _ in frame_iters]
    mark = time.perf_counter()
    for frames, n_real in _lockstep_chunks(frame_iters, frame_shape, chunk_size, device):
        c = int(n_real.max())
        valid = np.arange(c)[:, None] < n_real[None, :]
        st, out = scan(st, frames[:, :c].transpose(0, 1), valid)  # (c, S, H, W) frames
        for s, n in enumerate(n_real.tolist()):
            if n:
                outs[s].append(StepOutput(*(v[:n, s] for v in out)))
        mark = _time_chunk(timings, int(n_real.sum()), mark)
    return st, [_concat_outputs(o) for o in outs]


class _Slot:
    """One in-flight chunk's buffers: its frames on the host (pinned when
    serving on a card) and on the device, its records on the host, the event
    that ends the frames' copy and the event after which all of it may be
    reused."""

    def __init__(self, frames_shape, rows_shape, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.empty(frames_shape, dtype=torch.uint8, pin_memory=cuda)
        self.frames = (torch.empty(frames_shape, dtype=torch.uint8, device=device)
                       if cuda else self.host)
        self.rows = torch.empty(rows_shape, dtype=torch.float32, pin_memory=cuda)
        self.copied = torch.cuda.Event() if cuda else None
        self.done = torch.cuda.Event() if cuda else None
        self.n_real: Optional[np.ndarray] = None
        self.unit = None  # the span unit of the chunk it holds

    def wait(self) -> None:
        """Until the kernels that read this slot and its records' copy are done."""
        if self.done is not None:
            self.done.synchronize()


def _serve_mega(frame_iters, states, frame_shape, lane_feed: np.ndarray, step,
                chunk_size: int, timings: Optional[list], depth: int, device: torch.device):
    """The serving loop over N feeds and L lanes: lane l tracks feed
    lane_feed[l]; step(frames (N, C, H, W) on the device, state, n_real (N,))
    runs one chunk and returns (rows (L, C, 10), the next state).  Returns
    (final state, L lists' host StepOutputs, each of its feed's length).

    Spans (pvot_torch.utils.timing.span): the call is `pvot.serve`; chunk k
    is the unit (call, k) of `pvot.serve.fill` (its frames from the feeds),
    `pvot.serve.copy` (the copy's enqueue), `pvot.serve.step` (the chunk
    and its records' copy enqueued) and, `depth` chunks later,
    `pvot.serve.drain` (`pvot.serve.wait` for the card, then
    `pvot.records`); the `timings` hook runs after the drain's span."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    call = timing.new_unit()
    with timing.span("pvot.serve", unit=call, lanes=len(lane_feed)):
        n_streams = len(frame_iters)
        n_lanes = len(lane_feed)
        cuda = device.type == "cuda"
        if cuda:
            copy_stream = torch.cuda.Stream(device)
            compute = torch.cuda.Stream(device)
            compute.wait_stream(torch.cuda.current_stream(device))  # the states' producers
            on_compute = torch.cuda.stream(compute)
        else:
            on_compute = contextlib.nullcontext()
        slots = [_Slot((n_streams, chunk_size, *frame_shape), (n_lanes, chunk_size, N_LANES),
                       device) for _ in range(depth + 1)]
        feeds: List[_StreamFeed] = []
        outs: List[list] = [[] for _ in range(n_lanes)]
        inflight: deque = deque()
        fillers = ThreadPoolExecutor(max_workers=n_streams)
        mark = time.perf_counter()

        def drain(slot: _Slot) -> None:
            nonlocal mark
            with timing.span("pvot.serve.drain", unit=slot.unit):
                with timing.span("pvot.serve.wait"):
                    slot.wait()
                with timing.span("pvot.records"):
                    host = slot.rows.numpy()
                    for lane, n in enumerate(slot.n_real[lane_feed].tolist()):
                        if n:
                            outs[lane].append(_rows_to_output(host[lane, :n]))
            mark = _time_chunk(timings, int(slot.n_real.sum()), mark)

        try:
            with on_compute:
                st = states.to(device)
            feeds.extend(_StreamFeed(it, frame_shape, chunk_size) for it in frame_iters)
            k = 0
            while True:
                slot = slots[k % len(slots)]
                slot.wait()  # its earlier chunk was drained: this returns at once
                host = slot.host.numpy()
                unit = (call, k)
                with timing.span("pvot.serve.fill", unit=unit):
                    n_real = np.array(list(fillers.map(lambda s: feeds[s].next_chunk(host[s]),
                                                       range(n_streams))), np.int32)
                if not n_real.any():
                    break
                slot.n_real, slot.unit = n_real, unit
                with timing.span("pvot.serve.copy", unit=unit):
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            slot.frames.copy_(slot.host, non_blocking=True)
                            slot.copied.record()
                        compute.wait_event(slot.copied)
                with timing.span("pvot.serve.step", unit=unit, frames=int(n_real.max()),
                                 lanes=n_lanes), on_compute:
                    rows, st = step(slot.frames, st, n_real)
                    slot.rows.copy_(rows, non_blocking=cuda)
                    if cuda:
                        slot.done.record()
                inflight.append(slot)
                k += 1
                if len(inflight) >= depth:
                    drain(inflight.popleft())
            while inflight:
                drain(inflight.popleft())
        finally:
            fillers.shutdown()
            for f in feeds:
                f.close()
        if cuda:
            torch.cuda.current_stream(device).wait_stream(compute)
        return st, [_concat_outputs(o) for o in outs]


def serve_streams_grouped(
    frame_iters: Sequence[Iterable[np.ndarray]],
    states_list: Sequence[TrackerState],
    frame_shapes: Sequence[Tuple[int, int]],
    config: Optional[TrackerConfig] = None,
    backend: str = "mega",
    scan_backend: str = "pallas_shear",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    highest: bool = True,
    pipeline_depth: int = 2,
    devices: Optional[Sequence] = None,
    score_passes: int = 3,
):
    """Serve S live streams with heterogeneous geometries
    (pvot/io/serving.py:314): streams may differ in frame size and template
    size.  Streams group by (frame shape, template shape); each group serves
    through serve_streams, in its own host thread and on its own CUDA
    streams, so the groups' launches interleave on the card.  Per-stream
    results are those of serving each group alone.

    frame_iters: S frame iterables.  states_list: S single-stream
    TrackerStates (pvot_torch.init_state).  frame_shapes: S (H, W) pairs.

    Returns (list of S final single-stream TrackerStates, list of S host
    StepOutputs) in input order.  timings, when given, receives each group's
    per-chunk (frames, seconds) pairs, group after group.  The backends and
    the score tier are every group's, as in serve_streams; each
    group routes on its own geometry, so a group outside the mega envelope
    serves on `scan_backend` while the others serve on the kernel.  With
    devices, group g serves on devices[g % len(devices)]
    (pvot/io/serving.py:383)."""
    from concurrent.futures import ThreadPoolExecutor

    _check_options(backend, scan_backend, highest, score_passes)
    config = config or TrackerConfig()
    n = len(frame_iters)
    if len(states_list) != n or len(frame_shapes) != n:
        raise ValueError(
            f"{n} frame iterators for {len(states_list)} states / "
            f"{len(frame_shapes)} frame shapes"
        )
    groups: dict = {}  # (frame_shape, templ_shape) -> [stream indices]
    for s in range(n):
        key = (tuple(frame_shapes[s]), tuple(states_list[s].template.shape))
        groups.setdefault(key, []).append(s)
    group_list = list(groups.items())

    def run_group(gi, key, idxs):
        group_timings: Optional[list] = [] if timings is not None else None
        device = devices[gi % len(devices)] if devices else states_list[idxs[0]].template.device
        final, outs = serve_streams(
            [frame_iters[i] for i in idxs], stack_states([states_list[i] for i in idxs], device),
            key[0], config, backend=backend, scan_backend=scan_backend, chunk_size=chunk_size,
            timings=group_timings, highest=highest, pipeline_depth=pipeline_depth,
            devices=[device], score_passes=score_passes,
        )
        return final, outs, group_timings

    with ThreadPoolExecutor(max_workers=len(group_list)) as pool:
        futures = [pool.submit(run_group, gi, key, idxs)
                   for gi, (key, idxs) in enumerate(group_list)]
        results = [f.result() for f in futures]

    finals: list = [None] * n
    outs_by_stream: list = [None] * n
    for (_, idxs), (final, outs, gt) in zip(group_list, results):
        for pos, s in enumerate(idxs):
            finals[s] = unstack_state(final, pos)
            outs_by_stream[s] = outs[pos]
        if timings is not None:
            timings.extend(gt or [])
    return finals, outs_by_stream
