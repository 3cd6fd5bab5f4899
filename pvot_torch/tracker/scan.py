"""Tracking drivers over the per-frame step: sequential chunks and the
reference's look-ahead batch mode (pvot/tracker/scan.py).

The frames go to the device a chunk at a time (a tensor already there is
only sliced); the step runs frame by frame on the host's control flow with
the tracker's ints on the host and its template on the device, so a frame
costs the step's one read of its argmax.  `backend="mega"` with the fused
strategy routes to the chunk kernel's driver (`track_video_mega`), as
pvot/tracker/scan.py:203-218 does; with "full" it runs the CUDA engine.

Batch mode (--batch=N, component C10; tracker_ghc/src/main.cpp:385-397):
the first N-1 frames of every batch re-emit the previous bbox with score -1;
the state update runs once per batch, on the batch's LAST frame.  Leftover
frames that never fill a batch re-emit the final bbox with no update.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.tracker.state import StepOutput, TrackerState
from pvot_torch.tracker.step import Carry, cached_step, carry_from_state, state_from_carry


def records_to_output(recs: List[tuple]) -> StepOutput:
    """Per-frame (bbox, score, used_global, updated) records -> StepOutput."""
    n = len(recs)
    bbox, score, used_global, updated = zip(*recs) if recs else ((),) * 4
    return StepOutput(
        bbox=np.asarray(bbox, np.int32).reshape(n, 4),
        score=np.asarray(score, np.float32),
        used_global=np.asarray(used_global, bool),
        updated=np.asarray(updated, bool),
    )


def concat_outputs(outs: List[StepOutput]) -> StepOutput:
    """StepOutputs of consecutive pieces of a clip, joined."""
    if not outs:
        return records_to_output([])
    return StepOutput(*(np.concatenate(parts) for parts in zip(*outs)))


def _device_of(state: TrackerState, device) -> torch.device:
    return torch.device(device) if device is not None else state.template.device


def _chunks(frames, chunk_size: int, device: torch.device):
    """Device chunks (C, H, W) of a clip: host arrays go over a chunk at a
    time, a tensor already on `device` is sliced."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    for start in range(0, frames.shape[0], chunk_size):
        yield torch.as_tensor(frames[start : start + chunk_size]).to(device)


def _check_frames(frames):
    if not isinstance(frames, torch.Tensor):
        frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError(f"expected (F, H, W) frames, got {tuple(frames.shape)}")
    return frames


def track_video(
    frames,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
    step: Optional[Callable] = None,
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Track a gray video (F, H, W) uint8 or float32 on `device` (default: the
    state's device) with a backend of pvot_torch.ops.backends (or a given
    `step` of `make_step`'s form).  Returns (final state, StepOutput)."""
    frames = _check_frames(frames)
    device = _device_of(state, device)
    if backend == "mega" and step is None:
        if strategy == "fused":
            from pvot_torch.tracker.mega import track_video_mega

            return track_video_mega(frames, state, config, chunk_size=chunk_size, device=device)
        backend = "pallas_shear"
    f, h, w = frames.shape
    c = carry_from_state(state.to(device))
    if step is None:
        step = cached_step((h, w), tuple(c.template.shape), config, strategy, backend)
    recs = []
    for chunk in _chunks(frames, chunk_size, device):
        for frame in chunk:
            c, rec = step(c, frame)
            recs.append(rec)
    return state_from_carry(c), records_to_output(recs)


def make_batch_step(step: Callable, batch_size: int) -> Callable:
    """Look-ahead batch step with the reference's last-frame-only update (C10):
    (carry, batch (n, H, W)) -> (carry, n records)."""

    def batch_step(c: Carry, batch: torch.Tensor):
        c_next, last = step(c, batch[-1])
        held = (c.bbox, -1.0, False, False)
        return c_next, [held] * (batch_size - 1) + [last]

    return batch_step


def leftover_tail(state, leftover: int) -> StepOutput:
    """Records for end-of-video frames that never filled a batch: the bbox of
    `state` (a TrackerState or a Carry) re-emitted, score -1, no update
    (main.cpp:386-392)."""
    bbox = state.bbox if isinstance(state, Carry) else tuple(
        int(v) for v in torch.stack(list(state.bbox)).tolist())
    return records_to_output([(tuple(bbox), -1.0, False, False)] * leftover)


def make_batched_step(frame_shape, templ_shape, config: TrackerConfig, batch_size: int,
                      strategy: str = "fused", backend: str = "xla") -> Callable:
    """The C10 batch step on an engine: the core shared by the array driver
    (track_video_batched) and the streaming one (track_stream_batched)."""
    return make_batch_step(cached_step(frame_shape, templ_shape, config, strategy, backend),
                           batch_size)


def track_video_batched(
    frames,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    batch_size: Optional[int] = None,
    strategy: str = "fused",
    backend: str = "xla",
    chunks_per_dispatch: int = 8,
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Reference-parity batch mode (--batch=N) over a clip (F, H, W): batches
    of n go to the device `chunks_per_dispatch` at a time."""
    n = batch_size or config.batch_size
    if n < 1:
        raise ValueError(f"batch_size must be >= 1, got {n}")
    frames = _check_frames(frames)
    device = _device_of(state, device)
    f, h, w = frames.shape
    c = carry_from_state(state.to(device))
    batch_step = make_batched_step((h, w), tuple(c.template.shape), config, n, strategy,
                                   backend)
    num_full = f // n
    recs = []
    for chunk in _chunks(frames[: num_full * n], n * max(1, chunks_per_dispatch), device):
        for batch in chunk.reshape(-1, n, h, w):
            c, batch_recs = batch_step(c, batch)
            recs.extend(batch_recs)
    outs = [records_to_output(recs)]
    leftover = f - num_full * n
    if leftover:
        outs.append(leftover_tail(c, leftover))
    return state_from_carry(c), concat_outputs(outs)
