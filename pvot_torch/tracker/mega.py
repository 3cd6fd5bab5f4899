"""Chunked tracking loops over the chunk kernels (pvot/tracker/mega.py
`track_video_mega`, `track_streams_mega` and `track_objects_mega` in their
in-kernel global-search mode, `mega_video_scan`, `mega_chunk_step`,
`mega_chunk_step_multi`, `mega_chunk_step_objects`).

Each chunk is one `mega_track_chunk` call, one `mega_track_chunk_multi` call
for S streams, or one `mega_track_chunk_objects` call for K objects over one
clip; the state passes from chunk to chunk on the device, with its template
stats re-canonicalized at every boundary (pvot/tracker/mega.py:65-83 and
:216-236, per stream or object; over each object's true pixels when the
templates sit in a shared bucket).  Nothing waits for the device between
chunks: the records come to the host once, at the end.  The JAX version pads
the tail chunk to one static length; here the tail chunk is simply shorter,
which commits the same frames.  Global frames commit on the card (no poison
mode, no rollback, no support probe: ROADMAP R1, R2).

Every driver takes the score tier of pvot/tracker/mega.py's
`mega_video_scan` (:129-173): highest=True scores in float32, highest=False
at `score_passes` bf16 passes (1, 2 or 3).  `batch` > 1 runs the look-ahead
cadence in the kernels (pvot/tracker/mega.py:526-589): chunks are cut on
batch boundaries, and the records equal pvot.tracker.scan.
track_video_batched's, leftover tail included; any batch >= 1 runs there,
where JAX sends a batch that is not a power of two to that fallback.

Spans (pvot_torch.utils.timing.span): each call of the three drivers is one
unit, `pvot.track` from the checked inputs to the records; inside it each
chunk's `pvot.chunk` (ops/ncc_mega.py) and `pvot.restack` (the chunk-final
state and its template stats), then `pvot.read` (the records' one copy to
the host, which waits for the card) and `pvot.records` (their conversion).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.ops.ncc_mega import (
    O_BH, O_BW, O_BX, O_BY, O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, check_batch,
    mega_track_chunk, mega_track_chunk_multi, mega_track_chunk_objects,
)
from pvot_torch.ops.ncc_reference import score_tier
from pvot_torch.ops.ncc_reference import template_stats, template_stats_bucketed
from pvot_torch.tracker.state import StepOutput, TrackerState
from pvot_torch.tracker.step import host_read
from pvot_torch.utils import timing


def _state_from_chunk(rows: torch.Tensor, tplout: torch.Tensor,
                      bucketed: bool = False) -> TrackerState:
    """Chunk-final state from the last record and the final template: rows
    (F, 10) and (th, tw) for one stream, or (S, F, 10) and (S, th, tw) for a
    stacked state.  bucketed: the templates sit zero-padded in a shared
    bucket, and their stats are over each one's true pixels, bbox_w x bbox_h
    (pvot/tracker/mega.py:216 `_state_from_chunk_bucketed`)."""
    with timing.span("pvot.restack"):
        last = rows[..., -1, :]

        def i32(lane):
            return last[..., lane].to(torch.int32)

        if bucketed:
            t_mean, t_std = template_stats_bucketed(tplout, i32(O_BW) * i32(O_BH))
        else:
            t_mean, t_std = template_stats(tplout)
        return TrackerState(
            bbox_x=i32(O_BX), bbox_y=i32(O_BY), bbox_w=i32(O_BW), bbox_h=i32(O_BH),
            template=tplout, t_mean=t_mean, t_std=t_std, lost_count=i32(O_LOST),
            use_global=last[..., O_USEG] != 0.0,
        )


def _rows_to_output(rows: np.ndarray) -> StepOutput:
    """Host records (..., 10) -> StepOutput with the records' leading axes."""
    return StepOutput(
        bbox=rows[..., O_BX : O_BX + 4].astype(np.int32),
        score=rows[..., O_SCORE].copy(),
        used_global=rows[..., O_GUSED] != 0.0,
        updated=rows[..., O_UPDATED] != 0.0,
    )


def _chunk_length(chunk_size: int, batch: int) -> int:
    """Frames a chunk: chunk_size cut down to a multiple of batch (at least
    one batch), so that chunks start on batch boundaries
    (pvot/tracker/mega.py:568-570)."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    return max(batch, chunk_size // batch * batch)


def track_video_mega(
    frames,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 256,
    device=None,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[TrackerState, StepOutput]:
    """Track a uint8 gray video (F, H, W) chunk by chunk on `device` (default:
    the state's device), at the score tier and batch cadence of the module
    docstring.  `frames` may be numpy or a tensor; a tensor already on
    `device` is not copied.  Returns the final state (on `device`) and the
    per-frame records, as pvot.tracker.mega.track_video_mega does."""
    score_tier(highest, score_passes)
    batch = check_batch(batch)
    device = torch.device(device) if device is not None else state.template.device
    frames = torch.as_tensor(frames, device=device)
    if frames.ndim != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"expected (F, H, W) uint8 frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    cs = _chunk_length(chunk_size, batch)
    with timing.span("pvot.track", unit=timing.new_unit(), frames=frames.shape[0], lanes=1):
        cur = state.to(device)
        all_rows = []
        for start in range(0, frames.shape[0], cs):
            chunk = frames[start : start + cs]
            rows, cur = mega_chunk_step(chunk, cur, chunk.shape[0], config, highest,
                                        score_passes, batch)
            all_rows.append(rows)
        if not all_rows:
            return cur, _rows_to_output(np.zeros((0, 10), np.float32))
        with timing.span("pvot.read"):
            host = host_read(torch.cat(all_rows)).numpy()
        with timing.span("pvot.records"):
            return cur, _rows_to_output(host)


def mega_chunk_step(
    chunk: torch.Tensor,
    state: TrackerState,
    n_valid: int,
    config: TrackerConfig,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, TrackerState]:
    """One chunk of one stream (pvot/tracker/mega.py:93, the step that
    bench.py:329 drives): chunk (C, H, W) uint8 on the state's device, its
    first n_valid frames tracked; tier and cadence as in track_video_mega.
    One K1 launch.  Returns (rows (C, 10) on the device, the chunk-final
    state).  JAX's `interpret` and `inkernel_global` have no counterpart
    (global search is always in the kernel: ROADMAP R1, R2)."""
    rows, tplout = mega_track_chunk(
        chunk, torch.stack(list(state.bbox)), state.template, state.t_mean, state.t_std,
        state.lost_count, state.use_global, n_valid, config, highest, score_passes, batch,
    )
    return rows, _state_from_chunk(rows, tplout)


def mega_chunk_step_multi(
    chunk: torch.Tensor,
    states: TrackerState,
    n_valid,
    config: TrackerConfig,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, TrackerState]:
    """One chunk of S streams (pvot/tracker/mega.py:183): chunk (S, C, H, W)
    uint8 on the states' device, a stacked state, n_valid per stream (S,) or
    one count for all; tier and cadence as in track_video_mega.  Returns
    (rows (S, C, 10) on the device, the chunk-final stacked state)."""
    rows, tplout = mega_track_chunk_multi(
        chunk, torch.stack(list(states.bbox), dim=-1), states.template, states.t_mean,
        states.t_std, states.lost_count, states.use_global, n_valid, config,
        highest, score_passes, batch,
    )
    return rows, _state_from_chunk(rows, tplout)


def track_streams_mega(
    videos,
    states: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 256,
    batch: int = 1,
    device=None,
    highest: bool = True,
    score_passes: int = 3,
) -> Tuple[TrackerState, StepOutput]:
    """Track S independent pre-decoded streams (S, F, H, W) uint8 together on
    `device` (default: the states' device): every chunk is one
    `mega_track_chunk_multi` call for all S streams, at the tier and cadence
    of track_video_mega (each stream's records are those of
    track_video_mega on it alone).

    `states` is a stacked state (pvot_torch.parallel.multi.init_multi_state).
    Returns (final stacked state on `device`, StepOutput with the (F, S)
    leading layout), as pvot.tracker.mega.track_streams_mega does."""
    score_tier(highest, score_passes)
    batch = check_batch(batch)
    cs = _chunk_length(chunk_size, batch)
    device = torch.device(device) if device is not None else states.template.device
    videos = torch.as_tensor(videos, device=device)
    if videos.ndim != 4 or videos.dtype != torch.uint8:
        raise ValueError(f"expected (S, F, H, W) uint8 videos, got {videos.dtype} "
                         f"{tuple(videos.shape)}")
    s, f = videos.shape[:2]
    if int(states.t_mean.shape[0]) != s:
        raise ValueError(f"{s} videos for {int(states.t_mean.shape[0])} states")
    with timing.span("pvot.track", unit=timing.new_unit(), frames=f, lanes=s):
        cur = states.to(device)
        all_rows = []
        for start in range(0, f, cs):
            chunk = videos[:, start : start + cs]
            rows, cur = mega_chunk_step_multi(chunk, cur, chunk.shape[1], config, highest,
                                              score_passes, batch)
            all_rows.append(rows)
        if not all_rows:
            return cur, _rows_to_output(np.zeros((0, s, 10), np.float32))
        with timing.span("pvot.read"):
            host = host_read(torch.cat(all_rows, dim=1)).numpy()  # (S, F, 10)
        with timing.span("pvot.records"):
            return cur, _rows_to_output(host.transpose(1, 0, 2))


def bucket_extents(states: TrackerState) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The objects' true template extents (bbox_h, bbox_w) when a stacked
    state holds templates of mixed sizes in a shared bucket
    (pvot_torch.parallel.multi.init_multi_state_bucketed), else None: as
    pvot/tracker/mega.py:1063-1068 derives them.  Reads the boxes once from
    the device."""
    th, tw = states.template.shape[-2:]
    extents = tuple(zip(states.bbox_h.tolist(), states.bbox_w.tolist()))
    return extents if any(e != (th, tw) for e in extents) else None


def mega_chunk_step_objects(
    chunk: torch.Tensor,
    states: TrackerState,
    n_valid,
    config: TrackerConfig,
    extents=None,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, TrackerState]:
    """One chunk of K objects over one clip (pvot/tracker/mega.py:242): chunk
    (C, H, W) uint8 on the states' device, a stacked state, n_valid for all
    objects (the one clip's valid frames).  extents: `bucket_extents` of the
    states, for templates of mixed sizes; tier and cadence as in
    track_video_mega.  Returns (rows (K, C, 10) on the device, the
    chunk-final stacked state)."""
    rows, tplout = mega_track_chunk_objects(
        chunk, torch.stack(list(states.bbox), dim=-1), states.template, states.t_mean,
        states.t_std, states.lost_count, states.use_global, n_valid, config,
        bucket_extents=extents, highest=highest, score_passes=score_passes, batch=batch,
    )
    return rows, _state_from_chunk(rows, tplout, bucketed=extents is not None)


def track_objects_mega(
    frames,
    states: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 256,
    device=None,
    highest: bool = True,
    score_passes: int = 3,
) -> Tuple[TrackerState, StepOutput]:
    """Track K objects through ONE pre-decoded uint8 clip (F, H, W) on
    `device` (default: the states' device): every chunk is one
    `mega_track_chunk_objects` call for all K objects, at the score tier of
    track_video_mega.

    `states` is a stacked state: one template size
    (pvot_torch.parallel.multi.init_multi_state), or mixed sizes in a shared
    bucket (init_multi_state_bucketed), told apart by bbox_w / bbox_h as
    pvot/tracker/mega.py:1063-1068 does.  Returns (final stacked state on
    `device`, StepOutput with the (F, K) leading layout), as
    pvot.tracker.mega.track_objects_mega does in its in-kernel global mode."""
    score_tier(highest, score_passes)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    device = torch.device(device) if device is not None else states.template.device
    frames = torch.as_tensor(frames, device=device)
    if frames.ndim != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"expected (F, H, W) uint8 frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    k = int(states.t_mean.shape[0])
    with timing.span("pvot.track", unit=timing.new_unit(), frames=frames.shape[0], lanes=k):
        cur = states.to(device)
        extents = bucket_extents(cur)
        all_rows = []
        for start in range(0, frames.shape[0], chunk_size):
            chunk = frames[start : start + chunk_size]
            rows, cur = mega_chunk_step_objects(chunk, cur, chunk.shape[0], config, extents,
                                                highest, score_passes)
            all_rows.append(rows)
        if not all_rows:
            return cur, _rows_to_output(np.zeros((0, k, 10), np.float32))
        with timing.span("pvot.read"):
            host = host_read(torch.cat(all_rows, dim=1)).numpy()  # (K, F, 10)
        with timing.span("pvot.records"):
            return cur, _rows_to_output(host.transpose(1, 0, 2))
