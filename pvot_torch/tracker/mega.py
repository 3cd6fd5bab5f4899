"""Chunked tracking loop over the chunk kernel (pvot/tracker/mega.py
`track_video_mega` in its in-kernel global-search mode, `mega_video_scan`).

Each chunk is one `mega_track_chunk` call; the state passes from chunk to
chunk on the device, with its template stats re-canonicalized through
`template_stats` at every boundary (pvot/tracker/mega.py:65-83).  Nothing
waits for the device between chunks: the records come to the host once, at
the end.  The JAX version pads the tail chunk to one static length; here the
tail chunk is simply shorter, which commits the same frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.ops.ncc_mega import (
    O_BH, O_BW, O_BX, O_BY, O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG,
    mega_track_chunk,
)
from pvot_torch.ops.ncc_reference import template_stats
from pvot_torch.tracker.state import StepOutput, TrackerState


def _state_from_chunk(rows: torch.Tensor, tplout: torch.Tensor) -> TrackerState:
    """Chunk-final state from the last record and the final template."""
    last = rows[-1]
    t_mean, t_std = template_stats(tplout)

    def i32(lane):
        return last[lane].to(torch.int32)

    return TrackerState(
        bbox_x=i32(O_BX), bbox_y=i32(O_BY), bbox_w=i32(O_BW), bbox_h=i32(O_BH),
        template=tplout, t_mean=t_mean, t_std=t_std, lost_count=i32(O_LOST),
        use_global=last[O_USEG] != 0.0,
    )


def _rows_to_output(rows: np.ndarray) -> StepOutput:
    """Host records (F, 10) -> StepOutput."""
    return StepOutput(
        bbox=rows[:, O_BX : O_BX + 4].astype(np.int32),
        score=rows[:, O_SCORE].copy(),
        used_global=rows[:, O_GUSED] != 0.0,
        updated=rows[:, O_UPDATED] != 0.0,
    )


def track_video_mega(
    frames,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 256,
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Track a uint8 gray video (F, H, W) chunk by chunk on `device` (default:
    the state's device).  `frames` may be numpy or a tensor; a tensor already
    on `device` is not copied.  Returns the final state (on `device`) and the
    per-frame records, as pvot.tracker.mega.track_video_mega does."""
    device = torch.device(device) if device is not None else state.template.device
    frames = torch.as_tensor(frames, device=device)
    if frames.ndim != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"expected (F, H, W) uint8 frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    cur = state.to(device)
    all_rows = []
    for start in range(0, frames.shape[0], chunk_size):
        chunk = frames[start : start + chunk_size]
        rows, tplout = mega_track_chunk(
            chunk, torch.stack(list(cur.bbox)), cur.template, cur.t_mean,
            cur.t_std, cur.lost_count, cur.use_global, chunk.shape[0], config,
        )
        cur = _state_from_chunk(rows, tplout)
        all_rows.append(rows)
    if not all_rows:
        return cur, _rows_to_output(np.zeros((0, 10), np.float32))
    return cur, _rows_to_output(torch.cat(all_rows).cpu().numpy())
