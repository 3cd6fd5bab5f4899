"""Frame-by-frame tracking loop over the plain step (pvot/tracker/scan.py
track_video, the sequential mode).  Look-ahead batch mode is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.tracker.state import StepOutput, TrackerState
from pvot_torch.tracker.step import make_step


def track_video(
    frames,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Track a gray video (F, H, W) uint8 or float frame by frame on
    `device` (default: the state's device)."""
    device = torch.device(device) if device is not None else state.template.device
    frames = torch.as_tensor(frames, device=device)
    if frames.ndim != 3:
        raise ValueError(f"expected (F, H, W) frames, got {tuple(frames.shape)}")
    f, h, w = frames.shape
    state = state.to(device)
    step = make_step((h, w), tuple(state.template.shape), config)
    recs = []
    for i in range(f):
        state, rec = step(state, frames[i])
        recs.append(rec)
    bbox, score, used_global, updated = zip(*recs) if recs else ((),) * 4
    return state, StepOutput(
        bbox=np.asarray(bbox, np.int32).reshape(f, 4),
        score=np.asarray(score, np.float32),
        used_global=np.asarray(used_global, bool),
        updated=np.asarray(updated, bool),
    )
