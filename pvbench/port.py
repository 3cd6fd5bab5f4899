"""What the drivers share of the program under test (pvot_torch): its
stacked initial state, its records, its final state and its tier."""

from __future__ import annotations

import numpy as np
import torch


def tier(config: dict) -> dict:
    """The configuration's score tier as the port's keywords."""
    return dict(highest=config["tier"]["highest"], score_passes=config["tier"]["score_passes"])


def init_states(templates: torch.Tensor, boxes: np.ndarray, device: torch.device):
    """The port's stacked state of trackers started on `boxes` with these
    float32 templates."""
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.tracker.state import init_state

    return stack_states([init_state(t, tuple(int(v) for v in b), device=device)
                         for t, b in zip(templates, boxes)], device)


def records(out) -> np.ndarray:
    """The port's StepOutput (F, L, ...) as records (F, L, 7): x, y, w, h,
    score, updated, used_global."""
    return np.concatenate([out.bbox.astype(np.float64), out.score[..., None].astype(np.float64),
                           out.updated[..., None], out.used_global[..., None]], axis=-1)


def final_state(state):
    """(boxes (L, 4), templates (L, th, tw), lost counts (L,), global flags
    (L,)) of the port's stacked state."""
    return (torch.stack(list(state.bbox), dim=-1).cpu().numpy(), state.template,
            state.lost_count.cpu().numpy(), state.use_global.cpu().numpy())
