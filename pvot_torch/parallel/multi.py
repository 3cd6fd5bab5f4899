"""Stacked tracker states: S single-stream states with a leading S axis, the
layout of the multi-stream kernel (pvot/parallel/multi.py:29
`init_multi_state`).

JAX stacks with a vmap-style tree map; here a TrackerState of tensors whose
fields carry the S axis first, all on one explicit device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pvot_torch.tracker.state import TrackerState, init_state


def stack_states(states: Sequence[TrackerState], device=None) -> TrackerState:
    """S single-stream states -> one stacked state on `device` (default: the
    first state's)."""
    if not states:
        raise ValueError("no states to stack")
    device = torch.device(device) if device is not None else states[0].template.device
    shapes = {tuple(s.template.shape) for s in states}
    if len(shapes) != 1:
        raise ValueError(f"all templates must share one shape, got {shapes}")
    return TrackerState(*(torch.stack([v.to(device) for v in vs]) for vs in zip(*states)))


def unstack_state(states: TrackerState, s: int) -> TrackerState:
    """Stream s of a stacked state."""
    return TrackerState(*(v[s] for v in states))


def num_streams(states: TrackerState) -> int:
    return int(states.t_mean.shape[0])


def init_multi_state(
    templates: Sequence,
    rois: Sequence[Tuple[int, int, int, int]],
    device=None,
) -> TrackerState:
    """Stack S single-stream initial states (one template and ROI each, one
    template shape) into one state on `device`."""
    if len(templates) != len(rois):
        raise ValueError("templates and rois must pair up")
    return stack_states([init_state(t, r, device=device) for t, r in zip(templates, rois)],
                        device)
