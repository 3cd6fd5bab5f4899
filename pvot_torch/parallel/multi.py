"""Stacked tracker states: S single-stream states with a leading S axis, the
layout of the multi-stream and multi-object kernels (pvot/parallel/multi.py:29
`init_multi_state`, :262 `init_multi_state_bucketed` for objects whose
templates differ in size).

JAX stacks with a vmap-style tree map; here a TrackerState of tensors whose
fields carry the S axis first, all on one device: the one named, else the
current CUDA device (pvot_torch.tracker.state.default_device).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pvot_torch.ops.ncc_reference import template_stats_bucketed
from pvot_torch.tracker.state import TrackerState, default_device, init_state


def stack_states(states: Sequence[TrackerState], device=None) -> TrackerState:
    """S single-stream states -> one stacked state on `device` (default: the
    device the states already share, unless that is the CPU; else the
    current CUDA device)."""
    if not states:
        raise ValueError("no states to stack")
    shared = {v.device for s in states for v in s}
    if device is None and len(shared) == 1 and next(iter(shared)).type != "cpu":
        device = next(iter(shared))
    device = default_device(device)
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
    template shape) into one state on `device` (default: the current CUDA
    device)."""
    if len(templates) != len(rois):
        raise ValueError("templates and rois must pair up")
    device = default_device(device)
    return stack_states([init_state(t, r, device=device) for t, r in zip(templates, rois)],
                        device)


def init_multi_state_bucketed(
    templates: Sequence,
    rois: Sequence[Tuple[int, int, int, int]],
    bucket: Optional[Tuple[int, int]] = None,
    device=None,
) -> TrackerState:
    """Stack K trackers whose templates differ in size, on `device` (default:
    the current CUDA device).  Each template is zero-padded into a shared
    (bh, bw) bucket (default: the element-wise max); its true size rides in
    bbox_w / bbox_h, which the tracker keeps equal to the template's, and its
    stats are over the true pixels (template_stats_bucketed)."""
    if len(templates) != len(rois):
        raise ValueError("templates and rois must pair up")
    shapes = [tuple(np.shape(t)) for t in templates]
    bh = max(s[0] for s in shapes)
    bw = max(s[1] for s in shapes)
    if bucket is not None:
        if bucket[0] < bh or bucket[1] < bw:
            raise ValueError(f"bucket {bucket} smaller than largest template")
        bh, bw = bucket
    device = default_device(device)
    states = []
    for t, (x, y, w, h) in zip(templates, rois):
        if tuple(np.shape(t)) != (h, w):
            raise ValueError(f"template shape {tuple(np.shape(t))} != roi (h={h}, w={w})")
        padded = torch.zeros((bh, bw), dtype=torch.float32, device=device)
        padded[:h, :w] = torch.as_tensor(t, dtype=torch.float32, device=device)
        t_mean, t_std = template_stats_bucketed(padded, h * w)
        i32 = [torch.tensor(v, dtype=torch.int32, device=device) for v in (x, y, w, h, 0)]
        states.append(TrackerState(*i32[:4], padded, t_mean, t_std, i32[4],
                                   torch.tensor(False, device=device)))
    return stack_states(states, device)
