"""Tracker state (pvot/tracker/state.py) as torch tensors.

The state lives on one device: every field is a tensor there, so a tracking
loop that keeps it on the card never waits for the host between frames or
chunks.  The functions that build a state put it on the current CUDA device
unless the caller names a device; the CPU is only ever an explicit
`device="cpu"` (`default_device`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pvot_torch.ops.ncc_reference import template_stats


class TrackerState(NamedTuple):
    """bbox_x/y/w/h, lost_count: int32 0-d tensors; template: float32
    (th, tw); t_mean, t_std: float32 0-d (t_std carries the +1e-6 of
    template_stats); use_global: bool 0-d (the sticky global-search flag)."""

    bbox_x: torch.Tensor
    bbox_y: torch.Tensor
    bbox_w: torch.Tensor
    bbox_h: torch.Tensor
    template: torch.Tensor
    t_mean: torch.Tensor
    t_std: torch.Tensor
    lost_count: torch.Tensor
    use_global: torch.Tensor

    @property
    def bbox(self) -> Tuple[torch.Tensor, ...]:
        return (self.bbox_x, self.bbox_y, self.bbox_w, self.bbox_h)

    def to(self, device) -> "TrackerState":
        return TrackerState(*(v.to(device) for v in self))


class StepOutput(NamedTuple):
    """Per-frame records as host numpy arrays, stacked over frames."""

    bbox: np.ndarray  # int32 (F, 4) = (x, y, w, h) after the frame's update
    score: np.ndarray  # float32 (F,) best NCC value considered
    used_global: np.ndarray  # bool (F,): the argmax ran over the full map
    updated: np.ndarray  # bool (F,): the bbox was accepted


def default_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when none is given.  Without a
    CUDA device the call raises: the CPU is never chosen on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: pass device="cpu" to build the state on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def init_state(
    template, roi: Tuple[int, int, int, int], device=None
) -> TrackerState:
    """Initial state from the ROI and its float32 template patch, on `device`
    (default: the current CUDA device)."""
    x, y, w, h = roi
    if tuple(np.shape(template)) != (h, w):
        raise ValueError(
            f"template shape {tuple(np.shape(template))} != roi (h={h}, w={w})"
        )
    dev = default_device(device)
    template = torch.as_tensor(template, dtype=torch.float32, device=dev)
    t_mean, t_std = template_stats(template)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return TrackerState(
        bbox_x=i32(x), bbox_y=i32(y), bbox_w=i32(w), bbox_h=i32(h),
        template=template, t_mean=t_mean, t_std=t_std, lost_count=i32(0),
        use_global=torch.tensor(False, device=dev),
    )


def is_bbox_outside_frame(
    bx: int, by: int, bw: int, bh: int, frame_w: int, frame_h: int
) -> bool:
    """Center out of frame, or box entirely out of frame."""
    cx = bx + bw // 2
    cy = by + bh // 2
    center_out = cx < 0 or cx >= frame_w or cy < 0 or cy >= frame_h
    box_out = bx + bw < 0 or bx >= frame_w or by + bh < 0 or by >= frame_h
    return center_out or box_out
