"""The per-frame tracking step (pvot/tracker/step.py): the port's semantic
oracle, in plain PyTorch on the host's control flow.

Fused strategy: local frames score only the (span + t - 1)^2 region around
the bbox and mask the argmax to the clamped window; global frames (sticky
flag, bbox outside the frame, lost >= threshold) and collapsed windows score
the full map.  A collapsed window keeps the LOCAL threshold: the threshold
keys off use_global, not off which argmax ran (pvot/tracker/step.py:141-144).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.ncc_reference import ncc_map_reference, template_stats
from pvot_torch.tracker.state import TrackerState, is_bbox_outside_frame


def f32(v: float) -> float:
    """The float32 rounding of v, as an (exactly representable) Python float,
    so that comparisons and products against float32 tensors use the same
    constant as the JAX package's jnp.float32(v)."""
    return float(np.float32(v))


def make_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
) -> Callable:
    """step(state, frame (H, W) tensor) -> (state, (bbox, score,
    used_global, updated)) for a fixed geometry."""
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    out_w, out_h = frame_w - tw + 1, frame_h - th + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    fused = out_w >= span_x and out_h >= span_y

    def step(state: TrackerState, frame: torch.Tensor):
        bx, by, bw, bh = (int(v) for v in state.bbox)
        use_global = config.enable_global_search and (
            bool(state.use_global)
            or is_bbox_outside_frame(bx, by, bw, bh, frame_w, frame_h)
            or int(state.lost_count) >= config.lost_frame_threshold
        )
        bounds = search_ops.local_window_bounds(
            bx + bw // 2, by + bh // 2, tw, th, out_w, out_h,
            config.search_radius_x, config.search_radius_y,
        )
        global_argmax = use_global or not bounds.valid
        tpl, t_mean, t_std = state.template, state.t_mean, state.t_std
        if global_argmax:
            best = search_ops.argmax2d(ncc_map_reference(frame, tpl, t_mean, t_std))
        elif fused:
            x0, y0 = search_ops.region_origin(bounds, out_w, out_h, span_x, span_y)
            region = frame[y0 : y0 + span_y + th - 1, x0 : x0 + span_x + tw - 1]
            scores = ncc_map_reference(region, tpl, t_mean, t_std)
            best = search_ops.masked_region_argmax(scores, x0, y0, bounds)
        else:
            best = search_ops.masked_window_argmax(
                ncc_map_reference(frame, tpl, t_mean, t_std), bounds
            )
        return apply_update(
            state, frame, *best, use_global, global_argmax,
            frame_shape, templ_shape, config,
        )

    return step


def apply_update(
    state: TrackerState,
    frame: torch.Tensor,
    best_val: torch.Tensor,
    best_x: int,
    best_y: int,
    use_global: bool,
    global_argmax: bool,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
):
    """Confidence gate + bbox move, lost counter, global-flag reset and the
    0.7-gated template EMA (pvot/tracker/step.py:203-270)."""
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    lr = float(config.template_update_lr)
    threshold = f32(config.global_confidence if use_global else config.min_confidence)
    accept = bool(best_val >= threshold)
    if accept:
        new_bbox = (best_x, best_y, tw, th)
        lost = 0
    else:
        new_bbox = tuple(int(v) for v in state.bbox)
        lost = int(state.lost_count) + 1
    use_global_next = use_global and not (
        accept and not is_bbox_outside_frame(*new_bbox, frame_w, frame_h)
    )
    template, t_mean, t_std = state.template, state.t_mean, state.t_std
    if accept and bool(best_val >= f32(config.strong_confidence)):
        patch = ensure_gray_f32(frame[best_y : best_y + th, best_x : best_x + tw])
        template = f32(1.0 - lr) * template + f32(lr) * patch
        t_mean, t_std = template_stats(template)

    dev = template.device

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    new_state = TrackerState(
        *(i32(v) for v in new_bbox), template, t_mean, t_std, i32(lost),
        torch.tensor(use_global_next, device=dev),
    )
    return new_state, (new_bbox, float(best_val), global_argmax, accept)
