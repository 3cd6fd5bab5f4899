"""The per-frame tracking step (pvot/tracker/step.py), on the engines of the
backend registry.

The step carries the tracker's discrete fields (bbox, lost counter, sticky
global flag) as host ints (`Carry`) and its template and stats on the
frame's device: mode selection, the window clamp and the gates run on the
host, the scores and the template EMA on the device, and the step reads the
device once a frame, the (value, x, y) row of its argmax.  `carry_from_state`
and `state_from_carry` convert at a driver's boundaries.

Strategies (pvot/tracker/step.py:72-200):
  "full"  -- the full map every frame, argmax masked to the window (global
             frames and collapsed windows: over the whole map);
  "fused" -- local frames score only the (span + t - 1)^2 region (the fused
             argmax of the CUDA engine, or region scores + a masked argmax);
             global frames and collapsed windows score the full map.  A
             collapsed window keeps the LOCAL threshold: the threshold keys
             off use_global, not off which argmax ran (:141-144).  JAX also
             runs the local pass on global frames and discards it; the port
             skips it, with the same result.
"fused" falls back to "full" when the map is smaller than the span.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

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


def host_read(t: torch.Tensor) -> torch.Tensor:
    """A small device tensor copied to the host: one wait for the device,
    counted in `host_read.count` (the reads per frame of a tracking path)."""
    host_read.count += 1
    return t.cpu()


host_read.count = 0


class Carry(NamedTuple):
    """The step's state between frames: bbox (x, y, w, h), lost counter and
    sticky global flag as host values; the template (th, tw) float32 and its
    stats (0-d, t_std with its +1e-6) on the device."""

    bbox: Tuple[int, int, int, int]
    lost: int
    use_global: bool
    template: torch.Tensor
    t_mean: torch.Tensor
    t_std: torch.Tensor


def carry_from_state(state: TrackerState) -> Carry:
    """A single-object state's carry (one read of its ints)."""
    ints = host_read(torch.stack([state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h,
                                  state.lost_count, state.use_global.to(torch.int32)])).tolist()
    return Carry(tuple(ints[:4]), ints[4], bool(ints[5]), state.template, state.t_mean,
                 state.t_std)


def state_from_carry(c: Carry) -> TrackerState:
    """TrackerState tensors on the template's device."""
    dev = c.template.device

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return TrackerState(*(i32(v) for v in c.bbox), c.template, c.t_mean, c.t_std,
                        i32(c.lost), torch.tensor(c.use_global, device=dev))


def default_region_fn(span_x: int, span_y: int) -> Callable:
    """Conv-oracle region scorer (the `ref_conv` backend): slices the region
    and scores it with pvot_torch.ops.ncc_reference."""

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        th, tw = templ.shape
        region = frame[y0 : y0 + span_y + th - 1, x0 : x0 + span_x + tw - 1]
        return ncc_map_reference(region, templ, t_mean, t_std)

    return region_fn


def make_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    ncc_full_fn: Optional[Callable] = None,
    ncc_region_fn: Optional[Callable] = None,
    strategy: str = "fused",
    ncc_region_argmax_fn: Optional[Callable] = None,
) -> Callable:
    """step(carry, frame (H, W) uint8/float32) -> (carry, (bbox, score,
    used_global, updated)) for a fixed geometry.  ncc_full_fn / ncc_region_fn
    default to the `xla` engine (pvot_torch.ops.ncc_matmul), as in JAX."""
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    out_w, out_h = frame_w - tw + 1, frame_h - th + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    if strategy not in ("fused", "full"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "fused" and (out_w < span_x or out_h < span_y):
        strategy = "full"
    if ncc_full_fn is None or ncc_region_fn is None:
        from pvot_torch.ops.ncc_matmul import make_full_fn, make_region_fn

        ncc_full_fn = ncc_full_fn or make_full_fn(strip_rows=128)
        ncc_region_fn = ncc_region_fn or make_region_fn(span_x, span_y)
    lost_threshold = int(config.lost_frame_threshold)

    def step(c: Carry, frame: torch.Tensor):
        bx, by, bw, bh = c.bbox
        use_global = config.enable_global_search and (
            c.use_global
            or is_bbox_outside_frame(bx, by, bw, bh, frame_w, frame_h)
            or c.lost >= lost_threshold
        )
        bounds = search_ops.local_window_bounds(
            bx + bw // 2, by + bh // 2, tw, th, out_w, out_h,
            config.search_radius_x, config.search_radius_y,
        )
        global_argmax = use_global or not bounds.valid
        tpl, t_mean, t_std = c.template, c.t_mean, c.t_std
        if strategy == "full" or global_argmax:
            ncc_map = ncc_full_fn(frame, tpl, t_mean, t_std)
            best = (search_ops.best_rows(ncc_map) if global_argmax
                    else search_ops.masked_window_best(ncc_map, bounds))
        else:
            x0, y0 = search_ops.region_origin(bounds, out_w, out_h, span_x, span_y)
            if ncc_region_argmax_fn is not None:
                best = ncc_region_argmax_fn(frame, tpl, t_mean, t_std, x0, y0, bounds)
            else:
                best = search_ops.masked_region_best(
                    ncc_region_fn(frame, tpl, t_mean, t_std, x0, y0), x0, y0, bounds)
        val, x, y = host_read(best).tolist()  # the step's one read of the device
        return apply_update(c, frame, val, int(x), int(y), use_global, global_argmax,
                            frame_shape, templ_shape, config)

    return step


def apply_update(
    c: Carry,
    frame: torch.Tensor,
    best_val: float,
    best_x: int,
    best_y: int,
    use_global: bool,
    global_argmax: bool,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
):
    """Confidence gate + bbox move, lost counter, global-flag reset and the
    0.7-gated template EMA (pvot/tracker/step.py:203-270).  best_val is the
    float32 score as a Python float."""
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    lr = float(config.template_update_lr)
    threshold = f32(config.global_confidence if use_global else config.min_confidence)
    accept = best_val >= threshold
    if accept:
        bbox, lost = (best_x, best_y, tw, th), 0
    else:
        bbox, lost = c.bbox, c.lost + 1
    use_global_next = use_global and not (accept and not is_bbox_outside_frame(
        *bbox, frame_w, frame_h))
    template, t_mean, t_std = c.template, c.t_mean, c.t_std
    if accept and best_val >= f32(config.strong_confidence):
        patch = ensure_gray_f32(frame[best_y : best_y + th, best_x : best_x + tw])
        template = f32(1.0 - lr) * template + f32(lr) * patch
        t_mean, t_std = template_stats(template)
    return (Carry(bbox, lost, use_global_next, template, t_mean, t_std),
            (bbox, best_val, global_argmax, accept))


@functools.lru_cache(maxsize=32)
def cached_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
):
    """The step for a geometry, config, strategy and backend, built once
    (pvot/tracker/step.py:273 `jitted_step`, keyed alike)."""
    from pvot_torch.ops.backends import get_backend

    full_fn, region_fn, argmax_fn = get_backend(backend, frame_shape, templ_shape, config)
    return make_step(frame_shape, templ_shape, config, ncc_full_fn=full_fn,
                     ncc_region_fn=region_fn, strategy=strategy,
                     ncc_region_argmax_fn=argmax_fn)
