"""Stacked tracker states and the lockstep multi-lane steps: S single-stream
states with a leading S axis, the layout of the multi-stream and
multi-object kernels (pvot/parallel/multi.py:29 `init_multi_state`, :262
`init_multi_state_bucketed` for objects whose templates differ in size), and
the steps and drivers of pvot/parallel/multi.py on the per-frame engines
(`make_multi_step`, `make_multi_stream_step`, `make_stream_masked_scan_fn`,
`objects_step`, `track_video_multi`, `make_multi_step_bucketed`).

JAX stacks with a vmap-style tree map; here a TrackerState of tensors whose
fields carry the S axis first, all on one device: the one named, else the
current CUDA device (pvot_torch.tracker.state.default_device).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.backends import cuda_region_passes
from pvot_torch.ops.ncc_pallas import ncc_map_lanes, region_argmax_lanes
from pvot_torch.ops.ncc_reference import template_stats, template_stats_bucketed
from pvot_torch.tracker.mega import bucket_extents
from pvot_torch.tracker.scan import records_to_output
from pvot_torch.tracker.state import (
    StepOutput, TrackerState, default_device, init_state, is_bbox_outside_frame,
)
from pvot_torch.tracker.step import f32, host_read


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


# --- Lockstep steps over K lanes on the per-frame engines
# (pvot/parallel/multi.py:43-256, :305-447).  The lanes' discrete fields
# ride on the host (`MultiCarry`), their templates and stats on the device;
# a step reads the device once, every lane's argmax row together.


class MultiCarry(NamedTuple):
    """K lanes' step state: per-lane bbox tuples, lost counters and sticky
    global flags on the host; templates (K, th, tw) and stats (K,) on the
    device."""

    bbox: List[Tuple[int, int, int, int]]
    lost: List[int]
    use_global: List[bool]
    template: torch.Tensor
    t_mean: torch.Tensor
    t_std: torch.Tensor


def multi_carry_from_state(states: TrackerState) -> MultiCarry:
    """A stacked state's carry (one read of its ints)."""
    ints = host_read(torch.stack([states.bbox_x, states.bbox_y, states.bbox_w, states.bbox_h,
                                  states.lost_count, states.use_global.to(torch.int32)],
                                 dim=1)).tolist()
    return MultiCarry([tuple(r[:4]) for r in ints], [r[4] for r in ints],
                      [bool(r[5]) for r in ints], states.template, states.t_mean, states.t_std)


def state_from_multi_carry(mc: MultiCarry) -> TrackerState:
    dev = mc.template.device

    def i32(vs):
        return torch.tensor(vs, dtype=torch.int32, device=dev)

    cols = list(zip(*mc.bbox))
    return TrackerState(*(i32(list(v)) for v in cols), mc.template, mc.t_mean, mc.t_std,
                        i32(mc.lost), torch.tensor(mc.use_global, device=dev))


def _lane_modes(mc: MultiCarry, frame_shape, extents, config: TrackerConfig):
    """Per lane (use_global, bounds, global argmax), from its state and
    template extent (th, tw)."""
    frame_h, frame_w = frame_shape
    modes = []
    for (bx, by, bw, bh), lost, ug, (th, tw) in zip(mc.bbox, mc.lost, mc.use_global, extents):
        use_global = config.enable_global_search and (
            ug or is_bbox_outside_frame(bx, by, bw, bh, frame_w, frame_h)
            or lost >= config.lost_frame_threshold)
        bounds = search_ops.local_window_bounds(
            bx + bw // 2, by + bh // 2, tw, th, frame_w - tw + 1, frame_h - th + 1,
            config.search_radius_x, config.search_radius_y)
        modes.append((use_global, bounds, use_global or not bounds.valid))
    return modes


def _update_lanes(mc: MultiCarry, frame, best, modes, extents, frame_shape,
                  config: TrackerConfig, lane_frames: bool, bucket_mask=None):
    """Gate, commit, lost counter, flag reset and the gated EMA for every lane
    (pvot/tracker/step.py:203-270 per lane; with `bucket_mask`, the bucketed
    update of pvot/parallel/multi.py:407-441: the EMA and the stats over each
    lane's true extent)."""
    frame_h, frame_w = frame_shape
    lr = float(config.template_update_lr)
    bbox, lost, useg, recs, strong = [], [], [], [], []
    for k, ((val, x, y), (ug, _, ga), (th, tw)) in enumerate(zip(best, modes, extents)):
        accept = val >= f32(config.global_confidence if ug else config.min_confidence)
        box = (int(x), int(y), tw, th) if accept else mc.bbox[k]
        bbox.append(box)
        lost.append(0 if accept else mc.lost[k] + 1)
        useg.append(ug and not (accept and not is_bbox_outside_frame(*box, frame_w, frame_h)))
        strong.append(accept and val >= f32(config.strong_confidence))
        recs.append((box, val, ga, accept))
    template, t_mean, t_std = mc.template, mc.t_mean, mc.t_std
    if any(strong):
        bh, bw = template.shape[-2:]
        patches = torch.zeros_like(template)
        for k in (k for k, s in enumerate(strong) if s):
            fr = frame[k] if lane_frames else frame
            x, y = bbox[k][:2]
            th, tw = extents[k]
            patches[k, :th, :tw] = ensure_gray_f32(fr[y : y + th, x : x + tw])
        blended = f32(1.0 - lr) * template + f32(lr) * patches
        if bucket_mask is not None:
            blended = torch.where(bucket_mask, blended, 0.0)
            new_mean, new_std = template_stats_bucketed(
                blended, torch.tensor([th * tw for th, tw in extents]))
        else:
            new_mean, new_std = template_stats(blended)
        sel = torch.tensor(strong, device=template.device)
        template = torch.where(sel[:, None, None], blended, template)
        t_mean = torch.where(sel, new_mean, t_mean)
        t_std = torch.where(sel, new_std, t_std)
    return MultiCarry(bbox, lost, useg, template, t_mean, t_std), recs


def _read_best(local: torch.Tensor, glob: Optional[torch.Tensor], modes):
    """Each lane's (value, x, y): the global row where the lane searched
    globally, else the local one; one read of the device."""
    rows = local if glob is None else torch.cat([local, glob])
    host = host_read(rows).tolist()
    k = len(modes)
    return [host[k + i] if glob is not None and ga else host[i]
            for i, (_, _, ga) in enumerate(modes)]


def make_multi_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    per_object_frames: bool = False,
):
    """Lockstep step over K lanes: (MultiCarry, frame) -> (MultiCarry, K
    records).  per_object_frames=False: one frame (H, W) for K objects;
    True: frames (K, H, W), one per lane (K streams).

    As in JAX, not a loop of the single-lane step: the local pass runs for
    every lane at once (on the CUDA engine one K5 launch for all lanes), and
    the global pass runs only when some lane needs it, then for all lanes
    (one K4 launch with per-lane templates), like the scalar cond at
    pvot/parallel/multi.py:152."""
    from pvot_torch.ops.backends import get_backend

    full_fn, region_fn, argmax_fn = get_backend(backend, frame_shape, templ_shape, config)
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    out_w, out_h = frame_w - tw + 1, frame_h - th + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    use_region = strategy == "fused" and out_w >= span_x and out_h >= span_y
    # The CUDA engine's lanes take one launch a pass; its region scores run
    # at the engine's tier (3 bf16 passes for pallas_fast), its full maps in
    # float32.
    passes = cuda_region_passes(backend)
    cuda_lanes = passes is not None

    def lane_frame(frame, k):
        return frame[k] if per_object_frames else frame

    def full_maps(frame, mc):
        if cuda_lanes:  # one launch: every lane's template on its frame
            return ncc_map_lanes(frame, mc.template, mc.t_mean, mc.t_std)
        return torch.stack([full_fn(lane_frame(frame, k), mc.template[k], mc.t_mean[k],
                                    mc.t_std[k]) for k in range(len(mc.bbox))])

    def multi_step(mc: MultiCarry, frame: torch.Tensor):
        k_lanes = len(mc.bbox)
        modes = _lane_modes(mc, frame_shape, [(th, tw)] * k_lanes, config)
        if use_region:
            origins = [search_ops.region_origin(b, out_w, out_h, span_x, span_y)
                       for _, b, _ in modes]
            if argmax_fn is not None:
                lanes = [(x0, y0, b.min_tx - x0, b.max_tx - x0, b.min_ty - y0, b.max_ty - y0)
                         for (x0, y0), (_, b, _) in zip(origins, modes)]
                local = region_argmax_lanes(frame, mc.template, mc.t_mean, mc.t_std, lanes,
                                            (span_y, span_x), passes)
            else:
                if cuda_lanes:  # one K4 launch over every lane's region
                    scores = ncc_map_lanes(frame, mc.template, mc.t_mean, mc.t_std, origins,
                                           (span_y, span_x), passes)
                else:
                    scores = [region_fn(lane_frame(frame, k), mc.template[k], mc.t_mean[k],
                                        mc.t_std[k], x0, y0) for k, (x0, y0) in enumerate(origins)]
                local = torch.stack([
                    search_ops.masked_region_best(scores[k], x0, y0, b)
                    for k, ((x0, y0), (_, b, _)) in enumerate(zip(origins, modes))])
        else:
            maps = full_maps(frame, mc)
            local = torch.stack([search_ops.masked_window_best(maps[k], b)
                                 for k, (_, b, _) in enumerate(modes)])
        glob = None
        if any(ga for _, _, ga in modes):
            glob = search_ops.best_rows(full_maps(frame, mc))
        best = _read_best(local, glob, modes)
        return _update_lanes(mc, frame, best, modes, [(th, tw)] * k_lanes, frame_shape,
                             config, per_object_frames)

    return multi_step


def make_multi_stream_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
):
    """S streams in lockstep: (MultiCarry, frames (S, H, W)) -> (MultiCarry,
    S records)."""
    return make_multi_step(frame_shape, templ_shape, config, strategy, backend,
                           per_object_frames=True)


def make_stream_masked_scan_fn(multi_step):
    """Lockstep chunk loop over S streams with per-stream validity: (stacked
    state, frames (C, S, H, W), valid (C, S)) -> (stacked state, StepOutput
    with the (C, S) leading layout).  A stream's invalid (padding) frames
    leave its state as it was, while the others advance
    (pvot/parallel/multi.py:186)."""

    def scan_chunk(states: TrackerState, frames: torch.Tensor, valid):
        valid = np.asarray(valid, bool)
        mc = multi_carry_from_state(states)
        per_frame = []
        for frame, ok in zip(frames, valid):
            new, recs = multi_step(mc, frame)
            if not ok.all():
                sel = torch.tensor(ok, device=mc.template.device)
                new = MultiCarry(
                    [n if v else o for n, o, v in zip(new.bbox, mc.bbox, ok)],
                    [n if v else o for n, o, v in zip(new.lost, mc.lost, ok)],
                    [n if v else o for n, o, v in zip(new.use_global, mc.use_global, ok)],
                    torch.where(sel[:, None, None], new.template, mc.template),
                    torch.where(sel, new.t_mean, mc.t_mean),
                    torch.where(sel, new.t_std, mc.t_std))
            mc = new
            per_frame.append(recs)
        return state_from_multi_carry(mc), lane_records_to_output(per_frame, frames.shape[1])

    return scan_chunk


def lane_records_to_output(per_frame: List[list], k: int) -> StepOutput:
    """Per frame a list of K (bbox, score, used_global, updated) records ->
    StepOutput with the (F, K) leading layout."""
    f = len(per_frame)
    flat = [r for recs in per_frame for r in recs]
    out = records_to_output(flat)
    return StepOutput(out.bbox.reshape(f, k, 4), out.score.reshape(f, k),
                      out.used_global.reshape(f, k), out.updated.reshape(f, k))


def objects_step(
    states: TrackerState,
    frame_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
):
    """The multi-object step for a stacked state: make_multi_step_bucketed
    when the templates are of mixed sizes in a shared bucket
    (pvot_torch.tracker.mega.bucket_extents tells them apart), where
    `strategy` and `backend` select nothing, as in JAX
    (pvot/parallel/multi.py:212); else make_multi_step on them."""
    templ_shape = tuple(states.template.shape[-2:])
    if bucket_extents(states) is not None:
        return make_multi_step_bucketed(frame_shape, templ_shape, config)
    return make_multi_step(frame_shape, templ_shape, config, strategy, backend)


def track_video_multi(
    frames,
    states: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Track K objects through one gray video (F, H, W) on `device` (default:
    the states' device); outputs have the (F, K) leading layout.  The step
    is `objects_step`'s: templates of mixed sizes (init_multi_state_bucketed
    states) run the bucketed step on its own torch-ops engine."""
    from pvot_torch.tracker.scan import _check_frames, _chunks

    frames = _check_frames(frames)
    device = torch.device(device) if device is not None else states.template.device
    multi_step = objects_step(states, frames.shape[1:], config, strategy, backend)
    mc = multi_carry_from_state(states.to(device))
    per_frame = []
    for chunk in _chunks(frames, chunk_size, device):
        for frame in chunk:
            mc, recs = multi_step(mc, frame)
            per_frame.append(recs)
    return state_from_multi_carry(mc), lane_records_to_output(per_frame, len(mc.bbox))


def make_multi_step_bucketed(
    frame_shape: Tuple[int, int],
    bucket: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
):
    """Multi-object step for templates of mixed sizes zero-padded into one
    (bh, bw) bucket, each lane at its true extent (bbox_h, bbox_w): the local
    pass for every lane, the global pass only when some lane needs it, both
    on the bucketed torch-ops engine (pvot_torch.ops.ncc_matmul
    .ncc_scores_bucketed), as pvot/parallel/multi.py:305 does."""
    from pvot_torch.ops.ncc_matmul import make_bucketed_full_fn, make_bucketed_region_fn

    frame_h, frame_w = frame_shape
    bh, bw = bucket
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    region_fn = make_bucketed_region_fn(span_x, span_y, bucket)
    full_fn = make_bucketed_full_fn(frame_shape, bucket)
    if frame_w - bw + 1 < span_x or frame_h - bh + 1 < span_y:
        raise ValueError("bucketed multi-step needs frame - bucket + 1 >= search span")

    def multi_step(mc: MultiCarry, frame: torch.Tensor):
        extents = [(bbh, bbw) for _, _, bbw, bbh in mc.bbox]  # == template extents
        modes = _lane_modes(mc, frame_shape, extents, config)
        frame_padded = torch.nn.functional.pad(frame, (0, bw - 1, 0, bh - 1))
        local = []
        for k, ((_, b, _), (th, tw)) in enumerate(zip(modes, extents)):
            x0 = min(b.min_tx, frame_w - tw + 1 - span_x)
            y0 = min(b.min_ty, frame_h - th + 1 - span_y)
            scores = region_fn(frame_padded, mc.template[k], mc.t_mean[k], mc.t_std[k], th, tw,
                               x0, y0)
            local.append(search_ops.masked_region_best(scores, x0, y0, b))
        glob = None
        if any(ga for _, _, ga in modes):
            rows = []
            for k, (th, tw) in enumerate(extents):
                m = full_fn(frame, mc.template[k], mc.t_mean[k], mc.t_std[k], th, tw)
                m = m.clone()
                m[frame_h - th + 1 :, :] = float("-inf")
                m[:, frame_w - tw + 1 :] = float("-inf")
                rows.append(search_ops.best_rows(m))
            glob = torch.stack(rows)
        best = _read_best(torch.stack(local), glob, modes)
        keep = torch.zeros(mc.template.shape, dtype=torch.bool, device=mc.template.device)
        for k, (th, tw) in enumerate(extents):
            keep[k, :th, :tw] = True
        return _update_lanes(mc, frame_padded, best, modes, extents, frame_shape, config,
                             False, bucket_mask=keep)

    return multi_step
