"""Headline on the card: tracked frames/s at 720p with an 80x80 template.

The clip, geometry and correctness check are bench.py's: the synthetic
SyntheticSpec(1280, 720, 2049 frames, 80x80, seed=1), the target's bbox at
frame 0 as the initial state, 2048 tracked frames in chunks of 512, and
max_l1_err_px == 0 against the ground-truth bbox.  By default the port runs
the float32 tier (bench.py's `mega_highest=True`); `--fast` runs the bf16
tier of `--score-passes P` (3 unless given; bench.py's headline is
`mega_highest=False, mega_score_passes=1`, bench.py:78-88) on the main-path,
streams and objects lines.  Each line's `tier` names its tier as bench.py
does (bench.py:233-238).

Run with `python -m pvot_torch.bench`; it prints one JSON line, then one for
`--streams S` (S streams cut from the clip), one for `--objects K` (K
trackers over the clip, benchmarks/suite.py:813 `bench_multi_object_mega`)
and one for `--backend NAME` (the per-frame engine path, track_video with
that backend of pvot_torch.ops.backends).  It needs a CUDA device and fails
without one.

Protocol: the frames are staged on the card first (set-up, untimed).  The
checked run tracks the clip once with every launch counter at 0 and checks
the trajectory.  Then `passes` timed runs each track the whole clip from the
same initial state, between CUDA events; every timed run ends with the
records' copy to the host, so it covers all the tracking work.  The value is
the median run.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from pvot_torch.ops.ncc_reference import cli_tier, tier_name
from pvot_torch.runtime import native


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, the rate of the float32 tier's correlation;
# dense bf16 on the tensor cores, the rate of the bf16 tiers' passes; HBM3.
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def scored_windows(start_bbox, bboxes, used_global, frame_shape, templ_shape,
                   config) -> list:
    """The frame pixels each of one tracker's frames reads, as (x0, y0, w, h):
    its clamped local window around the box it starts from, the template's
    extent past the last position included, or the whole frame on a frame
    whose argmax ran global.  bboxes (F, 4) are the boxes after each frame,
    used_global (F,) the frames' flags."""
    from pvot_torch.ops.search import local_window_bounds

    (h, w), (th, tw) = frame_shape, templ_shape
    out_h, out_w = h - th + 1, w - tw + 1
    out = []
    bx, by, bw, bh = (int(v) for v in start_bbox)
    for box, glob in zip(np.asarray(bboxes).tolist(), np.asarray(used_global).tolist()):
        if glob:
            out.append((0, 0, w, h))
        else:
            b = local_window_bounds(bx + bw // 2, by + bh // 2, tw, th, out_w, out_h,
                                    config.search_radius_x, config.search_radius_y)
            out.append((b.min_tx, b.min_ty, b.max_tx - b.min_tx + tw, b.max_ty - b.min_ty + th))
        bx, by, bw, bh = (int(v) for v in box)
    return out


def scored_positions(start_bbox, bboxes, used_global, frame_shape, templ_shape,
                     config) -> int:
    """Score-map positions one tracker's frames need (scored_windows' windows
    less the template's extent)."""
    th, tw = templ_shape
    return sum((ww - tw + 1) * (wh - th + 1) for _, _, ww, wh in scored_windows(
        start_bbox, bboxes, used_global, frame_shape, templ_shape, config))


def union_pixels(rects) -> int:
    """Pixels covered by any of the rectangles (x0, y0, w, h): what lanes
    that share one frame read of it."""
    xs = sorted({v for x, _, w, _ in rects for v in (x, x + w)})
    ys = sorted({v for _, y, _, h in rects for v in (y, y + h)})
    return sum((x1 - x0) * (y1 - y0)
               for x0, x1 in zip(xs, xs[1:]) for y0, y1 in zip(ys, ys[1:])
               if any(x <= x0 and x1 <= x + w and y <= y0 and y1 <= y + h
                      for x, y, w, h in rects))


def bound_ms(fma: float, n_bytes: float, passes: int = 0) -> tuple:
    """(least milliseconds the card could take, what bounds it): the larger of
    the correlation's operations at their peak, 2 * fma FP32 operations at
    the FP32 peak (passes 0) or passes * 2 * fma bf16 operations at the bf16
    tensor-core peak, and n_bytes at the memory rate."""
    t_ops = 2.0 * fma * passes / BF16_FLOPS if passes else 2.0 * fma / FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def gpu_identity() -> tuple:
    """(nvidia-smi's "name, power.limit" line, power limit in W or None)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        watts = float(out.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        watts = None
    return out, watts


def bench_clip(num_frames: int = 2048, width: int = 1280, height: int = 720,
               templ: int = 80):
    """The bench.py clip and its initial state: (spec, frames (F+1, H, W))."""
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video

    spec = SyntheticSpec(width=width, height=height, num_frames=num_frames + 1,
                         target_w=templ, target_h=templ, seed=1)
    return spec, generate_gray_video(spec)


def state_at(spec, frames: np.ndarray, i: int, device):
    """Initial state from the ground-truth box at clip frame i."""
    from pvot_torch.io.gray import gray_u8_to_f32
    from pvot_torch.io.synthetic import target_bbox
    from pvot_torch.tracker.state import init_state

    x, y, w, h = target_bbox(spec, i)
    return init_state(gray_u8_to_f32(frames[i])[y : y + h, x : x + w], (x, y, w, h),
                      device=device)


def max_l1_err_px(spec, bbox: np.ndarray) -> int:
    """Largest |dx| + |dy| between tracked and ground-truth bbox over the
    tracked frames (frame i of `bbox` is clip frame i + 1)."""
    from pvot_torch.io.synthetic import target_bbox

    truth = np.array([target_bbox(spec, i + 1)[:2] for i in range(len(bbox))])
    return int(np.abs(bbox[:, :2] - truth).sum(axis=1).max())


def run_bench(num_frames: int = 2048, chunk_size: int = 512, passes: int = 5,
              clip=None, highest: bool = True, score_passes: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("pvot_torch.bench needs a CUDA device")
    from pvot_torch.config import TrackerConfig
    from pvot_torch.ops.ncc_mega import mega_track_chunk, reset_launches
    from pvot_torch.tracker.mega import track_video_mega

    dev = torch.device("cuda", 0)
    spec, frames = clip if clip is not None else bench_clip(num_frames)
    config = TrackerConfig()
    state = state_at(spec, frames, 0, dev)
    staged = torch.from_numpy(frames[1 : 1 + num_frames]).to(dev)
    torch.cuda.synchronize()

    tier = dict(highest=highest, score_passes=score_passes)
    reset_launches(mega_track_chunk)
    _, out = track_video_mega(staged, state, config, chunk_size=chunk_size, **tier)
    launches = mega_track_chunk.launches
    by_tier = dict(mega_track_chunk.launches_by_tier)
    err = max_l1_err_px(spec, out.bbox)

    times_ms = []
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, again = track_video_mega(staged, state, config, chunk_size=chunk_size, **tier)
        end.record()
        end.synchronize()
        times_ms.append(start.elapsed_time(end))
        if not np.array_equal(again.bbox, out.bbox):
            raise RuntimeError("a timed run's trajectory differs from the checked run's")
    med = statistics.median(times_ms)
    gpu, watts = gpu_identity()
    return {
        "metric": "tracked_fps_720p_80px",
        "value": num_frames / (med / 1000.0),
        "unit": "frames/s",
        "ms_per_frame": med / num_frames,
        "run_ms_median": med,
        "run_ms_all": times_ms,
        "frames_per_run": num_frames,
        "chunk_size": chunk_size,
        "max_l1_err_px": err,
        "all_updated": bool(out.updated.all()),
        "tier": tier_name(highest, score_passes),
        "gpu": torch.cuda.get_device_name(0),
        "gpu_smi": gpu,
        "power_limit_w": watts,
        "kernel_launches": launches,
        "kernel_launches_by_passes": by_tier,
    }


def stream_cuts(n_streams: int, total: int, lengths) -> list:
    """Offsets of S streams cut from one clip of `total` frames: stream s
    starts at clip frame offsets[s] (its template frame) and tracks
    lengths[s] frames after it; the offsets spread evenly over the clip."""
    spare = total - 1 - max(lengths)
    if spare < 0:
        raise ValueError(f"streams of {max(lengths)} frames do not fit a {total}-frame clip")
    step = spare // max(1, n_streams - 1)
    return [s * step for s in range(n_streams)]


def stream_states(spec, frames: np.ndarray, offsets, device):
    """Stacked initial state: stream s from its ground-truth box at frame offsets[s]."""
    from pvot_torch.parallel.multi import stack_states

    return stack_states([state_at(spec, frames, o, device) for o in offsets], device)


def stream_err_px(spec, offset: int, bbox: np.ndarray) -> int:
    """max_l1_err_px of one stream cut at `offset` (bbox[i] is clip frame
    offset + i + 1)."""
    from pvot_torch.io.synthetic import target_bbox

    truth = np.array([target_bbox(spec, offset + i + 1)[:2] for i in range(len(bbox))])
    return int(np.abs(bbox[:, :2] - truth).sum(axis=1).max(initial=0))


def run_bench_streams(n_streams: int, length: int = 1536, chunk_size: int = 512,
                      passes: int = 3, serve_chunk: int = 64, clip=None, highest: bool = True,
                      score_passes: int = 3) -> dict:
    """S streams of `length` frames cut at spread offsets from the bench clip
    (no second clip is generated), each from its ground-truth box.

    Device path: track_streams_mega over the streams staged on the card (a
    strided view of the one staged clip), checked once with the launch
    counter at 0, then `passes` runs timed with CUDA events (median).
    Serving path: serve_streams from the host clip through the decode
    threads, pinned staging and the copy stream, timed on the host clock
    (it ends when the last records are read)."""
    if not torch.cuda.is_available():
        raise RuntimeError("pvot_torch.bench needs a CUDA device")
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.serving import serve_streams
    from pvot_torch.ops.ncc_mega import mega_track_chunk_multi
    from pvot_torch.tracker.mega import track_streams_mega

    dev = torch.device("cuda", 0)
    spec, frames = clip if clip is not None else bench_clip()
    config = TrackerConfig()
    total, h, w = frames.shape
    offsets = stream_cuts(n_streams, total, [length] * n_streams)
    states = stream_states(spec, frames, offsets, dev)
    staged = torch.from_numpy(frames).to(dev)
    px = h * w
    videos = staged.as_strided((n_streams, length, h, w),
                               (px * (offsets[1] - offsets[0]) if n_streams > 1 else 0, px, w, 1),
                               px * (offsets[0] + 1))
    torch.cuda.synchronize()

    tier = dict(highest=highest, score_passes=score_passes)
    mega_track_chunk_multi.launches = 0
    _, out = track_streams_mega(videos, states, config, chunk_size=chunk_size, **tier)
    launches = mega_track_chunk_multi.launches
    errs = [stream_err_px(spec, o, out.bbox[:, s]) for s, o in enumerate(offsets)]
    times_ms = []
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, again = track_streams_mega(videos, states, config, chunk_size=chunk_size, **tier)
        end.record()
        end.synchronize()
        times_ms.append(start.elapsed_time(end))
        if not np.array_equal(again.bbox, out.bbox):
            raise RuntimeError("a timed run's trajectories differ from the checked run's")
    med = statistics.median(times_ms)

    timings: list = []
    t0 = time.perf_counter()
    _, served = serve_streams([iter(frames[o + 1 : o + 1 + length]) for o in offsets],
                              states, (h, w), config, chunk_size=serve_chunk, timings=timings,
                              **tier)
    serve_s = time.perf_counter() - t0
    serve_errs = [stream_err_px(spec, o, served[s].bbox) for s, o in enumerate(offsets)]
    if any(not np.array_equal(served[s].bbox, out.bbox[:, s]) for s in range(n_streams)):
        raise RuntimeError("serve_streams and track_streams_mega disagree")
    gpu, watts = gpu_identity()
    frames_all = n_streams * length
    return {
        "metric": f"tracked_fps_720p_80px_{n_streams}streams",
        "value": frames_all / (med / 1000.0),
        "unit": "frames/s, all streams",
        "per_stream_fps": length / (med / 1000.0),
        "run_ms_median": med,
        "run_ms_all": times_ms,
        "streams": n_streams,
        "frames_per_stream": length,
        "offsets": offsets,
        "chunk_size": chunk_size,
        "max_l1_err_px": max(errs),
        "kernel_launches": launches,
        "serve_fps": frames_all / serve_s,
        "serve_per_stream_fps": length / serve_s,
        "serve_s": serve_s,
        "serve_chunk": serve_chunk,
        "serve_chunks": len(timings),
        "serve_max_l1_err_px": max(serve_errs),
        "native_host": native.build_info(),
        "tier": tier_name(highest, score_passes),
        "gpu": torch.cuda.get_device_name(0),
        "gpu_smi": gpu,
        "power_limit_w": watts,
    }


def run_bench_objects(n_objects: int, num_frames: int = 2048, chunk_size: int = 512,
                      passes: int = 3, serve_chunk: int = 64, clip=None, highest: bool = True,
                      score_passes: int = 3) -> dict:
    """K trackers over the bench clip, all started on its ground-truth box so
    that every lane is checked against the ground truth
    (benchmarks/suite.py:813 `bench_multi_object_mega`).

    Device path: track_objects_mega over the clip staged on the card, checked
    once with the launch counter at 0, then `passes` runs timed with CUDA
    events (median).  Serving path: serve_objects from the host clip through
    the decode thread, pinned staging and the copy stream, timed on the host
    clock, and held equal to the device path."""
    if not torch.cuda.is_available():
        raise RuntimeError("pvot_torch.bench needs a CUDA device")
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.serving import serve_objects
    from pvot_torch.ops.ncc_mega import mega_track_chunk_objects
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.tracker.mega import track_objects_mega

    dev = torch.device("cuda", 0)
    spec, frames = clip if clip is not None else bench_clip(num_frames)
    config = TrackerConfig()
    h, w = frames.shape[1:]
    one = state_at(spec, frames, 0, dev)
    states = stack_states([one] * n_objects, dev)
    staged = torch.from_numpy(frames[1 : 1 + num_frames]).to(dev)
    torch.cuda.synchronize()

    tier = dict(highest=highest, score_passes=score_passes)
    mega_track_chunk_objects.launches = 0
    _, out = track_objects_mega(staged, states, config, chunk_size=chunk_size, **tier)
    launches = mega_track_chunk_objects.launches
    errs = [max_l1_err_px(spec, out.bbox[:, k]) for k in range(n_objects)]
    times_ms = []
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, again = track_objects_mega(staged, states, config, chunk_size=chunk_size, **tier)
        end.record()
        end.synchronize()
        times_ms.append(start.elapsed_time(end))
        if not np.array_equal(again.bbox, out.bbox):
            raise RuntimeError("a timed run's trajectories differ from the checked run's")
    med = statistics.median(times_ms)

    timings: list = []
    t0 = time.perf_counter()
    _, served = serve_objects(iter(frames[1 : 1 + num_frames]), states, (h, w), config,
                              chunk_size=serve_chunk, timings=timings, **tier)
    serve_s = time.perf_counter() - t0
    if not np.array_equal(served.bbox, out.bbox):
        raise RuntimeError("serve_objects and track_objects_mega disagree")
    th, tw = one.template.shape
    start_box = [int(v) for v in torch.stack(list(one.bbox)).tolist()]
    windows = [scored_windows(start_box, out.bbox[:, k], out.used_global[:, k], (h, w),
                              (th, tw), config) for k in range(n_objects)]
    fma = th * tw * sum((ww - tw + 1) * (wh - th + 1)
                        for lane in windows for _, _, ww, wh in lane)
    # The objects share each frame: it is read once, the union of their windows.
    n_bytes = (sum(union_pixels(rects) for rects in zip(*windows))
               + n_objects * (2 * th * tw * 4 + num_frames * 40))
    bound, bound_by = bound_ms(fma, n_bytes, 0 if highest else score_passes)
    gpu, watts = gpu_identity()
    fps = num_frames / (med / 1000.0)
    return {
        "metric": f"tracked_fps_720p_80px_{n_objects}objects",
        "value": fps,
        "unit": "clip frames/s, all objects tracked",
        "object_rate": fps * n_objects,
        "ms_per_step": med / num_frames,
        "run_ms_median": med,
        "run_ms_all": times_ms,
        "objects": n_objects,
        "frames": num_frames,
        "chunk_size": chunk_size,
        "max_l1_err_px": max(errs),
        "kernel_launches": launches,
        "bound_ms_per_step": bound / num_frames,
        "bound_by": bound_by,
        "serve_fps": num_frames / serve_s,
        "serve_s": serve_s,
        "serve_chunk": serve_chunk,
        "serve_chunks": len(timings),
        "native_host": native.build_info(),
        "tier": tier_name(highest, score_passes),
        "gpu": torch.cuda.get_device_name(0),
        "gpu_smi": gpu,
        "power_limit_w": watts,
    }


def run_bench_engine(backend: str, num_frames: int = 2048, passes: int = 3,
                     clip=None) -> dict:
    """The per-frame engine path over the bench clip: track_video(backend=)
    with the frames staged on the card, checked once with the launch and
    host-read counters at 0, then `passes` runs timed with CUDA events
    (median).  Every frame ends in the step's read of its argmax, so an
    event-timed run covers all of its work."""
    if not torch.cuda.is_available():
        raise RuntimeError("pvot_torch.bench needs a CUDA device")
    from pvot_torch.config import TrackerConfig
    from pvot_torch.ops.ncc_pallas import ncc_map_pallas, ncc_region_argmax_pallas
    from pvot_torch.tracker.scan import track_video
    from pvot_torch.tracker.step import host_read

    dev = torch.device("cuda", 0)
    spec, frames = clip if clip is not None else bench_clip(num_frames)
    config = TrackerConfig()
    state = state_at(spec, frames, 0, dev)
    staged = torch.from_numpy(frames[1 : 1 + num_frames]).to(dev)
    torch.cuda.synchronize()

    ncc_map_pallas.launches = ncc_region_argmax_pallas.launches = 0
    reads0 = host_read.count
    _, out = track_video(staged, state, config, backend=backend)
    reads = host_read.count - reads0
    k4, k5 = ncc_map_pallas.launches, ncc_region_argmax_pallas.launches
    times_ms = []
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, again = track_video(staged, state, config, backend=backend)
        end.record()
        end.synchronize()
        times_ms.append(start.elapsed_time(end))
        if not np.array_equal(again.bbox, out.bbox):
            raise RuntimeError("a timed run's trajectory differs from the checked run's")
    med = statistics.median(times_ms)
    gpu, watts = gpu_identity()
    return {
        "metric": f"tracked_fps_720p_80px_engine_{backend}",
        "value": num_frames / (med / 1000.0),
        "unit": "frames/s",
        "ms_per_frame": med / num_frames,
        "run_ms_median": med,
        "run_ms_all": times_ms,
        "frames_per_run": num_frames,
        "backend": backend,
        "max_l1_err_px": max_l1_err_px(spec, out.bbox),
        "global_frames": int(out.used_global.sum()),
        "k4_launches_per_frame": k4 / num_frames,
        "k5_launches_per_frame": k5 / num_frames,
        "host_reads_per_frame": reads / num_frames,
        # The fast engines score their regions at 3 bf16 passes, their global
        # maps in float32.
        "tier": tier_name(backend not in ("fast", "xla_fast", "pallas_fast")),
        "gpu": torch.cuda.get_device_name(0),
        "gpu_smi": gpu,
        "power_limit_w": watts,
    }


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m pvot_torch.bench", description=__doc__)
    p.add_argument("--streams", type=int, default=0, metavar="S",
                   help="also track S streams together and print their aggregate line")
    p.add_argument("--objects", type=int, default=0, metavar="K",
                   help="also track K objects over the clip and print their line")
    p.add_argument("--backend", default=None, metavar="NAME",
                   help="also track the clip on this per-frame engine and print its line")
    p.add_argument("--fast", action="store_true",
                   help="the chunk kernels' bf16 score tier (main-path, streams and objects "
                        "lines)")
    p.add_argument("--score-passes", type=int, default=None, choices=(1, 2, 3),
                   help="bf16 passes of the --fast tier (default 3); needs --fast")
    args = p.parse_args(argv)
    if args.score_passes is not None and not args.fast:
        p.error("--score-passes sets the passes of the --fast tier: it needs --fast")
    tier = cli_tier(args.fast, args.score_passes)
    t0 = time.perf_counter()
    clip = bench_clip()
    result = run_bench(clip=clip, **tier)
    result["wall_s"] = time.perf_counter() - t0
    print(json.dumps(result))
    if result["max_l1_err_px"] != 0:
        raise SystemExit("tracked trajectory is off the ground truth")
    if args.streams > 0:
        t0 = time.perf_counter()
        multi = run_bench_streams(args.streams, clip=clip, **tier)
        multi["wall_s"] = time.perf_counter() - t0
        print(json.dumps(multi))
        if multi["max_l1_err_px"] != 0 or multi["serve_max_l1_err_px"] != 0:
            raise SystemExit("a tracked stream is off the ground truth")
    if args.objects > 0:
        t0 = time.perf_counter()
        objects = run_bench_objects(args.objects, clip=clip, **tier)
        objects["wall_s"] = time.perf_counter() - t0
        print(json.dumps(objects))
        if objects["max_l1_err_px"] != 0:
            raise SystemExit("a tracked object is off the ground truth")
    if args.backend:
        t0 = time.perf_counter()
        engine = run_bench_engine(args.backend, clip=clip)
        engine["wall_s"] = time.perf_counter() - t0
        print(json.dumps(engine))
        if engine["max_l1_err_px"] != 0:
            raise SystemExit("the engine path is off the ground truth")


if __name__ == "__main__":
    main()
