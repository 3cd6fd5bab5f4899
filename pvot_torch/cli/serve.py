"""pvot-torch-serve: track S video streams, or K objects in one stream,
concurrently on one card (the port of pvot/cli/serve.py).

Drives pvot_torch.io.serving.serve_streams: one decode thread per stream,
every chunk of every stream through the multi-stream CUDA kernel, global
search on the card.  A geometry outside the kernel's envelope (a search span
over 512, a template side over 256) serves on the per-frame engine that
--scan-backend names (default pallas_shear: the CUDA engine, K4 and K5), as
pvot-serve does.  Headless: ROIs come from --roi, one shared by all
streams or one per stream, or default to each synthetic stream's known
target.  Homogeneous inputs (one frame size, one ROI size) serve through the
stacked layout (pvot_torch.parallel.multi.init_multi_state); mixed frame or
ROI sizes serve through geometry groups (serve_streams_grouped).  Several
--roi over ONE stream select objects mode: K trackers over that stream
through the multi-object CUDA kernel (serve_objects), mixed ROI sizes in the
bucketed layout (init_multi_state_bucketed); a K-object --resume checkpoint
over one stream resumes it.

--fast serves at the kernels' bf16 score tier of --score-passes (3 unless
given), as pvot-serve does; --score-passes without --fast exits with code 2
(pvot-serve ignores it there).  --devices N spreads the streams over the
first N devices of --device's kind (N CUDA devices, or the CPU N times), in
contiguous groups, one host thread a group, as pvot-serve --devices does;
objects mode serves its one stream on the first.  Video files need OpenCV,
which the card's machine does not have: there, serve --synthetic streams.

Examples:
  pvot-torch-serve cam0.mp4 cam1.mp4 cam2.mp4 --roi 600,320,80,80
  pvot-torch-serve --synthetic 1280x720x300 --streams 8
  pvot-torch-serve --synthetic 1280x720x300 --streams 8 --fast --score-passes 1
  pvot-torch-serve --synthetic 1280x720x300 --streams 1 --roi 600,320,80,80 --roi 100,90,64,48
  pvot-torch-serve --synthetic 1280x720x300 --streams 2 --search-radius 300 --scan-backend shared
  pvot-torch-serve --synthetic 1280x720x300 --streams 8 --devices 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from pvot_torch.ops.backends import MODE_TO_BACKEND


def parse_args(argv: List[str]):
    p = argparse.ArgumentParser(
        prog="pvot-torch-serve",
        description="Serve S video streams on one card (multi-stream CUDA kernel)",
    )
    p.add_argument("videos", nargs="*", help="one video path per stream")
    p.add_argument(
        "--synthetic", metavar="WxHxF", default=None,
        help="synthetic streams (distinct trajectories) instead of files",
    )
    p.add_argument(
        "--streams", type=int, default=4,
        help="stream count with --synthetic (files set it by count)",
    )
    p.add_argument(
        "--roi", action="append", default=None, metavar="X,Y,W,H",
        help="template box; give once (shared) or once per stream. "
             "Defaults to each synthetic stream's known target",
    )
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="chunks in flight before the oldest one's records are read "
             "(1 = synchronous)",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="score at the kernels' bf16 tier (see --score-passes); like every fast "
             "engine, its trajectory equals the float32 one only as far as a run shows",
    )
    p.add_argument(
        "--score-passes", type=int, default=None, choices=(1, 2, 3),
        help="bf16 passes of the --fast tier: 3 = hi/lo (default), 2 and 1 trade "
             "score precision for speed; needs --fast",
    )
    p.add_argument(
        "--scan-backend", default="pallas_shear", choices=sorted(MODE_TO_BACKEND),
        help="per-frame engine for geometries outside the kernel's envelope "
             "(pvot_torch.ops.backends names)",
    )
    p.add_argument("--search-radius", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument(
        "--device", default="cuda",
        help="torch device to serve on (cpu runs the kernels' plain versions)",
    )
    p.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="spread the streams over the first N devices of --device's kind "
             "(contiguous groups, one host thread each, records unchanged; "
             "0 = --device only)",
    )
    p.add_argument(
        "--trajectory-out", default=None, metavar="PREFIX",
        help="write per-stream JSON-lines trajectories to PREFIX.s<K>.jsonl "
             "(objects mode: per object, PREFIX.o<K>.jsonl)",
    )
    p.add_argument(
        "--checkpoint-out", default=None,
        help="save the final stacked tracker states (all streams, one .npz)",
    )
    p.add_argument(
        "--resume", default=None,
        help="resume every stream from a stacked-state .npz "
             "(saved by --checkpoint-out) instead of --roi templates; "
             "frames then start at each stream's current position",
    )
    args = p.parse_args(argv)
    if not args.videos and not args.synthetic:
        p.error("give video paths or --synthetic WxHxF")
    if args.videos and args.synthetic:
        p.error("--synthetic and video paths are mutually exclusive")
    return args


def _parse_roi(text: str):
    try:
        x, y, w, h = (int(v) for v in text.split(","))
    except ValueError:
        raise SystemExit(f"Invalid --roi {text!r}: expected X,Y,W,H")
    if w <= 0 or h <= 0:
        raise SystemExit(f"Invalid --roi {text!r}: W and H must be positive")
    return x, y, w, h


def _limit(it, n: int):
    if n <= 0:
        yield from it
        return
    for i, frame in enumerate(it):
        if i >= n:
            return
        yield frame


def _tier(args) -> dict:
    """serve_streams / serve_objects keywords of the score tier."""
    from pvot_torch.ops.ncc_reference import cli_tier

    return cli_tier(args.fast, args.score_passes)


def _devices(args) -> list:
    """--device, or with --devices N the first N devices of its kind (the CPU
    N times), as pvot-serve slices jax.devices()[:N]."""
    import torch

    if args.devices <= 0:
        return [args.device]
    kind = torch.device(args.device).type
    if kind == "cpu":
        return ["cpu"] * args.devices
    present = torch.cuda.device_count() if kind == "cuda" else 0
    if args.devices > present:
        raise SystemExit(f"--devices {args.devices}: {present} {kind} devices present")
    return [f"{kind}:{i}" for i in range(args.devices)]


def _serve_kw(args) -> dict:
    """The keywords every serving entry point takes from the command line."""
    return dict(scan_backend=args.scan_backend, chunk_size=args.chunk_size,
                pipeline_depth=args.pipeline_depth, devices=_devices(args),
                **_tier(args))


def _on_devices(devices: list) -> str:
    return f", {len(devices)} devices" if len(devices) > 1 else ""


def _print_host() -> None:
    """The native host library's build: with it the frame rings are
    libpvot's, without it Python deques (FramePipeline.ring)."""
    from pvot_torch.runtime import native

    info = native.build_info()
    ring = "native" if info["built"] else "python"
    print(f"Host path: frame ring {ring}, native library {json.dumps(info)}")


def _config(args):
    from pvot_torch.config import TrackerConfig

    radius = ({"search_radius_x": args.search_radius, "search_radius_y": args.search_radius}
              if args.search_radius is not None else {})
    return TrackerConfig(**radius).validate()


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    try:
        _devices(args)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    if args.score_passes is not None and not args.fast:
        print("--score-passes sets the passes of the --fast tier: it needs --fast",
              file=sys.stderr)
        return 2
    if args.resume and args.roi:
        print("--roi and --resume are mutually exclusive: templates and "
              "boxes come from the checkpoint", file=sys.stderr)
        return 2

    from pvot_torch.io.gray import bgr_to_gray_u8, gray_u8_to_f32

    closers = []

    def _fail(msg: str) -> int:
        # Error exit after decoders may be open: close them, don't leak.
        for c in closers:
            c.close()
        print(msg, file=sys.stderr)
        return 2

    if args.synthetic:
        from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_frames, target_bbox

        try:
            w, h, f = (int(v) for v in args.synthetic.lower().split("x"))
        except ValueError:
            return _fail(f"Invalid --synthetic {args.synthetic!r}: expected WxHxF")
        specs = [SyntheticSpec(width=w, height=h, num_frames=f, seed=1 + s)
                 for s in range(args.streams)]
        firsts, feeds, default_rois = [], [], []
        for spec in specs:
            gen = generate_gray_frames(spec)
            if not args.resume:  # frame 0 seeds the template
                firsts.append(next(gen))
                default_rois.append(target_bbox(spec, 0))
            feeds.append(_limit(gen, args.max_frames))
        frame_shapes = [(h, w)] * len(feeds)
    else:
        from pvot_torch.io.video import VideoReader

        readers = []
        for path in args.videos:
            try:
                readers.append(VideoReader(path))
                closers.append(readers[-1])
            except (IOError, RuntimeError) as e:
                return _fail(f"Cannot open video {path!r}: {e}")
        frame_shapes = [(r.size[1], r.size[0]) for r in readers]
        firsts, feeds, default_rois = [], [], []
        for r in readers:
            if not args.resume:  # frame 0 seeds the template
                first = r.read()
                if first is None:
                    return _fail(f"Empty video: {r.path}")
                firsts.append(bgr_to_gray_u8(first))
                default_rois.append(None)
            feeds.append(_limit(iter(r), args.max_frames))
    n_streams = len(feeds)

    if args.resume:
        from pvot_torch.utils.checkpoint import load_state

        per_stream = [f"{args.resume}.s{s}.npz" for s in range(n_streams)]
        try:
            if all(os.path.exists(p) for p in per_stream):
                # Heterogeneous checkpoints are one file per stream.
                states_list = [load_state(p, args.device) for p in per_stream]
                return _run_serving_grouped(args, feeds, states_list, frame_shapes, closers)
            states = load_state(args.resume, args.device)
        except (OSError, ValueError, KeyError) as e:
            return _fail(f"Cannot resume from {args.resume!r}: {e}")
        if states.t_mean.ndim == 0:
            # A single-stream checkpoint: serve it as a one-stream stacked state.
            from pvot_torch.parallel.multi import stack_states

            states = stack_states([states], args.device)
        saved = int(states.t_mean.shape[0])
        if n_streams == 1 and saved > 1:
            # A K-object checkpoint over one stream resumes objects mode.
            return _run_objects(args, feeds[0], states, frame_shapes[0], closers)
        if saved != n_streams:
            return _fail(f"--resume checkpoint holds {saved} stream states for "
                         f"{n_streams} streams")
        if len(set(frame_shapes)) > 1:
            return _fail("--resume of one stacked checkpoint needs one frame size")
        return _run_serving(args, feeds, states, frame_shapes[0], closers)

    # With ONE stream, several --roi select objects mode: K trackers over it.
    objects_mode = False
    if args.roi:
        try:
            rois = [_parse_roi(t) for t in args.roi]
        except SystemExit as e:  # invalid --roi after decoders opened
            return _fail(str(e))
        if n_streams == 1 and len(rois) > 1:
            objects_mode = True
        elif len(rois) == 1:
            rois = rois * n_streams
        elif len(rois) != n_streams:
            hint = "pass --streams 1" if args.synthetic else "give exactly one video path"
            return _fail(f"Got {len(rois)} --roi for {n_streams} streams "
                         "(give one, or one per stream; for objects mode, "
                         f"{len(rois)} trackers over ONE stream, {hint})")
    elif all(r is not None for r in default_rois):
        rois = default_rois
    else:
        return _fail("File streams need --roi (serving is headless)")
    hetero_rois = len({(rw, rh) for _, _, rw, rh in rois}) > 1

    for s, (x, y, rw, rh) in enumerate(rois):
        fh, fw = frame_shapes[0 if objects_mode else s]
        if x < 0 or y < 0 or x + rw > fw or y + rh > fh:
            return _fail(f"--roi {x},{y},{rw},{rh} (stream {s}) lies outside the "
                         f"{fw}x{fh} frame")
    template_firsts = firsts * len(rois) if objects_mode else firsts
    templates = [gray_u8_to_f32(first)[y : y + rh, x : x + rw]
                 for first, (x, y, rw, rh) in zip(template_firsts, rois)]
    from pvot_torch.parallel import multi

    if objects_mode:
        # Mixed template sizes over one stream: the bucketed layout.
        init = multi.init_multi_state_bucketed if hetero_rois else multi.init_multi_state
        return _run_objects(args, feeds[0], init(templates, rois, device=args.device),
                            frame_shapes[0], closers)
    if hetero_rois or len(set(frame_shapes)) > 1:
        from pvot_torch.tracker.state import init_state

        states_list = [init_state(t, r, args.device) for t, r in zip(templates, rois)]
        return _run_serving_grouped(args, feeds, states_list, frame_shapes, closers)
    return _run_serving(args, feeds, multi.init_multi_state(templates, rois, args.device),
                        frame_shapes[0], closers)


def _report(outs, elapsed: float) -> None:
    total = 0
    for s, out in enumerate(outs):
        n = out.bbox.shape[0]
        total += n
        score = float(np.mean(out.score)) if n else float("nan")
        print(f"stream {s}: frames={n}, updated={int(out.updated.sum())}, "
              f"global={int(out.used_global.sum())}, mean_score={score:.4f}, "
              f"final_bbox={out.bbox[-1].tolist() if n else None}")
    fps = total / elapsed if elapsed > 0 else 0.0
    # Aggregate summary in the reference's summary spelling (main.cpp:485-488)
    # extended with the stream count.
    print(f"Serving summary: streams={len(outs)}, frames={total}, "
          f"time={elapsed:.6g} s, aggregate FPS={fps:.6g}")


def _write_trajectories(prefix: str, outs) -> None:
    for s, out in enumerate(outs):
        with open(f"{prefix}.s{s}.jsonl", "w") as f:
            for i in range(out.bbox.shape[0]):
                f.write(json.dumps({
                    "stream": s,
                    "frame": 1 + i,
                    "bbox": np.asarray(out.bbox[i]).tolist(),
                    "score": round(float(out.score[i]), 6),
                    "used_global": bool(out.used_global[i]),
                    "updated": bool(out.updated[i]),
                }) + "\n")
    print(f"Trajectories written: {prefix}.s*.jsonl")


def _run_objects(args, feed, states, frame_shape, closers) -> int:
    """K trackers over one stream (pvot/cli/serve.py:347 `_run_objects`):
    pvot_torch.io.serving.serve_objects."""
    from pvot_torch.io.serving import serve_objects
    from pvot_torch.ops.ncc_reference import tier_name
    from pvot_torch.utils.checkpoint import save_state

    k = int(states.t_mean.shape[0])
    th = int(states.bbox_h.max())  # the bucket's extent, when the sizes are mixed
    tw = int(states.bbox_w.max())
    print(f"Serving 1 stream x {k} objects at {frame_shape[1]}x{frame_shape[0]}, "
          f"template {tw}x{th}, chunk {args.chunk_size}, tier {tier_name(**_tier(args))}, "
          f"device {args.device}")
    kw = _serve_kw(args)
    kw["devices"] = kw["devices"][:1]  # one stream runs on one device
    t0 = time.perf_counter()
    try:
        final, out = serve_objects(feed, states, frame_shape, _config(args), **kw)
        elapsed = time.perf_counter() - t0
    finally:  # decoder handles must not leak if the stream raises mid-serve
        for c in closers:
            c.close()
    n = out.bbox.shape[0]
    for i in range(k):
        score = float(np.mean(out.score[:, i])) if n else float("nan")
        print(f"object {i}: frames={n}, updated={int(out.updated[:, i].sum())}, "
              f"global={int(out.used_global[:, i].sum())}, mean_score={score:.4f}, "
              f"final_bbox={out.bbox[-1, i].tolist() if n else None}")
    rate = n * k / elapsed if elapsed > 0 else 0.0
    print(f"Serving summary: objects={k}, frames={n}, time={elapsed:.6g} s, "
          f"object-updates/s={rate:.6g}")
    _print_host()
    if args.trajectory_out:
        for i in range(k):
            with open(f"{args.trajectory_out}.o{i}.jsonl", "w") as f:
                for j in range(n):
                    f.write(json.dumps({
                        "object": i,
                        "frame": 1 + j,
                        "bbox": np.asarray(out.bbox[j, i]).tolist(),
                        "score": round(float(out.score[j, i]), 6),
                        "used_global": bool(out.used_global[j, i]),
                        "updated": bool(out.updated[j, i]),
                    }) + "\n")
        print(f"Trajectories written: {args.trajectory_out}.o*.jsonl")
    if args.checkpoint_out:
        path = save_state(args.checkpoint_out, final)
        print(f"Checkpoint saved: {path} ({k} object states)")
    return 0


def _run_serving(args, feeds, states, frame_shape, closers) -> int:
    from pvot_torch.io.serving import serve_streams
    from pvot_torch.ops.ncc_reference import tier_name
    from pvot_torch.utils.checkpoint import save_state

    th, tw = states.template.shape[-2:]
    kw = _serve_kw(args)
    print(f"Serving {len(feeds)} streams at {frame_shape[1]}x{frame_shape[0]}, "
          f"template {tw}x{th}, chunk {args.chunk_size}, tier {tier_name(**_tier(args))}, "
          f"device {args.device}" + _on_devices(kw["devices"]))
    t0 = time.perf_counter()
    try:
        final, outs = serve_streams(feeds, states, frame_shape, _config(args), **kw)
        elapsed = time.perf_counter() - t0
    finally:  # decoder handles must not leak if a stream raises mid-serve
        for c in closers:
            c.close()
    _report(outs, elapsed)
    _print_host()
    if args.trajectory_out:
        _write_trajectories(args.trajectory_out, outs)
    if args.checkpoint_out:
        path = save_state(args.checkpoint_out, final)
        print(f"Checkpoint saved: {path} ({len(feeds)} stream states)")
    return 0


def _run_serving_grouped(args, feeds, states_list, frame_shapes, closers) -> int:
    from pvot_torch.io.serving import serve_streams_grouped
    from pvot_torch.ops.ncc_reference import tier_name
    from pvot_torch.utils.checkpoint import save_state

    shapes = sorted({(fs, tuple(st.template.shape)) for fs, st in zip(frame_shapes, states_list)})
    groups = ", ".join(f"{fw}x{fh}/t{tw}x{th}" for (fh, fw), (th, tw) in shapes)
    kw = _serve_kw(args)
    print(f"Serving {len(feeds)} streams in {len(shapes)} geometry groups ({groups}), "
          f"chunk {args.chunk_size}, tier {tier_name(**_tier(args))}, device {args.device}"
          + _on_devices(kw["devices"]))
    t0 = time.perf_counter()
    try:
        finals, outs = serve_streams_grouped(
            feeds, states_list, frame_shapes, _config(args), **kw,
        )
        elapsed = time.perf_counter() - t0
    finally:
        for c in closers:
            c.close()
    _report(outs, elapsed)
    _print_host()
    if args.trajectory_out:
        _write_trajectories(args.trajectory_out, outs)
    if args.checkpoint_out:
        # One file per stream: heterogeneous states cannot stack.
        for s, final in enumerate(finals):
            save_state(f"{args.checkpoint_out}.s{s}.npz", final)
        print(f"Checkpoints saved: {args.checkpoint_out}.s<K>.npz ({len(feeds)} "
              f"per-stream states; resume with --resume {args.checkpoint_out})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
