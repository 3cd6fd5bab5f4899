"""pvot-torch: track one video on one card (the port of pvot/cli/main.py's
headless surface).

    pvot-torch [video] [--cpu|--shared|--const|--const_tiled|--mega|--auto|
               --fast|--pallas_fast] [--batch=N] [--record] [--first]
               --roi X,Y,W,H

plus --start-frame, --output, --max-frames, --synthetic WxHxF, --strategy,
--chunk-size, the radius and confidence knobs, --no-global-search,
--stage-timing, --trajectory-out, --checkpoint-out, --resume, and --device
(default cuda; cpu runs the kernels' plain versions), as pvot-torch-serve
has it.  A mode flag resolves through pvot_torch.ops.backends (the default,
"cuda", is the reference's naive-kernel mode: the `xla` engine; --fast and
--pallas_fast are the fast engines, their region scores at 3 bf16 passes);
an engine flag composes with --batch=N as in the JAX CLI, and --mega with
--batch=N runs the chunk kernel's in-kernel cadence.  Output naming matches
the reference (output/<base>_<mode>[_<batch>]<ext>).

Not ported, each exits with code 2 and names its ROADMAP item: --host
(A11), the GUI ROI selection that the JAX CLI opens without --roi, and its
live display window (A11).  --record needs OpenCV, which the card's machine
does not have.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from pvot_torch.config import TrackerConfig

_MODE_FLAGS = {
    "--cpu": "cpu",
    "--shared": "shared",
    "--const": "const",
    "--const_tiled": "const_tiled",
    "--mega": "mega",
    "--auto": "auto",
    "--fast": "fast",
    "--pallas_fast": "pallas_fast",
}
# Mode flags of the JAX CLI that the port does not have yet.
_NOT_PORTED = {
    "--host": "the host engine, pvot/models/host.py (ROADMAP A11)",
}


def generate_output_path(video_path: str, mode: str, batch_size: int) -> str:
    """Port of generate_output_path (tracker_ghc/src/main.cpp:28-47)."""
    base = os.path.basename(video_path)
    root, ext = os.path.splitext(base)
    if not ext:
        ext, root = ".mp4", base
    os.makedirs("output", exist_ok=True)
    filename = f"output/{root}_{mode}"
    if mode == "batch" and batch_size > 0:
        filename += f"_{batch_size}"
    return filename + ext


def parse_args(argv: List[str]):
    """The reference's flag spelling (--batch=N, the mode flags) alongside
    the extended options; not-ported flags are kept in args.not_ported."""
    engine = None
    batch_size = 0
    not_ported = []
    passthrough = []
    for arg in argv:
        if arg in _MODE_FLAGS:
            engine = _MODE_FLAGS[arg]
        elif arg in _NOT_PORTED:
            not_ported.append(arg)
        elif arg.startswith("--batch="):
            batch_size = max(1, int(arg.split("=", 1)[1] or 1))
        else:
            passthrough.append(arg)
    p = argparse.ArgumentParser(prog="pvot-torch", description=__doc__.split("\n\n")[0])
    p.add_argument("video", nargs="?", default="data/car.mp4")
    p.add_argument("--record", action="store_true", help="write annotated video")
    p.add_argument("--first", action="store_true", help="template from first frame")
    p.add_argument("--roi", type=str, default=None, help="X,Y,W,H template box")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--synthetic", type=str, default=None, metavar="WxHxF")
    p.add_argument("--strategy", choices=["fused", "full"], default="fused")
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument("--search-radius", type=int, default=None)
    p.add_argument("--search-radius-x", type=int, default=TrackerConfig.search_radius_x)
    p.add_argument("--search-radius-y", type=int, default=TrackerConfig.search_radius_y)
    p.add_argument("--min-confidence", type=float, default=TrackerConfig.min_confidence)
    p.add_argument("--global-confidence", type=float, default=TrackerConfig.global_confidence)
    p.add_argument("--strong-confidence", type=float, default=TrackerConfig.strong_confidence)
    p.add_argument("--template-update-lr", type=float, default=TrackerConfig.template_update_lr)
    p.add_argument("--lost-frame-threshold", type=int,
                   default=TrackerConfig.lost_frame_threshold)
    p.add_argument("--no-global-search", action="store_true",
                   help="disable lost-object re-acquisition")
    p.add_argument("--no-display", action="store_true", help="never open GUI windows")
    p.add_argument("--stage-timing", action="store_true",
                   help="print the Windows-tree summary block")
    p.add_argument("--trajectory-out", type=str, default=None,
                   help="write per-frame results as JSON lines")
    p.add_argument("--checkpoint-out", type=str, default=None,
                   help="save the final tracker state to this .npz")
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a tracker-state .npz instead of selecting a ROI")
    p.add_argument("--device", default="cuda",
                   help="torch device to track on (cpu runs the kernels' plain versions)")
    args = p.parse_args(passthrough)
    args.not_ported = not_ported
    args.batch_size = batch_size
    args.mode = "batch" if batch_size else (engine or "cuda")
    args.engine = engine or "cuda"
    if args.search_radius is not None:
        args.search_radius_x = args.search_radius_y = args.search_radius
    return args


def _config_from_args(args) -> TrackerConfig:
    return TrackerConfig(
        search_radius_x=args.search_radius_x,
        search_radius_y=args.search_radius_y,
        batch_size=args.batch_size or TrackerConfig.batch_size,
        min_confidence=args.min_confidence,
        global_confidence=args.global_confidence,
        strong_confidence=args.strong_confidence,
        template_update_lr=args.template_update_lr,
        lost_frame_threshold=args.lost_frame_threshold,
        enable_global_search=not args.no_global_search,
    ).validate()


class FrameSource:
    """Re-iterable BGR frame source (file or synthetic), re-decoded from the
    start offset on every pass (pvot/cli/main.py:174)."""

    def __init__(self, args):
        self.spec = None
        self.path = args.video
        if args.synthetic:
            from pvot_torch.io.synthetic import SyntheticSpec

            try:
                w, h, f = (int(v) for v in args.synthetic.lower().split("x"))
            except ValueError:
                print(f"Invalid --synthetic {args.synthetic!r}: expected WxHxF, "
                      "e.g. 1280x720x300", file=sys.stderr)
                raise SystemExit(2)
            self.spec = SyntheticSpec(width=w, height=h, num_frames=f)
            self.fps = 30.0
            self.shape = (h, w)
        else:
            from pvot_torch.io.video import VideoReader

            try:
                with VideoReader(self.path) as r:
                    self.fps = r.fps
                    w, h = r.size
            except (IOError, RuntimeError):
                print(f"Cannot open video: {self.path}", file=sys.stderr)
                raise SystemExit(-1)
            self.shape = (h, w)

    def frames(self, start: int = 0, limit: Optional[int] = None):
        """Yield uint8 BGR frames [start, start + limit)."""
        import itertools

        stop = None if limit is None else start + limit
        if self.spec is not None:
            from pvot_torch.io.synthetic import generate_bgr_frames

            yield from itertools.islice(generate_bgr_frames(self.spec), start, stop)
            return
        from pvot_torch.io.video import VideoReader

        with VideoReader(self.path) as r:
            yield from itertools.islice(iter(r), start, stop)

    def nth_frame(self, idx: int) -> Optional[np.ndarray]:
        """Frame idx, or the last frame when the clip is shorter."""
        last = None
        for last in self.frames(0, idx + 1):
            pass
        return last


def per_frame_fps(timings, n_frames: int, fallback: float) -> np.ndarray:
    """Per-chunk (n_frames, seconds) timings -> a per-frame FPS array for the
    on-frame overlay (pvot/cli/main.py:362)."""
    fps = np.full((n_frames,), fallback, np.float64)
    i = 0
    for n, dt in timings:
        n = min(int(n), n_frames - i)
        if n <= 0:
            break
        fps[i : i + n] = (n / dt) if dt > 0 else fallback
        i += n
    return fps


def _select_roi(args, source: FrameSource):
    """(start frame, roi, template frame) from --roi; the JAX CLI's GUI
    selector is not ported."""
    start = 0 if args.first else args.start_frame
    if not args.roi:
        print("GUI ROI selection is not ported to pvot_torch yet (ROADMAP A11): "
              "pass --roi X,Y,W,H", file=sys.stderr)
        raise SystemExit(2)
    try:
        x, y, w, h = (int(v) for v in args.roi.split(","))
    except ValueError:
        print(f"Invalid --roi {args.roi!r}: expected X,Y,W,H integers", file=sys.stderr)
        raise SystemExit(2)
    fh, fw = source.shape
    if w <= 0 or h <= 0:
        print("No template selected", file=sys.stderr)
        raise SystemExit(-1)
    if x < 0 or y < 0 or x + w > fw or y + h > fh:
        print(f"--roi {args.roi} lies outside the {fw}x{fh} frame", file=sys.stderr)
        raise SystemExit(2)
    frame = source.nth_frame(start)
    if frame is None:
        print(f"Cannot open video: {source.path}", file=sys.stderr)
        raise SystemExit(-1)
    return start, (x, y, w, h), frame


def _draw(frame_bgr: np.ndarray, bbox, fps: Optional[float] = None) -> None:
    import cv2

    x, y, w, h = (int(v) for v in bbox)
    cv2.rectangle(frame_bgr, (x, y), (x + w, y + h), (0, 255, 0), 2)
    if fps is not None:
        cv2.putText(frame_bgr, f"FPS: {fps:.1f}", (20, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                    (0, 255, 0), 2)


def run_tracking(args) -> int:
    from pvot_torch.io.gray import bgr_to_gray_u8, gray_u8_to_f32
    from pvot_torch.io.pipeline import track_stream, track_stream_batched
    from pvot_torch.tracker.state import init_state

    for flag in args.not_ported:
        print(f"{flag}: {_NOT_PORTED[flag]} is not ported to pvot_torch yet", file=sys.stderr)
        return 2
    if not args.record and not args.no_display and os.environ.get("DISPLAY"):
        print("the live display window is not ported to pvot_torch yet (ROADMAP A11): "
              "pass --no-display or --record", file=sys.stderr)
        return 2
    config = _config_from_args(args)
    source = FrameSource(args)
    if args.resume:
        from pvot_torch.utils.checkpoint import load_state

        state = load_state(args.resume, device=args.device)
        roi = tuple(int(v) for v in (state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h))
        track_from = 0  # frame 0 is tracked, not a template source
        template_frame = source.nth_frame(0)
    else:
        start, roi, template_frame = _select_roi(args, source)
        track_from = start + 1
        x, y, w, h = roi
        templ = gray_u8_to_f32(bgr_to_gray_u8(template_frame))[y : y + h, x : x + w]
        state = init_state(templ, roi, device=args.device)

    suffix = ""
    if args.mode == "batch":
        suffix = f" (batch size: {args.batch_size}"
        suffix += f", engine: {args.engine})" if args.engine != "cuda" else ")"
    print(f"Tracking mode: {args.mode}{suffix}")
    output_path = None
    if args.record:
        output_path = args.output or generate_output_path(
            args.video if not args.synthetic else "synthetic.mp4", args.mode, args.batch_size)
        print(f"Output video: {output_path}")

    limit = args.max_frames if args.max_frames else None
    print("Tracking...")
    t_start = time.perf_counter()
    frame_iter = source.frames(track_from, limit)
    chunk_timings: list = []
    if args.mode == "batch":
        final, out = track_stream_batched(
            frame_iter, state, source.shape, config, batch_size=args.batch_size,
            strategy=args.strategy, backend=args.engine, timings=chunk_timings)
    else:
        final, out = track_stream(
            frame_iter, state, source.shape, config=config, strategy=args.strategy,
            backend=args.mode, chunk_size=args.chunk_size, timings=chunk_timings)
    elapsed = time.perf_counter() - t_start
    n_tracked = len(out.bbox)
    total_frames = n_tracked + 1  # + the template frame, like main.cpp:356
    avg_fps = total_frames / elapsed if elapsed > 0 else 0.0

    if args.record:
        from pvot_torch.io.video import VideoWriter

        fh, fw = source.shape
        with VideoWriter(output_path, source.fps, (fw, fh)) as writer:
            first = template_frame.copy()
            _draw(first, roi)
            writer.write(first)
            frame_fps = per_frame_fps(chunk_timings, n_tracked, avg_fps)
            for i, frame in enumerate(source.frames(track_from, n_tracked)):
                _draw(frame, out.bbox[i], frame_fps[i])
                writer.write(frame)

    if args.trajectory_out:
        with open(args.trajectory_out, "w") as f:
            for i in range(n_tracked):
                f.write(json.dumps({
                    "frame": track_from + i,
                    "bbox": out.bbox[i].tolist(),
                    "score": round(float(out.score[i]), 6),
                    "used_global": bool(out.used_global[i]),
                    "updated": bool(out.updated[i]),
                }) + "\n")
        print(f"Trajectory written: {args.trajectory_out}")
    if args.checkpoint_out:
        from pvot_torch.utils.checkpoint import save_state

        print(f"Checkpoint saved: {save_state(args.checkpoint_out, final)}")

    kind = "Recorded" if args.record else "Interactive"
    print(f"{kind} tracking summary: frames={total_frames}, time={elapsed:.6g} s, "
          f"FPS={avg_fps:.6g}")
    if args.stage_timing:
        t_total = time.perf_counter() - t_start
        print("\n--------")
        print(" Tracking Complete")
        print(f" Mode       : {args.mode}")
        print(f" Frames     : {total_frames}")
        print(f" Time (sec) : {t_total:.6g}")
        print(f" Computation Time (sec)  : {elapsed:.6g}")
        print(f" FPS        : {total_frames / t_total if t_total > 0 else 0.0:.6g}")
        print("--------")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    return run_tracking(args)


if __name__ == "__main__":
    raise SystemExit(main())
