"""pvot-torch: track one video on one card (the port of pvot/cli/main.py).

    pvot-torch [video] [--cpu|--shared|--const|--const_tiled|--mega|--auto|
               --fast|--pallas_fast|--host] [--batch=N] [--record] [--first]
               [--roi X,Y,W,H]

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

--host runs the accelerator-free host engine (pvot_torch.models.host: the
native C++ NCC, or its numpy twin where no toolchain builds it, and a host
loop; no tensor, no card) and says on stderr which NCC ran; it has no batch
mode, so --host with --batch=N exits with code 2, as in the JAX CLI.
Without --roi the JAX CLI's GUI opens: a frame preview (ENTER picks the
frame, ESC quits; --first skips it) and cv2.selectROI; a run with no DISPLAY,
or with --no-display, exits with code -1 and "DISPLAY not set".  With a
DISPLAY and neither --record nor --no-display, the tracked frames play in a
live window capped at 1280x720 (display_downscale).  The GUI, the live window
and --record need OpenCV, imported only when they run: the card's machine
does not have it.
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
    "--host": "host",
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
    the extended options."""
    engine = None
    batch_size = 0
    passthrough = []
    for arg in argv:
        if arg in _MODE_FLAGS:
            engine = _MODE_FLAGS[arg]
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
    args.batch_size = batch_size
    args.mode = "batch" if batch_size else (engine or "cuda")
    args.engine = engine or "cuda"
    if args.mode == "batch" and args.engine == "host":
        p.error("--host has no batch mode; drop --batch=N or the engine flag")
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


# Display cap of the reference demo (tracker_ghc/src/main.cpp:250-259).
_MAX_DISPLAY_W = 1280
_MAX_DISPLAY_H = 720


def display_downscale(frame_bgr: np.ndarray) -> np.ndarray:
    """A frame downscaled to fit 1280x720 for display, its aspect kept
    (pvot/cli/main.py:249: min(1, min(maxW/cols, maxH/rows)), INTER_AREA);
    the input itself when it fits."""
    h, w = frame_bgr.shape[:2]
    scale = min(1.0, min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h))
    if scale >= 1.0:
        return frame_bgr
    import cv2

    return cv2.resize(frame_bgr, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)


def _select_roi(args, source: FrameSource):
    """(start frame, roi, template frame) from --roi, or from the JAX CLI's
    GUI (pvot/cli/main.py:299-345): a frame preview where ENTER picks the
    frame and ESC quits (skipped with --first), then cv2.selectROI."""
    start = 0 if args.first else args.start_frame
    if args.roi:
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
        return start, (x, y, w, h), _nth_frame_or_exit(source, start)
    if args.no_display or not os.environ.get("DISPLAY"):
        print("DISPLAY not set\n(headless runs need --roi X,Y,W,H)", file=sys.stderr)
        raise SystemExit(-1)
    import cv2

    frame = None
    if not args.first:
        print("Use the preview window to pick a frame that contains the target object.\n"
              "Press ENTER to select the current frame. Press ESC to quit.")
        cv2.namedWindow("Frame Preview", cv2.WINDOW_NORMAL)
        idx = start - 1
        for frame in source.frames(start):
            idx += 1
            cv2.imshow("Frame Preview", frame)  # raw resolution, as the reference shows it
            key = cv2.waitKey(30)
            if key == 27:
                print("Template selection cancelled by user.")
                raise SystemExit(0)
            if key in (13, 10):
                break
        else:
            print("Reached End of Video.", file=sys.stderr)
            raise SystemExit(-1)
        cv2.destroyWindow("Frame Preview")
        start = idx
    if frame is None:
        frame = _nth_frame_or_exit(source, start)
    roi = cv2.selectROI("Select Template", frame, False, False)
    cv2.destroyWindow("Select Template")
    if roi[2] == 0 or roi[3] == 0:
        print("No template selected", file=sys.stderr)
        raise SystemExit(-1)
    return start, tuple(int(v) for v in roi), frame


def _nth_frame_or_exit(source: FrameSource, idx: int) -> np.ndarray:
    frame = source.nth_frame(idx)
    if frame is None:
        print(f"Cannot open video: {source.path}", file=sys.stderr)
        raise SystemExit(-1)
    return frame


def _draw(frame_bgr: np.ndarray, bbox, fps: Optional[float] = None) -> None:
    import cv2

    x, y, w, h = (int(v) for v in bbox)
    cv2.rectangle(frame_bgr, (x, y), (x + w, y + h), (0, 255, 0), 2)
    if fps is not None:
        cv2.putText(frame_bgr, f"FPS: {fps:.1f}", (20, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                    (0, 255, 0), 2)


def _replay(source: FrameSource, track_from: int, bboxes, frame_fps, first, first_roi,
            output_path: Optional[str] = None) -> None:
    """The drawing pass (pvot/cli/main.py:515-542): re-decode the tracked
    frames and draw each box and its FPS; write them to `output_path` after
    the template frame `first` with its box or, without a path, play them in
    a live window capped at 1280x720 (ESC stops it)."""
    writer = None
    if output_path:
        from pvot_torch.io.video import VideoWriter

        fh, fw = source.shape
        writer = VideoWriter(output_path, source.fps, (fw, fh))
        first = first.copy()
        _draw(first, first_roi)
        writer.write(first)
    else:
        import cv2
    try:
        for i, frame in enumerate(source.frames(track_from, len(bboxes))):
            _draw(frame, bboxes[i], frame_fps[i])
            if writer:
                writer.write(frame)
                continue
            cv2.imshow("Tracking", display_downscale(frame))
            if cv2.waitKey(1) == 27:
                break
    finally:
        if writer:
            writer.close()


def _track_host(frame_iter, templ: np.ndarray, roi, lost: int, use_global: bool, config,
                timings: list):
    """--host: the host engine's stream loop over numpy (no tensor touches a
    card), the final state as CPU tensors for --checkpoint-out.  Says on
    stderr which NCC ran: the native library or its numpy twin."""
    from pvot_torch.convert import state_from_numpy
    from pvot_torch.models.host import track_stream_host
    from pvot_torch.runtime import native
    from pvot_torch.tracker.state import StepOutput

    engine = "native C++ (libpvot)" if native.available() else "numpy (no native library)"
    print(f"Host NCC engine: {engine}", file=sys.stderr)
    final, out = track_stream_host(frame_iter, templ, roi, config, lost_count=lost,
                                   use_global=use_global, timings=timings)
    bx, by, bw, bh = final["bbox"]
    state = state_from_numpy(dict(
        bbox_x=bx, bbox_y=by, bbox_w=bw, bbox_h=bh, template=final["template"],
        t_mean=np.float32(final["t_mean"]), t_std=np.float32(final["t_std"]),
        lost_count=final["lost_count"], use_global=final["use_global"]), device="cpu")
    return state, StepOutput(**out)


def run_tracking(args) -> int:
    from pvot_torch.io.gray import bgr_to_gray_u8, gray_u8_to_f32
    from pvot_torch.io.pipeline import track_stream, track_stream_batched
    from pvot_torch.tracker.state import init_state

    config = _config_from_args(args)
    source = FrameSource(args)
    host = args.mode == "host"
    if args.resume:
        from pvot_torch.utils.checkpoint import load_state

        state = load_state(args.resume, device="cpu" if host else args.device)
        roi = tuple(int(v) for v in (state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h))
        track_from = 0  # frame 0 is tracked, not a template source
        template_frame = _nth_frame_or_exit(source, 0)
        templ = state.template.cpu().numpy()
    else:
        start, roi, template_frame = _select_roi(args, source)
        track_from = start + 1
        x, y, w, h = roi
        templ = gray_u8_to_f32(bgr_to_gray_u8(template_frame))[y : y + h, x : x + w]
        # --host stays device-free: its state is numpy (pvot/cli/main.py:419-425).
        state = None if host else init_state(templ, roi, device=args.device)

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
    if host:
        lost, useg = (0, False) if state is None else (int(state.lost_count),
                                                        bool(state.use_global))
        final, out = _track_host(frame_iter, templ, roi, lost, useg, config, chunk_timings)
    elif args.mode == "batch":
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

    if args.record or (not args.no_display and os.environ.get("DISPLAY")):
        _replay(source, track_from, out.bbox, per_frame_fps(chunk_timings, n_tracked, avg_fps),
                template_frame, roi, output_path)

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
