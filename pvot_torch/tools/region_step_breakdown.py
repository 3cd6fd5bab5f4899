"""Where does the per-frame engine step's time go?  The region-step ladder.

The port of tools/region_step_breakdown.py, which split the JAX fused local
step (720p, 80x80 template, r60: span 121) into its candidate costs with
rungs scanned over real frames.  Here the step is the port's per-frame
engine step (`tracker/step.py`, backend `shared` or `pallas_fast`: K5
fused, one launch and one host read a frame), run eagerly frame by frame;
each rung is a loop over the same frames, staged on the card beforehand:

  empty        the carry passes through, a record a frame: the loop's floor
  ema_only     `apply_update` with a constant accepted argmax at the current
               bbox: the EMA fires every frame and the stats recompute (torch
               ops on the card), no NCC
  glue_only    ema_only + what feeds K5: the window and region origin on the
               host, the lane ints' copy to the card, the operand checks and
               the scratch (`region_argmax_operands`), no launch
  kernel_scan  the bare K5 launch through its C entry on one operand set
               staged before the loop (frame 1, the first template, the
               whole window), every frame: no frame read, no glue, no update
  full         the real step (`cached_step`, the engine's K5): window, K5,
               the step's one host read, `apply_update`; its records equal
               `track_video(backend=...)`'s

and the JAX tool's differences: `ema+stats` (ema_only - empty), `glue`
(glue_only - ema_only), `bare_kernel` (kernel_scan - empty), and
`kernel+read` (full - glue_only: the launch, the wait for it and the host
read).  `build_only` and `no_build` time the Toeplitz operator of the JAX
operator engine, which the port leaves out on purpose (ROADMAP R3): they are
listed with no time.  The JAX `kernel_scan` perturbed its image every step
so that XLA would not hoist the loop-invariant pallas_call out of the scan
(the trap its docstring records); PyTorch launches eagerly, so every step
launches and the rung needs no such perturbation.

A rung's time is host-clock time a frame over the whole clip, from its first
frame to `torch.cuda.synchronize()` after its last (`us_per_frame`), the
best of 5 rounds that each run every rung once, after the checked run: the
host is shared, and rounds spread its drift over all rungs.  On the card the
tool also reads K5's device time a launch two ways: torch.profiler's kernel
duration over a kernel_scan run, and CUDA events around replays of a CUDA
graph of 100 launches through the C entry on preallocated operands (K5
leaves its counter at zero, so the launches repeat).  The events time of
one wrapper call (`call_us`) is the wrapper's host time, not the kernel's,
and is printed beside them.

    python -m pvot_torch.tools.region_step_breakdown [--backend shared pallas_fast]
        [--frames 1024] [--chunk 256] [--device cpu]

It tracks the bench clip's geometry (SyntheticSpec(1280, 720, frames + 1,
80x80, seed=1)) from its ground-truth box at radius 60 and prints one JSON
line a rung, then the summary of each backend.  With `--device cpu` the
rungs run the plain versions (no time).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import gray_u8_to_f32
from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.backends import cuda_region_passes
from pvot_torch.ops.ncc_pallas import (
    launch_region_argmax, region_argmax_lanes, region_argmax_operands,
)
from pvot_torch.tools.mega_breakdown import device_us_per_frame
from pvot_torch.tracker.scan import records_to_output, track_video
from pvot_torch.tracker.state import StepOutput, init_state
from pvot_torch.tracker.step import apply_update, cached_step, carry_from_state

RUNGS = ("empty", "ema_only", "glue_only", "kernel_scan", "full")
NO_COUNTERPART = ("build_only", "no_build")  # the Toeplitz operator (ROADMAP R3)
BACKENDS = ("shared", "pallas_fast")
ROUNDS = 5  # timed rounds over all rungs
GRAPH_LAUNCHES = 100  # launches a captured graph
GRAPH_REPLAYS = 5


def make_clip(width: int = 1280, height: int = 720, templ: int = 80, num_frames: int = 1024,
              seed: int = 1):
    """(spec, frames (F + 1, H, W) u8): the bench clip's generator at this
    geometry."""
    spec = SyntheticSpec(width=width, height=height, num_frames=num_frames + 1, target_w=templ,
                         target_h=templ, seed=seed)
    return spec, generate_gray_video(spec)


def start_state(spec, frames, device):
    """The state from the ground-truth box at frame 0."""
    x, y, w, h = target_bbox(spec, 0)
    return init_state(gray_u8_to_f32(frames[0])[y : y + h, x : x + w], (x, y, w, h),
                      device=device)


class Ladder:
    """The rungs over one clip (frames 1.., staged on `device` in chunks) from
    one state, for one backend of the CUDA engine family."""

    def __init__(self, frames: np.ndarray, state, config: TrackerConfig, backend: str,
                 chunk: int, device):
        if cuda_region_passes(backend) is None:
            raise ValueError(f"the ladder takes a backend of the CUDA engine, not {backend!r}")
        self.device = torch.device(device)
        self.chunks = [torch.from_numpy(frames[1 + i : 1 + i + chunk]).to(self.device)
                       for i in range(0, frames.shape[0] - 1, chunk)]
        self.state, self.config, self.backend = state, config, backend
        self.passes = cuda_region_passes(backend)
        self.frame_shape = tuple(frames.shape[1:])
        self.templ_shape = tuple(state.template.shape)
        th, tw = self.templ_shape
        self.out_w = self.frame_shape[1] - tw + 1
        self.out_h = self.frame_shape[0] - th + 1
        self.span = (2 * config.search_radius_y + 1, 2 * config.search_radius_x + 1)

    def frames(self):
        for chunk in self.chunks:
            yield from chunk

    def _window(self, c):
        bx, by, bw, bh = c.bbox
        th, tw = self.templ_shape
        bounds = search_ops.local_window_bounds(
            bx + bw // 2, by + bh // 2, tw, th, self.out_w, self.out_h,
            self.config.search_radius_x, self.config.search_radius_y)
        x0, y0 = search_ops.region_origin(bounds, self.out_w, self.out_h, self.span[1],
                                          self.span[0])
        return bounds, x0, y0

    def _accept_here(self, c, frame):
        return apply_update(c, frame, 1.0, c.bbox[0], c.bbox[1], False, False,
                            self.frame_shape, self.templ_shape, self.config)

    def run(self, rung: str) -> StepOutput:
        """One pass of `rung` over the clip: its records."""
        c = carry_from_state(self.state)
        recs = []
        if rung == "empty":
            for _ in self.frames():
                recs.append((c.bbox, 0.0, False, False))
        elif rung == "ema_only":
            for frame in self.frames():
                c, rec = self._accept_here(c, frame)
                recs.append(rec)
        elif rung == "glue_only":
            for frame in self.frames():
                bounds, x0, y0 = self._window(c)
                lane = (x0, y0, bounds.min_tx - x0, bounds.max_tx - x0, bounds.min_ty - y0,
                        bounds.max_ty - y0)
                if self.device.type == "cuda":
                    region_argmax_operands(frame, c.template, c.t_mean, c.t_std, [lane],
                                           self.span, self.passes)
                c, rec = self._accept_here(c, frame)
                recs.append(rec)
        elif rung == "kernel_scan":
            call = self.kernel_operands()
            for _ in self.frames():
                if call is None:  # the CPU: the wrapper runs the plain version
                    self._wrapper_call()
                else:
                    launch_region_argmax(call)
                recs.append(((0, 0, 0, 0), 0.0, False, False))
        elif rung == "full":
            step = cached_step(self.frame_shape, self.templ_shape, self.config, "fused",
                               self.backend)
            for frame in self.frames():
                c, rec = step(c, frame)
                recs.append(rec)
        else:
            raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
        return records_to_output(recs)

    def _kernel_lane(self):
        return [(0, 0, 0, self.span[1] - 1, 0, self.span[0] - 1)]

    def _wrapper_call(self):
        s = self.state
        return region_argmax_lanes(self.chunks[0][0], s.template, s.t_mean, s.t_std,
                                   self._kernel_lane(), self.span, self.passes)

    def kernel_operands(self):
        """kernel_scan's operands, staged once (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        s = self.state
        return region_argmax_operands(self.chunks[0][0], s.template, s.t_mean, s.t_std,
                                      self._kernel_lane(), self.span, self.passes)


def graph_us(launch, n: int = GRAPH_LAUNCHES) -> float:
    """Device us a launch: CUDA events around replays of a CUDA graph of n
    calls of launch(stream handle), captured after a warm call (the C
    entry's attribute and occupancy queries happen then)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        launch(stream.cuda_stream)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            launch(torch.cuda.current_stream().cuda_stream)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (GRAPH_REPLAYS * n)


def call_us(fn, n: int = 200) -> float:
    """CUDA events around n wrapper calls: the wrapper's host time a call
    when it exceeds the kernel's."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def ladder(backend: str = "shared", num_frames: int = 1024, chunk: int = 256, device=None,
           clip=None, config: TrackerConfig = None) -> dict:
    """Run the rungs for `backend` over `num_frames` frames of the clip (or of
    `clip`, (spec, frames) as `make_clip` makes it), and print a line a rung
    and the summary; returns {"rungs", "diffs", "full_equals_track_video",
    "k5"} (no times on the CPU)."""
    dev = torch.device(device or "cuda")
    config = config or TrackerConfig()
    spec, frames = clip or make_clip(num_frames=num_frames)
    frames = frames[: num_frames + 1]
    n = frames.shape[0] - 1
    state = start_state(spec, frames, dev)
    lad = Ladder(frames, state, config, backend, chunk, dev)
    timed = dev.type == "cuda"
    result = {"backend": backend, "frames": n, "chunk": chunk, "rungs": {}, "diffs": {},
              "no_counterpart": {r: None for r in NO_COUNTERPART}}
    for rung in RUNGS:
        out = lad.run(rung)
        result["rungs"][rung] = {"records": len(out.bbox)}
        if rung == "full":
            want = track_video(frames[1:], state, config, backend=backend)[1]
            equal = all(np.array_equal(a, b) for a, b in zip(out, want))
            if not equal:
                raise AssertionError(f"{backend}: the full rung's records differ from "
                                     f"track_video's")
            result["full_equals_track_video"] = equal
    if timed:  # rounds over all rungs, each rung's best: drift of the host spreads evenly
        best = dict.fromkeys(RUNGS, math.inf)
        for _ in range(ROUNDS):
            for rung in RUNGS:
                t0 = time.perf_counter()
                lad.run(rung)
                torch.cuda.synchronize()
                best[rung] = min(best[rung], time.perf_counter() - t0)
        for rung in RUNGS:
            result["rungs"][rung]["us_per_frame"] = best[rung] / n * 1e6
    for rung in RUNGS:
        print(json.dumps({"backend": backend, rung: result["rungs"][rung]}), flush=True)
    if timed:
        us = {r: v["us_per_frame"] for r, v in result["rungs"].items()}
        result["diffs"] = {
            "ema+stats(ema_only-empty)": us["ema_only"] - us["empty"],
            "glue(glue_only-ema_only)": us["glue_only"] - us["ema_only"],
            "bare_kernel(kernel_scan-empty)": us["kernel_scan"] - us["empty"],
            "kernel+read(full-glue_only)": us["full"] - us["glue_only"],
        }
        call = lad.kernel_operands()
        from pvot_torch.ops import _build

        lib = _build.load_library()
        result["k5"] = {
            "profiler_us": device_us_per_frame(lambda: lad.run("kernel_scan"), n, "ncc_kernel"),
            "graph_us": graph_us(lambda s: _build.check(
                lib.pvot_ncc_region_argmax(*call.args, s), "ncc_region_argmax_pallas")),
            "call_us": call_us(lad._wrapper_call),
        }
        result["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps({"region_step_breakdown": result}), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", nargs="+", default=list(BACKENDS), choices=list(BACKENDS))
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions, no time)")
    args = ap.parse_args(argv)
    if (args.device or "cuda").startswith("cuda") and not torch.cuda.is_available():
        print("region_step_breakdown: no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 1
    if args.device is None or args.device.startswith("cuda"):
        from pvot_torch.bench import gpu_identity

        print(f"gpu: {gpu_identity()[0]}", flush=True)
    clip = make_clip(num_frames=args.frames)
    for backend in args.backend:
        ladder(backend, args.frames, args.chunk, args.device, clip)
    return 0


if __name__ == "__main__":
    sys.exit(main())
