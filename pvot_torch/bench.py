"""Headline on the card: tracked frames/s at 720p with an 80x80 template.

The clip, geometry and correctness check are bench.py's: the synthetic
SyntheticSpec(1280, 720, 2049 frames, 80x80, seed=1), the target's bbox at
frame 0 as the initial state, 2048 tracked frames in chunks of 512, and
max_l1_err_px == 0 against the ground-truth bbox.  The port runs the f32
tier (bench.py's `mega_highest=True` analog).

Run with `python -m pvot_torch.bench`; it prints one JSON line.  It needs a
CUDA device and fails without one.

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


def initial_state(spec, frame0: np.ndarray, device):
    from pvot_torch.io.gray import gray_u8_to_f32
    from pvot_torch.io.synthetic import target_bbox
    from pvot_torch.tracker.state import init_state

    x, y, w, h = target_bbox(spec, 0)
    return init_state(gray_u8_to_f32(frame0)[y : y + h, x : x + w], (x, y, w, h),
                      device=device)


def max_l1_err_px(spec, bbox: np.ndarray) -> int:
    """Largest |dx| + |dy| between tracked and ground-truth bbox over the
    tracked frames (frame i of `bbox` is clip frame i + 1)."""
    from pvot_torch.io.synthetic import target_bbox

    truth = np.array([target_bbox(spec, i + 1)[:2] for i in range(len(bbox))])
    return int(np.abs(bbox[:, :2] - truth).sum(axis=1).max())


def run_bench(num_frames: int = 2048, chunk_size: int = 512, passes: int = 5,
              clip=None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("pvot_torch.bench needs a CUDA device")
    from pvot_torch.config import TrackerConfig
    from pvot_torch.ops.ncc_mega import mega_track_chunk
    from pvot_torch.tracker.mega import track_video_mega

    dev = torch.device("cuda", 0)
    spec, frames = clip if clip is not None else bench_clip(num_frames)
    config = TrackerConfig()
    state = initial_state(spec, frames[0], dev)
    staged = torch.from_numpy(frames[1 : 1 + num_frames]).to(dev)
    torch.cuda.synchronize()

    mega_track_chunk.launches = 0
    _, out = track_video_mega(staged, state, config, chunk_size=chunk_size)
    launches = mega_track_chunk.launches
    err = max_l1_err_px(spec, out.bbox)

    times_ms = []
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, again = track_video_mega(staged, state, config, chunk_size=chunk_size)
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
        "tier": "f32",
        "gpu": torch.cuda.get_device_name(0),
        "gpu_smi": gpu,
        "power_limit_w": watts,
        "kernel_launches": launches,
    }


def main() -> None:
    t0 = time.perf_counter()
    result = run_bench()
    result["wall_s"] = time.perf_counter() - t0
    print(json.dumps(result))
    if result["max_l1_err_px"] != 0:
        raise SystemExit("tracked trajectory is off the ground truth")


if __name__ == "__main__":
    main()
