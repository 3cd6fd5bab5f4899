"""Smoke test of the PyTorch/CUDA port (pvot_torch) on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`.  It needs one
CUDA device and nvcc, imports nothing of JAX or the `pvot` package, and
exits nonzero on any failure.  Phases, in order, none of them caught:

  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA sources (pvot_torch/csrc) and print the build seconds;
  3. hold the chunk kernel against its plain PyTorch version on the card, TF32
     off, under the tracker's equality contract (pvot/tracker/mega.py
     _outputs_equal, restated): bbox, updated, used_global, lost and
     use_global lanes exactly equal, accepted scores within 1e-5, all scores
     within 2e-3, final template within 1e-6.  Inputs: (i) a 64-frame chunk of
     the bench clip at 720p / 80x80 / r=60, (ii) a 720p clip whose target
     leaves and re-enters the frame (lost_frame_threshold=5), which must
     contain global frames; and time both versions;
  4. drive the main path, pvot_torch.track_video_mega, over the bench clip
     (2048 frames, chunk 512), with the launch counter reset just before:
     the trajectory must be 0 px off the ground truth and the kernel must have
     launched twice per frame;
  5. print the kernels' JSON line, the card's line, and last the result line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

SCORE_ACC_ATOL = 1e-5  # accepted frames: a genuine match is numerically stable
SCORE_ATOL = 2e-3  # all frames: a rejected score is a max over noise
TEMPLATE_ATOL = 1e-6
EXACT_LANES = {"bx": 0, "by": 1, "bw": 2, "bh": 3, "updated": 5, "lost": 7,
               "use_global": 8, "used_global": 9}


def compare(name, got, want) -> float:
    """Kernel (rows, template) vs plain (rows, template) under the contract;
    returns the largest absolute difference over finite values."""
    rk, tk = (v.cpu().numpy() for v in got)
    rp, tp = (v.cpu().numpy() for v in want)
    for lane_name, lane in EXACT_LANES.items():
        if not np.array_equal(rk[:, lane], rp[:, lane]):
            first = int(np.nonzero(rk[:, lane] != rp[:, lane])[0][0])
            raise AssertionError(
                f"{name}: lane {lane_name} differs first at frame {first}: "
                f"kernel row {rk[first].tolist()} vs plain {rp[first].tolist()}")
    acc = rp[:, 5] != 0
    d_acc = float(np.abs(rk[acc, 4] - rp[acc, 4]).max(initial=0.0))
    d_all = float(np.abs(rk[:, 4] - rp[:, 4]).max(initial=0.0))
    d_tpl = float(np.abs(tk - tp).max())
    print(f"{name}: {len(rk)} frames, {int(acc.sum())} accepted, "
          f"{int(rk[:, 9].sum())} global; max |score diff| accepted {d_acc:.3g} "
          f"(<= {SCORE_ACC_ATOL}), all {d_all:.3g} (<= {SCORE_ATOL}); "
          f"template {d_tpl:.3g} (<= {TEMPLATE_ATOL})")
    if d_acc > SCORE_ACC_ATOL or d_all > SCORE_ATOL or d_tpl > TEMPLATE_ATOL:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    finite = np.isfinite(rk) & np.isfinite(rp)
    return max(float(np.abs(rk - rp)[finite].max(initial=0.0)), d_tpl)


def chunk_args(frames_u8, state, config):
    return (frames_u8, torch.stack(list(state.bbox)), state.template, state.t_mean,
            state.t_std, state.lost_count, state.use_global, frames_u8.shape[0], config)


def time_ms(fn, repeats: int) -> float:
    """Milliseconds per call between CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> int:
    # Phase 1.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pvot_torch.bench import bench_clip, gpu_identity, initial_state, run_bench

    smi = gpu_identity()[0]
    print(f"gpu: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video
    from pvot_torch.ops import _build
    from pvot_torch.ops.ncc_mega import mega_track_chunk, mega_track_chunk_reference

    # Phase 2.
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.build_info['path']} loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_info['seconds']:.1f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "bytes stack" in line:
            print("  ptxas:", line.strip())

    # Phase 3.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config = TrackerConfig()
    t0 = time.perf_counter()
    spec, frames = bench_clip()
    print(f"bench clip: {frames.shape} generated in {time.perf_counter() - t0:.1f} s")
    state = initial_state(spec, frames[0], dev)
    chunk = torch.from_numpy(frames[1:65]).to(dev)
    args = chunk_args(chunk, state, config)
    max_err = compare("parity 720p tracked chunk", mega_track_chunk(*args),
                      mega_track_chunk_reference(*args))
    n = chunk.shape[0]
    ms = time_ms(lambda: mega_track_chunk(*args), 10) / n
    plain_ms = time_ms(lambda: mega_track_chunk_reference(*args), 1) / n
    print(f"local frames (720p/80/r60), ms per frame: kernel {ms:.4f}, plain {plain_ms:.4f}")

    gspec = SyntheticSpec(width=1280, height=720, num_frames=49, target_w=80,
                          target_h=80, seed=2, exit_and_reenter=True)
    gframes = generate_gray_video(gspec)
    gconfig = TrackerConfig(lost_frame_threshold=5)
    gstate = initial_state(gspec, gframes[0], dev)
    gargs = chunk_args(torch.from_numpy(gframes[1:]).to(dev), gstate, gconfig)
    got = mega_track_chunk(*gargs)
    if not bool((got[0][:, 9] != 0).any()):
        raise AssertionError("re-acquisition clip ran no global frame")
    max_err = max(max_err, compare("parity 720p re-acquisition clip", got,
                                   mega_track_chunk_reference(*gargs)))
    one = chunk_args(chunk[:1], gstate._replace(use_global=torch.tensor(True, device=dev)),
                     gconfig)
    g_ms = time_ms(lambda: mega_track_chunk(*one), 10)
    g_plain_ms = time_ms(lambda: mega_track_chunk_reference(*one), 3)
    print(f"one global frame (720p/80, 641x1201 positions), ms: kernel {g_ms:.4f}, "
          f"plain {g_plain_ms:.4f}")

    # Phase 4 (run_bench sets the launch counter to 0 just before the main
    # path's checked run and reads it just after).
    result = run_bench(clip=(spec, frames))
    print("main path:", json.dumps(result))
    if result["max_l1_err_px"] != 0:
        raise AssertionError(f"main path max_l1_err_px {result['max_l1_err_px']} != 0")
    if result["kernel_launches"] != 2 * 2048:
        raise AssertionError(f"kernel launches {result['kernel_launches']} != {2 * 2048}")
    print(f"main path: {result['value']:.1f} frames/s, {result['ms_per_frame']:.4f} ms/frame "
          f"on {smi}")

    # Phase 5.
    print(json.dumps({"kernels": [{
        "name": "mega_track_chunk",
        "route": "cuda",
        "source": "pvot_torch/csrc/ncc_mega.cu",
        "replaces": "pvot/ops/ncc_mega.py:170",
        "launches": result["kernel_launches"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_unit": "per tracked local frame, 720p/80/r60",
        "global_frame_ms": g_ms,
        "plain_global_frame_ms": g_plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
