"""Smoke test of the PyTorch/CUDA port (pvot_torch) on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`.  It needs one
CUDA device and nvcc, imports nothing of JAX or the `pvot` package, and
exits nonzero on any failure.  Phases, in order, none of them caught:

  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA sources (pvot_torch/csrc) and print the build seconds,
     registers and score blocks per SM; hold the wrapper's copy of the
     kernel's shared-memory plan (stage_rows) to the kernel's;
  3. hold the chunk kernel K1 against its plain PyTorch version on the card,
     TF32 off, under the tracker's equality contract (pvot/tracker/mega.py
     _outputs_equal, restated): bbox, updated, used_global, lost and
     use_global lanes exactly equal, accepted scores within 1e-5, all scores
     within 2e-3 (both scaled by N / 6400 for templates of N > 6400 px: an
     f32 sum of N products carries a rounding error that grows with N), final
     template within 1e-6.  Inputs: (a) a 64-frame chunk of the bench clip at
     720p / 80x80 / r=60, (b) a 720p clip whose target leaves and re-enters
     the frame (lost_frame_threshold=5), which must contain global frames,
     (c) the repaired envelope: 1080p / 160x160 / r=160 on a re-acquisition
     clip with global frames, and a 256x256 template at 720p; time (a), (b);
  4. hold the multi-stream kernel K2 against its plain version: S = 4 at
     720p / 80x80 / r=60, one stream local, one re-acquiring, one ended
     (n_valid 0), one partial; 2F launches per chunk; each stream's records
     bit-equal to K1's on that stream; time kernel and plain version over the
     same 48 steps; time S = 8 with one stream held in global search; and
     hold 200 streams of a 176x256 template (staged in quarters: their lane
     table takes the room) bit-equal to K1 (staged in halves);
  5. drive the main path, pvot_torch.track_video_mega, over the bench clip
     (2048 frames, chunk 512), with the launch counters reset just before:
     the trajectory must be 0 px off the ground truth and K1 must have
     launched twice per frame;
  6. drive serving, pvot_torch.serve_streams, over 8 streams cut at spread
     offsets from the bench clip with unequal lengths, each from its
     ground-truth box, with the launch counters reset just before: every
     stream 0 px off the ground truth and equal, under the contract, to
     track_video_mega on that stream alone; K2 must have launched twice per
     frame step; print aggregate and per-stream frames/s;
  7. print the kernels' JSON line, the card's line, and last the result line.
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


def compare(name, got, want, n_px: int = 6400) -> float:
    """Kernel (rows, template) vs plain (rows, template) under the contract,
    rows (..., F, 10); returns the largest absolute difference over finite
    values."""
    rk, tk = (v.cpu().numpy() for v in got)
    rp, tp = (v.cpu().numpy() for v in want)
    rk, rp = rk.reshape(-1, 10), rp.reshape(-1, 10)
    for lane_name, lane in EXACT_LANES.items():
        if not np.array_equal(rk[:, lane], rp[:, lane]):
            first = int(np.nonzero(rk[:, lane] != rp[:, lane])[0][0])
            raise AssertionError(
                f"{name}: lane {lane_name} differs first at record {first}: "
                f"kernel {rk[first].tolist()} vs plain {rp[first].tolist()}")
    scale = max(1.0, n_px / 6400)
    acc = rp[:, 5] != 0
    finite = np.isfinite(rk[:, 4]) & np.isfinite(rp[:, 4])
    if not np.array_equal(np.isfinite(rk[:, 4]), np.isfinite(rp[:, 4])):
        raise AssertionError(f"{name}: kernel and plain version score different frames")
    d_acc = float(np.abs(rk[acc, 4] - rp[acc, 4]).max(initial=0.0))
    d_all = float(np.abs(rk[finite, 4] - rp[finite, 4]).max(initial=0.0))
    d_tpl = float(np.abs(tk - tp).max())
    print(f"{name}: {len(rk)} records, {int(acc.sum())} accepted, "
          f"{int(rk[:, 9].sum())} global; max |score diff| accepted {d_acc:.3g} "
          f"(<= {SCORE_ACC_ATOL * scale:.3g}), all {d_all:.3g} (<= {SCORE_ATOL * scale:.3g}); "
          f"template {d_tpl:.3g} (<= {TEMPLATE_ATOL})")
    if d_acc > SCORE_ACC_ATOL * scale or d_all > SCORE_ATOL * scale or d_tpl > TEMPLATE_ATOL:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    both = np.isfinite(rk) & np.isfinite(rp)
    return max(float(np.abs(rk - rp)[both].max(initial=0.0)), d_tpl)


def compare_outputs(name, got, want) -> None:
    """Two StepOutputs of one stream under the contract."""
    for field in ("bbox", "updated", "used_global"):
        if not np.array_equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{name}: {field} differs")
    acc = want.updated
    if (np.abs(got.score[acc] - want.score[acc]).max(initial=0.0) > SCORE_ACC_ATOL
            or np.abs(got.score - want.score).max(initial=0.0) > SCORE_ATOL):
        raise AssertionError(f"{name}: scores differ")


def chunk_args(frames_u8, state, config):
    return (frames_u8, torch.stack(list(state.bbox)), state.template, state.t_mean,
            state.t_std, state.lost_count, state.use_global, frames_u8.shape[0], config)


def stacked_args(states):
    """(bbox, template, t_mean, t_std, lost, use_global) stacked over streams."""
    cols = zip(*[(torch.stack(list(s.bbox)), s.template, s.t_mean, s.t_std,
                  s.lost_count, s.use_global) for s in states])
    return tuple(torch.stack(c) for c in cols)


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
    from pvot_torch.bench import (
        bench_clip, gpu_identity, run_bench, state_at, stream_cuts, stream_err_px, stream_states,
    )

    smi = gpu_identity()[0]
    print(f"gpu: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.serving import serve_streams
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video
    from pvot_torch.ops import _build
    from pvot_torch.ops.ncc_mega import (
        MegaGeometry, mega_track_chunk, mega_track_chunk_multi,
        mega_track_chunk_multi_reference, mega_track_chunk_reference,
    )
    from pvot_torch.parallel.multi import unstack_state
    from pvot_torch.tracker.mega import track_video_mega

    # Phase 2.
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {_build.build_info['path']} loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_info['seconds']:.1f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "bytes stack" in line:
            print("  ptxas:", line.strip())
    for th, lanes in ((80, 1), (80, 8), (160, 1), (256, 1)):
        print(f"  score blocks per SM, {th}x{th} template, {lanes} lane(s): "
              f"{lib.pvot_mega_score_blocks_per_sm(th, th, lanes)}")
    # The wrapper's envelope check mirrors the kernel's shared-memory plan.
    for th, tw, lanes in ((80, 80, 1), (80, 80, 8), (143, 143, 1), (143, 143, 256),
                          (160, 160, 1), (256, 256, 1), (256, 256, 64)):
        mirror = MegaGeometry((1080, 1920), (th, tw), TrackerConfig()).stage_rows(lanes)
        if lib.pvot_mega_stage_rows(th, tw, lanes) != mirror:
            raise AssertionError(f"stage_rows({th}, {tw}, {lanes}): kernel "
                                 f"{lib.pvot_mega_stage_rows(th, tw, lanes)}, wrapper {mirror}")

    # Phase 3.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config = TrackerConfig()
    t0 = time.perf_counter()
    spec, frames = bench_clip()
    print(f"bench clip: {frames.shape} generated in {time.perf_counter() - t0:.1f} s")
    state = state_at(spec, frames, 0, dev)
    chunk = torch.from_numpy(frames[1:65]).to(dev)
    args = chunk_args(chunk, state, config)
    k1_err = compare("K1 parity 720p tracked chunk", mega_track_chunk(*args),
                     mega_track_chunk_reference(*args))
    n = chunk.shape[0]
    ms = time_ms(lambda: mega_track_chunk(*args), 10) / n
    plain_ms = time_ms(lambda: mega_track_chunk_reference(*args), 1) / n
    print(f"K1 local frames (720p/80/r60), ms per frame: kernel {ms:.5f}, plain {plain_ms:.5f}")

    gspec = SyntheticSpec(width=1280, height=720, num_frames=49, target_w=80,
                          target_h=80, seed=2, exit_and_reenter=True)
    gframes = generate_gray_video(gspec)
    gconfig = TrackerConfig(lost_frame_threshold=5)
    gstate = state_at(gspec, gframes, 0, dev)
    gchunk = torch.from_numpy(gframes[1:]).to(dev)
    gargs = chunk_args(gchunk, gstate, gconfig)
    got = mega_track_chunk(*gargs)
    if not bool((got[0][:, 9] != 0).any()):
        raise AssertionError("re-acquisition clip ran no global frame")
    k1_err = max(k1_err, compare("K1 parity 720p re-acquisition clip", got,
                                 mega_track_chunk_reference(*gargs)))
    one = chunk_args(chunk[:1], gstate._replace(use_global=torch.tensor(True, device=dev)),
                     gconfig)
    g_ms = time_ms(lambda: mega_track_chunk(*one), 10)
    g_plain_ms = time_ms(lambda: mega_track_chunk_reference(*one), 3)
    print(f"K1 one global frame (720p/80, 641x1201 positions), ms: kernel {g_ms:.4f}, "
          f"plain {g_plain_ms:.4f}")

    # The repaired envelope: 1080p / 160 x 160 / r160 (the JAX suite's
    # 1080p_t160_r160 geometry) with global frames, and a 256 x 256 template.
    bspec = SyntheticSpec(width=1920, height=1080, num_frames=7, target_w=160,
                          target_h=160, seed=3, exit_and_reenter=True)
    bframes = generate_gray_video(bspec)
    bconfig = TrackerConfig(search_radius_x=160, search_radius_y=160, lost_frame_threshold=2)
    bstate = state_at(bspec, bframes, 0, dev)
    bargs = chunk_args(torch.from_numpy(bframes[1:]).to(dev), bstate, bconfig)
    got = mega_track_chunk(*bargs)
    k1_err = max(k1_err, compare("K1 parity 1080p/160/r160", got,
                                 mega_track_chunk_reference(*bargs), 160 * 160))
    bglob = chunk_args(bargs[0][:2], bstate._replace(use_global=torch.tensor(True, device=dev)),
                       bconfig)
    got = mega_track_chunk(*bglob)
    if not bool((got[0][:, 9] != 0).any()):
        raise AssertionError("1080p/160 check ran no global frame")
    k1_err = max(k1_err, compare("K1 parity 1080p/160 global frames", got,
                                 mega_track_chunk_reference(*bglob), 160 * 160))
    b_local = chunk_args(bargs[0][:1], bstate, bconfig)
    b_ms = time_ms(lambda: mega_track_chunk(*b_local), 5)
    b_global = chunk_args(bargs[0][:1], bstate._replace(
        use_global=torch.tensor(True, device=dev)), bconfig)
    bg_ms = time_ms(lambda: mega_track_chunk(*b_global), 3)
    print(f"K1 1080p/160/r160, ms: a local frame {b_ms:.4f}, a global frame {bg_ms:.4f}")
    sspec = SyntheticSpec(width=1280, height=720, num_frames=4, target_w=256, target_h=256, seed=4)
    sframes = generate_gray_video(sspec)
    sconfig = TrackerConfig(search_radius_x=40, search_radius_y=40)
    sstate = state_at(sspec, sframes, 0, dev)
    sargs = chunk_args(torch.from_numpy(sframes[1:]).to(dev), sstate, sconfig)
    k1_err = max(k1_err, compare("K1 parity 720p/256x256/r40", mega_track_chunk(*sargs),
                                 mega_track_chunk_reference(*sargs), 256 * 256))

    # Phase 4.
    f4 = 48
    fr4 = torch.from_numpy(np.stack([frames[1 : 1 + f4], gframes[1 : 1 + f4],
                                     frames[400 : 400 + f4], frames[800 : 800 + f4]])).to(dev)
    st4 = stacked_args([state, gstate, state_at(spec, frames, 399, dev),
                        state_at(spec, frames, 799, dev)])
    nv4 = torch.tensor([f4, f4, 0, 20], dtype=torch.int32, device=dev)
    before = mega_track_chunk_multi.launches
    got = mega_track_chunk_multi(fr4, *st4, nv4, gconfig)
    if mega_track_chunk_multi.launches - before != 2 * f4:
        raise AssertionError("K2 did not launch twice per frame step")
    if not bool((got[0][1, :, 9] != 0).any()):
        raise AssertionError("K2's re-acquiring stream ran no global frame")
    k2_err = compare("K2 parity S=4 (local, re-acquiring, ended, partial)", got,
                     mega_track_chunk_multi_reference(fr4, *st4, nv4, gconfig))
    for s in range(4):
        k1 = mega_track_chunk(fr4[s], *(a[s] for a in st4), int(nv4[s]), gconfig)
        if not torch.equal(k1[0], got[0][s]) or not torch.equal(k1[1], got[1][s]):
            raise AssertionError(f"K2 stream {s} differs from K1 on that stream")
    print("K2 parity: every stream's records and template bit-equal to K1's")
    k2_ms = time_ms(lambda: mega_track_chunk_multi(fr4, *st4, nv4, gconfig), 5) / f4
    k2_plain_ms = time_ms(lambda: mega_track_chunk_multi_reference(
        fr4, *st4, nv4, gconfig), 1) / f4
    n_global = int(got[0][1, :, 9].sum())
    print(f"K2 S=4 (one stream global on {n_global} of {f4} steps), ms per frame step over "
          f"the same {f4} steps: kernel {k2_ms:.5f}, plain {k2_plain_ms:.5f}")
    f8 = torch.stack([torch.from_numpy(frames[64 * i + 1 : 64 * i + 33]) for i in range(8)]).to(dev)
    st8 = list(stacked_args([state_at(spec, frames, 64 * i, dev) for i in range(8)]))
    st8[5] = st8[5].clone()
    st8[5][3] = True  # stream 3 sees a blank scene and stays in global search
    f8[3] = 0
    nv8 = torch.full((8,), 32, dtype=torch.int32, device=dev)
    k2_s8_global_ms = time_ms(lambda: mega_track_chunk_multi(f8, *st8, nv8, config), 3) / 32
    print(f"K2 S=8, one stream in global search, ms per frame step: {k2_s8_global_ms:.5f}")
    # A row group adds the same template rows in the same order however the
    # template is chunked: a 176 x 256 template stages half by half for one
    # stream, in quarters for 200 (their lane table takes the room).
    cspec = SyntheticSpec(width=270, height=200, num_frames=4, target_w=256, target_h=176,
                          seed=9)
    cframes = generate_gray_video(cspec)
    cconfig = TrackerConfig(search_radius_x=6, search_radius_y=6)
    cgeom = MegaGeometry(cframes.shape[1:], (176, 256), cconfig)
    if not (cgeom.stage_rows(1) == 88 and cgeom.stage_rows(200) < 88):
        raise AssertionError("176x256 staging plan is not halves at 1 stream, smaller at 200")
    cargs = chunk_args(torch.from_numpy(cframes[1:]).to(dev), state_at(cspec, cframes, 0, dev),
                       cconfig)
    k1 = mega_track_chunk(*cargs)
    many = [v.expand(200, *v.shape).contiguous() for v in cargs[1:7]]
    got = mega_track_chunk_multi(cargs[0].expand(200, *cargs[0].shape), *many, [3] * 200,
                                 cconfig)
    if not (torch.equal(got[0], k1[0].expand_as(got[0]))
            and torch.equal(got[1], k1[1].expand_as(got[1]))):
        raise AssertionError("K2 with 176x256 in chunks of a quarter differs from K1 in halves")
    print(f"K2 176x256, 200 streams staged in chunks of {cgeom.stage_rows(200)} rows: "
          f"bit-equal to K1 staged in halves ({int(k1[0][:, 5].sum())} of 3 frames accepted)")

    # Phase 5 (run_bench sets the launch counters to 0 just before the main
    # path's checked run and reads them just after).
    result = run_bench(clip=(spec, frames))
    print("main path:", json.dumps(result))
    if result["max_l1_err_px"] != 0:
        raise AssertionError(f"main path max_l1_err_px {result['max_l1_err_px']} != 0")
    if result["kernel_launches"] != 2 * 2048:
        raise AssertionError(f"kernel launches {result['kernel_launches']} != {2 * 2048}")
    print(f"main path: {result['value']:.1f} frames/s, {result['ms_per_frame']:.5f} ms/frame "
          f"on {smi}")

    # Phase 6.
    lengths = [1200 - 50 * s for s in range(8)]
    offsets = stream_cuts(8, frames.shape[0], lengths)
    starts = stream_states(spec, frames, offsets, dev)
    chunk_size = 64
    timings: list = []
    mega_track_chunk.launches = 0
    mega_track_chunk_multi.launches = 0
    t0 = time.perf_counter()
    _, served = serve_streams([iter(frames[o + 1 : o + 1 + n]) for o, n in zip(offsets, lengths)],
                              starts, frames.shape[1:], config,
                              chunk_size=chunk_size, timings=timings)
    serve_s = time.perf_counter() - t0
    serve_launches = mega_track_chunk_multi.launches
    if mega_track_chunk.launches or serve_launches != 2 * len(timings) * chunk_size:
        raise AssertionError(f"serving launched K2 {serve_launches} times, K1 "
                             f"{mega_track_chunk.launches}")
    for s, (o, n) in enumerate(zip(offsets, lengths)):
        if served[s].bbox.shape[0] != n:
            raise AssertionError(f"stream {s}: {served[s].bbox.shape[0]} records for {n} frames")
        err = stream_err_px(spec, o, served[s].bbox)
        if err != 0:
            raise AssertionError(f"stream {s}: max_l1_err_px {err} != 0")
        _, alone = track_video_mega(frames[o + 1 : o + 1 + n], unstack_state(starts, s), config,
                                    chunk_size=chunk_size)
        compare_outputs(f"stream {s}", served[s], alone)
    total = sum(lengths)
    print(f"serving: 8 streams ({min(lengths)}-{max(lengths)} frames, offsets {offsets}), "
          f"{total} frames in {serve_s:.3f} s: {total / serve_s:.1f} frames/s aggregate, "
          f"{[round(n / serve_s, 1) for n in lengths]} per stream; every stream 0 px off the "
          f"ground truth and equal to track_video_mega alone; {serve_launches} K2 launches "
          f"on {smi}")

    # Phase 7.
    print(json.dumps({"kernels": [
        {
            "name": "mega_track_chunk",
            "route": "cuda",
            "source": "pvot_torch/csrc/ncc_mega.cu",
            "replaces": "pvot/ops/ncc_mega.py:170",
            "launches": result["kernel_launches"],
            "max_abs_err": k1_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "ms_unit": "per tracked local frame, 720p/80/r60",
            "global_frame_ms": g_ms,
            "plain_global_frame_ms": g_plain_ms,
        },
        {
            "name": "mega_track_chunk_multi",
            "route": "cuda",
            "source": "pvot_torch/csrc/ncc_mega.cu",
            "replaces": "pvot/ops/ncc_mega.py:1059",
            "launches": serve_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "ms_unit": "per frame step of 4 streams over the same 48 steps, 720p/80/r60",
            "s8_one_global_ms_per_step": k2_s8_global_ms,
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
