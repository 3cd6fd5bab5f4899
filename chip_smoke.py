"""Smoke test of the PyTorch/CUDA port (pvot_torch) on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py [--parent DIR]`.
It needs one CUDA device and nvcc, imports nothing of JAX or the `pvot`
package, and exits nonzero on any failure.  The chunk kernels K1-K3 make one
persistent launch a chunk.  Phases, in order, none of them caught:

  1. require a CUDA device; print the card's name and power limit; require
     the native host library (pvot_torch/runtime/libpvot.cpp, built by make,
     with -fopenmp-simd where -fopenmp fails) to load, so that no serving
     phase falls back to the Python frame ring or the numpy host NCC;
  2. build the CUDA sources (pvot_torch/csrc, one nvcc per source, at once)
     and print the build seconds of each source, the production kernels'
     registers, spills and score blocks per SM beside the parent tree's
     (PR 5's, before the K1 body moved into mega_body.cuh) and the ladder's
     and probes' registers; hold the wrappers' copies of the kernels'
     shared-memory plans (K1-K3 stage_rows, K4/K5 ncc_plan) to the kernels';
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
     clip with global frames, and a 256x256 template at 720p; time (a), and
     per frame over short chunks beside their bounds: global frames at 720p
     and 1080p held in global search by a template that matches nothing,
     and local frames at 1080p/160/r160;
  4. hold the multi-stream kernel K2 against its plain version: S = 4 at
     720p / 80x80 / r=60, one stream local, one re-acquiring, one ended
     (n_valid 0), one partial; one launch for the chunk; each stream's records
     bit-equal to K1's on that stream; time kernel and plain version over the
     same 48 steps; time S = 8 with one stream held in global search; and
     hold 200 streams of a 176x256 template (staged in quarters: their lane
     table takes the room) bit-equal to K1 (staged in halves);
  5. the multi-object kernel K3 (K trackers over one clip), its states built
     with no device argument (they must land on the card): (a) K = 4 at
     720p / 80x80 / r60 over a 48-frame chunk of the bench clip with two
     static patches stamped in: the target, the two patches, and one object
     started outside the frame that must search globally; (b) the same four
     roles with templates of 80x80, 64x48, 48x64 and 32x32 in a shared
     bucket; each held against its plain version under the contract, each
     object's records and template bit-equal to K1 on that object alone at
     its true extent, and one launch; (a) and (b) timed, kernel and plain,
     over the same 48 steps beside their bounds; (c) at 1080p a 176x176
     bucket (176x176, 64x48 and 32x32 from outside the frame), which stages
     in row chunks, each object bit-equal to K1 alone, timed; (d) K = 8 all
     local beside its bound, and K = 8 with one object held in global
     search, over the same 48 steps; (e) serve_objects with 8 objects over
     1024 frames of the bench clip, all from the ground-truth box, with the
     launch counters reset just before: 0 px off the ground truth, equal to
     track_objects_mega, only K3 launched, once a chunk; frames/s
     beside the device path's;
  6. drive the main path, pvot_torch.track_video_mega, over the bench clip
     (2048 frames, chunk 512), with the launch counters reset just before:
     the trajectory must be 0 px off the ground truth, K1 must have launched
     once a chunk (4 times), and K2 and K3 not at all;
  7. drive serving, pvot_torch.serve_streams, over 8 streams cut at spread
     offsets from the bench clip with unequal lengths, each from its
     ground-truth box, with the launch counters reset just before: every
     stream 0 px off the ground truth and equal, under the contract, to
     track_video_mega on that stream alone; K2 must have launched once a
     chunk step, K1 and K3 not at all; print aggregate and per-stream
     frames/s;
  8. hold the per-frame engines' kernels against their plain versions: K4
     (dense maps) at 720p/80, 1080p/160, odd shapes, u8 and f32, within 1e-4,
     and batched over 8 frames equal to 8 single calls; K5 (fused region
     argmax) on bench and random frames, windows whole, partly and fully
     masked, lanes sharing a frame and each with its own, u8 and f32: value
     within 1e-5, (x, y) exactly, and a forced tie to the window's first
     position; and the shapes at the tile body's edges: every window
     origin x0 mod 16, spans and maps that are not whole tiles, templates in
     row chunks (176x176, 256x256), widths not a multiple of 4, 1, 4 and 8
     lanes on one frame and on their own, u8 and f32, the 1080p/160 region;
  9. drive this slice's main path, track_stream(backend="shared") over the
     bench clip's 2048 frames, with the counters reset just before: 0 px,
     equal under the contract to track_video_mega, K5 launched once a frame
     and nothing else; print frames/s and host reads a frame beside
     track_video_mega's;
 10. the same through the pvot-torch CLI (--shared) over its synthetic clip
     of the bench geometry: 0 px, equal to track_video_mega, K5 only;
 11. re-acquisition at 720p: K4 once per global frame, K5 once per local
     frame, equal to the plain engine (the step on the kernels' plain
     versions, on the card);
 12. 1080p/160/r160 (span 321: the K4 region path) with global frames, equal
     to the plain engine; a local frame's search timed both ways, K4 +
     argmax and K5 forced over the span;
 13. several lanes: K = 4 objects (one from outside the frame) and 4 streams
     in a masked chunk, one K5 launch a frame step, and a bucketed set, each
     lane equal to the plain engine on it alone;
 14. batch mode at n = 4 with a 3-frame tail;
 15. TF32: the xla engine on the card with PyTorch's default TF32 flags,
     equal to the plain engine; then the kernels' times at the main path's
     shapes;
 16. the bf16 score tiers (highest=False, score_passes 1, 2, 3) of K1, each
     against its plain tier under the contract on phase 3's chunk, its
     re-acquisition clip (the global strips score at the tier too),
     1080p/160/r160 with global frames and the 256x256 template, only the
     tier's kernel launched; per tier a local and a global frame timed
     beside their bounds, the plain version and F.conv2d in bf16;
 17. lanes at each tier: K2 at S = 4 (phase 4's streams) and K3 uniform and
     bucketed (phase 5's roles, 12 frames) against their plain tiers, every
     lane bit-equal to K1 on it alone; K2 at S = 8 and K3 at K = 8, all
     local, timed per tier;
 18. the JAX package's headline configuration, track_video_mega at 1 pass
     over the bench clip (run_bench, counters zeroed just before its checked
     run): 0 px, only the 1-pass K1, once a chunk; then 3 and 2 passes, 0 px
     each; frames/s of every tier;
 19. serve_streams at 1 pass over phase 7's 8 streams: 0 px, each equal to
     track_video_mega at 1 pass alone, only the 1-pass K2 launched;
 20. K4 and K5 at 3 passes against their plain versions (phase 8's checks);
     track_stream(backend="pallas_fast") over the bench clip: 0 px, the
     3-pass K5 once a frame and nothing else; pvot-torch --fast over 512
     frames of its synthetic clip: 0 px, no kernel (the torch-ops engine);
     K5 and the K4 region (321x321, 1080p/160) timed at 3 passes;
 21. the batch cadence: track_video_mega(batch=4) over 2047 frames of the
     bench clip (a 3-frame tail), equal to track_video_batched on the plain
     engine, one launch a chunk; its bound per frame
     from the cadence frames' windows and every frame's record;
 22. K1's rung ladder (pvot_torch.tools.mega_breakdown, csrc/mega_breakdown.cu):
     on a 64-frame chunk of the bench clip at every tier, the `full` rung's
     records and template bit-equal to mega_track_chunk's, `full` and
     `argmax` against their plain versions under the contract, every earlier
     rung's checksum equal to its plain version's (integer rungs exactly,
     float rungs within 1e-4 relative); then the ladder timed at every tier
     (720p/80/r60, chunk 512, global search off as in the JAX ladder), the
     counters reset just before: per-rung us a frame (CUDA events) with the
     chunk kernel's device us (torch.profiler), the deltas, the
     production K1 beside the `full` rung, and K1's bound at each tier;
 23. the global-strip probes (pvot_torch.tools.global_strip_probe,
     csrc/strip_probe.cu) on their own inputs and the border clip, counters
     reset just before: each kernel against its plain version and the numpy
     oracle (value within 1e-5 relative, (y, x) exactly; the refetch sums
     exactly), and their device us a call;
 24. the fused-argmax probe catalogue T4 (pvot_torch.tools.fused_argmax_probe,
     csrc/argmax_probe.cu), counters reset just before and read just after:
     each of its 23 probes on its own inputs against the JAX probe's own
     assertion (restated against float64 products) and against its plain
     version (integers, copies, rolls and reductions exactly; float32
     products within 1e-6 and bf16 products within 1e-5 of the plain
     version's largest value; K5 (x, y) exactly, its value within 1e-5), one
     launch of its kernel a probe and 7 of K5 for fused_region,
     fused_multitile and vmap_fused; then each probe's device us a call (200
     calls between CUDA events), its plain version's ms, its bound and the
     library call's ms (torch.max / argmax, the torch expression, matmul with
     TF32 off or on bf16 operands, a slice's clone or sum, torch.roll,
     F.conv2d; none for the step-carry probes);
 25. the same for the Pallas NCC probe ladder T5 (pvot_torch.tools
     .pallas_probe, csrc/pallas_probe.cu and the T4 kernels it shares): 17
     probes, K4 twice (small_ncc, headline_ncc; maps within 1e-4 of the
     plain version); then the product sweep (`product_sweep`): the T4 and
     T5 product probes and the product kernels' edge shapes
     (fused_argmax_probe.GEMM_EDGES: k not a multiple of the split, m =
     136, n not a multiple of 8 or 32, unaligned rows, band rows, B as (n,
     k) and as bf16 planes), each held to its check and its plain version
     within 1e-6 (float32) or 1e-5 (bf16) of the largest value, one launch
     a call, two calls bit-equal; after phase 28, beside the other
     graph-route timings, each probe's library call's device us and each
     product probe's by the graph route (`product_timings`), and with
     --parent the parent tree's product kernels (its library, built once
     there and used again in phase 31) and this tree's in turns on the
     same operands;
 26. ROADMAP C open check 1: the `xla` engine's full map of the first global
     frame of phase 3's re-acquisition clip on the card (full_f32) against
     the CPU: the same argmax, the peak within 1e-5, the whole map within
     2e-3, the worst point printed;
 27. K1's records, final state and final template at every tier (float32,
     1, 2, 3 passes) on phase 3's chunk, its re-acquisition clip, the main
     path and the batch-4 clip, as sha256 digests, equal to the parent
     tree's (PARENT_DIGESTS: the parent's K1, two launches a frame);
 28. the main path under torch.profiler: one kernel of the port (the
     persistent chunk kernel), launched once a chunk, and no commit kernel,
     in each of two sessions (the second's records count the launches, the
     first's are reported);
 29. with --parent DIR only: the parent tree at DIR and this one timed in
     turns (parent, change, change, parent), each in its own process on the
     card (`time_tree`: the main path's frames/s at every tier, K2 at S = 8,
     K3 at K = 8 and a global frame; K5's local frame at float32 and 3
     passes, K4's global frame and its 1080p/160 region at both tiers, in
     device time by the graph route, `graph_ms`; the engine path's frames/s,
     also in 4 more processes a tree, in turns; one K5 wrapper call's us,
     the parent's wrapper against this one), with the verdicts (K4 and K5
     faster in both pairs; the engine path's median of 6 runs at most 3 %
     below the parent's, or "unresolved" when one tree's runs spread wider
     than 3 %, the spread printed beside it; K1-K3 within 3 % in both pairs),
     printed, not checked; the first parent run also takes the parent's
     K4/K5 digests;
 30. K4 and K5 bit for bit against the parent tree's: sha256 digests of the
     records of phase 9's track_stream over 2048 frames (shared and
     pallas_fast), phase 11's re-acquisition clip, phase 12's 1080p/160 clip,
     phase 13's K = 4 objects and 4 streams, K5's rows and K4's maps on
     check_k5's and check_k4's kinds of input, at float32 and 3 passes, equal
     to PARENT_K45_DIGESTS and, with --parent, to the parent's run;
 31. the region-step ladder (pvot_torch.tools.region_step_breakdown) over
     1024 frames of the bench clip at shared and pallas_fast: each rung's us
     a frame, the differences, K5's device us (profiler, graph route) beside
     a wrapper call's; with --parent, in turns on the parent tree's kernel
     library (`kernels_from`), behind this tree's wrapper, so its parent
     rungs show the kernel's change and not the wrapper's (phase 29 times
     the parent's wrapper); then K4's and K5's device times by the graph
     route;
 32. serving over the scan engines and the remaining surfaces, each drive
     with the counters reset just before and read just after: (a)
     serve_streams(backend="shared") over phase 7's 8 streams, every stream
     0 px and equal to its own track_stream(shared), one K5 launch a
     lockstep frame step, K4 on the steps where a lane is global, no K1-K3,
     its frames/s beside phase 7's mega path; (b) serve_objects(shared) at K
     = 4 on phase 13's clip (one object from outside the frame, so K4 runs),
     each object equal to track_video_multi(shared), the target 0 px; (c)
     the route out of the mega envelope: two 1080p streams at radius 300
     (span 601) through serve_streams(backend="mega"), which serves on the
     CUDA engine's K4 region path: no K1-K3, 0 px; (d) pvot-torch-serve
     --search-radius 300 --scan-backend shared, exit 0, K4 only; (e)
     mega_chunk_step, one K1 launch, its rows and final template held to
     K1's plain version on phase 8's chunk; (f)
     pvot-torch --host over 128 frames of phase 10's clip, no kernel, its
     boxes phase 10's, and which host NCC ran, its seconds beside those of
     the numpy host NCC;
 34. (run before phase 33's line) the last modules: (a) the native
     library's build (build_info; phase 1 fails without it, and each
     serving phase prints its frame ring beside its frames/s) and
     pvot-torch --host's seconds on it; (b) the flow baseline, track_video_flow on the card over the
     bench clip's first 257 frames: every tensor of its state on the card,
     frames/s beside the main path's, mean box error against the ground
     truth, and its first 32 boxes equal to a CPU run of those frames; (c)
     search-sharded tracking: 2 gloo processes sharing the card, mesh (data
     1, search 2) and then (data 2, search 1), backend "pallas" (K4 on every
     slab and strip), over phase 11's re-acquisition clip: boxes and
     used_global equal to the unsharded track_video(backend="pallas"),
     scores under the contract, each rank's K4 launches (one a frame for
     its slabs, one more a frame where a stream searches globally) and no
     K5, and K4 on the first slab and strip inputs of each rank held to
     its plain version on them; (d) serve_streams over devices ["cuda:0", "cuda:0"] (two stream
     groups on one card), phase 7's 8 streams, every stream equal to phase
     7's one-device serve, its frames/s and ring;
 33. print the kernels' JSON line (each kernel's time beside its plain
     version's and its bound: the larger of its correlation FLOPs at the
     FP32 peak, or at the bf16 tensor-core peak times passes for a tier, and
     its bytes at the memory rate, counted from this run's records; for the
     ladder its `full` rung's, which is K1; for the strip probes their box
     sums' and slab sums' operations at the FP32 peak and the bytes they
     read; `library_ms` is null, as no PyTorch call computes a chunk of
     tracking, a masked NCC argmax, a strip search or a conditional slab
     sum, and `conv2d_corr_ms` times F.conv2d on the correlation term alone
     as a yardstick, in bf16 for the tiers; each kernel's `tiers` holds the
     same fields per tier; for the probe catalogues the sums over their
     probes, and each probe's fields in `probes`), the card's line, and last
     the result line.

TF32 is off from phase 3 on, except in phase 15.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import itertools
import json
import math
import re
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


def compare_outputs(name, got, want, n_px: int = 6400) -> None:
    """Two StepOutputs of one stream under the contract (the score bounds
    scaled by N / 6400 for templates of N > 6400 px, as in `compare`)."""
    for field in ("bbox", "updated", "used_global"):
        if not np.array_equal(getattr(got, field), getattr(want, field)):
            first = int(np.nonzero((getattr(got, field) != getattr(want, field)).reshape(
                len(got.bbox), -1).any(axis=1))[0][0])
            raise AssertionError(f"{name}: {field} differs first at record {first}: "
                                 f"{got.bbox[first].tolist()} {got.score[first]} vs "
                                 f"{want.bbox[first].tolist()} {want.score[first]}")
    scale = max(1.0, n_px / 6400)
    acc = want.updated
    d_acc = float(np.abs(got.score[acc] - want.score[acc]).max(initial=0.0))
    d_all = float(np.abs(got.score - want.score).max(initial=0.0))
    if d_acc > SCORE_ACC_ATOL * scale or d_all > SCORE_ATOL * scale:
        raise AssertionError(f"{name}: scores differ by {d_acc} (accepted), {d_all} (all)")


def chunk_args(frames_u8, state, config):
    return (frames_u8, torch.stack(list(state.bbox)), state.template, state.t_mean,
            state.t_std, state.lost_count, state.use_global, frames_u8.shape[0], config)


def stacked_args(states):
    """(bbox, template, t_mean, t_std, lost, use_global) stacked over streams."""
    cols = zip(*[(torch.stack(list(s.bbox)), s.template, s.t_mean, s.t_std,
                  s.lost_count, s.use_global) for s in states])
    return tuple(torch.stack(c) for c in cols)


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    chunk_kernel<1,0,6> (kOne, kExt, kStage) or ncc_kernel<h,1,0>."""
    m = re.search(
        r"\d([a-z][a-z_]*?_kernel(?:_tier|_rows|_resident)?)(?:I((?:L[bi]\d+E|[a-z])+)E)?E",
        mangled)
    if not m:
        return mangled
    args = [a or b for a, b in re.findall(r"L[bi](\d+)E|([a-z])", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_entries(log: str) -> dict:
    """{source: {kernel label: (registers, spill stores, spill loads)}} from
    the build log (one `== source` section per nvcc)."""
    out, unit, label, spills = {}, None, None, (0, 0)
    for line in log.splitlines():
        if line.startswith("== "):
            unit = line[3:].strip()
            out[unit] = {}
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            label, spills = kernel_label(m.group(1)), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and label and unit:
            out[unit][label] = (int(m.group(1)), *spills)
            label = None
    return out


# The parent tree's production kernels (PR 5, before the K1 body moved into
# mega_body.cuh): registers, spill stores and spill loads in bytes as that
# tree's chip_smoke.py phase 2 printed them from nvcc's -Xptxas -v, and its
# score blocks per SM (template side, lanes: float32 / 1 / 3 passes), on an
# NVIDIA H100 80GB HBM3 at 700 W with CUDA 12.8.
PARENT_PTXAS = {
    "score_kernel_tier<0,0,0,3>": (64, 0, 0), "score_kernel_tier<1,0,0,3>": (64, 0, 0),
    "score_kernel_tier<0,0,1,3>": (64, 28, 24), "score_kernel_tier<1,0,1,3>": (64, 0, 0),
    "score_kernel_tier<0,1,0,3>": (62, 0, 0), "score_kernel_tier<1,1,0,3>": (59, 0, 0),
    "score_kernel_tier<0,0,0,2>": (64, 0, 0), "score_kernel_tier<1,0,0,2>": (63, 0, 0),
    "score_kernel_tier<0,0,1,2>": (64, 0, 0), "score_kernel_tier<1,0,1,2>": (64, 0, 0),
    "score_kernel_tier<0,1,0,2>": (62, 0, 0), "score_kernel_tier<1,1,0,2>": (64, 0, 0),
    "score_kernel_tier<0,0,0,1>": (64, 0, 0), "score_kernel_tier<1,0,0,1>": (63, 0, 0),
    "score_kernel_tier<0,0,1,1>": (64, 0, 0), "score_kernel_tier<1,0,1,1>": (64, 0, 0),
    "score_kernel_tier<0,1,0,1>": (61, 0, 0), "score_kernel_tier<1,1,0,1>": (64, 0, 0),
    "score_kernel<0,0,0>": (64, 60, 56), "score_kernel<1,0,0>": (64, 4, 4),
    "score_kernel<0,0,1>": (98, 0, 0), "score_kernel<1,0,1>": (64, 0, 0),
    "score_kernel<0,1,0>": (97, 0, 0), "score_kernel<1,1,0>": (64, 0, 0),
    "commit_kernel<0,0>": (64, 0, 0), "commit_kernel<0,1>": (63, 0, 0),
    "commit_kernel<1,0>": (64, 0, 0), "commit_kernel<1,1>": (64, 0, 0),
    "lookahead_kernel": (22, 0, 0), "ncc_kernel<f,1,3>": (64, 0, 0),
    "ncc_kernel<f,1,0>": (43, 0, 0), "ncc_kernel<h,1,3>": (64, 0, 0),
    "ncc_kernel<h,1,0>": (43, 0, 0), "ncc_kernel<f,0,3>": (61, 0, 0),
    "ncc_kernel<f,0,0>": (44, 0, 0), "ncc_kernel<h,0,3>": (57, 0, 0),
    "ncc_kernel<h,0,0>": (44, 0, 0),
}


def parent_label(label: str) -> str:
    """The parent tree's kernel for a production kernel of this one: the
    persistent chunk kernel chunk_kernel<kOne,kExt,6> (float32, whole
    template), chunk_kernel_rows<kOne,kExt> (float32, in row chunks) and
    chunk_kernel_tier<kWhole,kOne,kExt,kPasses,6> replace the score kernels
    of the same case (the commit kernel is gone); other labels unchanged."""
    label = re.sub(r"^chunk_kernel<(\d),(\d),6>$", r"score_kernel<1,\1,\2>", label)
    label = re.sub(r"^chunk_kernel_rows<(\d),(\d)>$", r"score_kernel<0,\1,\2>", label)
    label = re.sub(r"^ncc_kernel<(\w),(\d),(\d),\d+>$", r"ncc_kernel<\1,\2,\3>", label)
    return re.sub(r"^chunk_kernel_tier<(.*),6>$", r"score_kernel_tier<\1>", label)


PARENT_BLOCKS_PER_SM = {(80, 1): (2, 2, 2), (80, 8): (2, 2, 2), (160, 1): (1, 1, 1),
                        (256, 1): (1, 1, 1)}


# K1's outputs on the parent tree (two launches a frame), as
# `k1_digests` prints them: sha256 of the records, the final state and the
# final template at every tier, on an NVIDIA H100 80GB HBM3 at 700 W with
# CUDA 12.8 (the parent tree's K1 run through the same function).  The
# persistent K1 must give these bits.
PARENT_DIGESTS = {
    "chunk64": {
        "f32": "5a0d89fae0a53ff4",
        "1pass": "88b2ab4267b322d7",
        "2pass": "fced4feae490b4b8",
        "3pass": "a432dfcfbb6b2419",
    },
    "reacquire48": {
        "f32": "415cb5f05156d50a",
        "1pass": "94fb43282be5c4fb",
        "2pass": "7e64ba644e3d71ed",
        "3pass": "8451e64cc41e7877",
    },
    "main2048": {
        "f32": "5a9ee23f9aa67c91",
        "1pass": "3783511bc1175a3f",
        "2pass": "9232438d40890a22",
        "3pass": "9b1396ecb0686b07",
    },
    "batch4_2047": {
        "f32": "11e72ba7b7d96e54",
        "1pass": "0731f426a26e586c",
        "2pass": "27483ddae84b655e",
        "3pass": "3a399573b6efa272",
    },
}


# K4's and K5's outputs on the parent tree (one 8 x 16 tile a block), as
# `k45_digests` prints them, on an NVIDIA H100 80GB HBM3 at 700 W with CUDA
# 12.8 (the parent tree's package run through the same function).  The
# redesigned tile body must give these bits.
PARENT_K45_DIGESTS = {
    "main2048_stream": {"f32": "e8430cc717318e83", "3pass": "8e9221193b05167f"},
    "reacquire48": {"f32": "5ad05819791e36fc", "3pass": "02c7c8aa64ddf946"},
    "r160_1080p": {"f32": "b3df154383fc5725", "3pass": "c6ce7ed38e619c53"},
    "objects4": {"f32": "576af1994543d143", "3pass": "171c929b46c9ba17"},
    "streams4": {"f32": "5879b2c070d91a8f", "3pass": "87b352649056fd24"},
    "k5_rows": {"f32": "90f1aa8f1c103ba5", "3pass": "cfe24b32169b45f5"},
    "k4_maps": {"f32": "c54eb7e6322c2f31", "3pass": "e5fc8c2af9a9b908"},
}


def k1_digests(dev, clip, gclip, gconfig, launch_one) -> dict:
    """sha256 digests (first 16 hex digits) of K1's outputs at every tier,
    {case: {tier: digest}}: phase 3's chunk (64 frames of the bench clip)
    and its re-acquisition clip (48 frames, global frames included) through
    K1's C entry, the records, final state_i, state_f and padded template
    (`launch_one` runs it); the main path (track_video_mega over the bench
    clip's 2048 frames, chunk 512) and the batch-4 clip (its first 2047
    frames at batch 4: a 3-frame tail), the records and every field of the
    final TrackerState."""
    from pvot_torch.bench import state_at
    from pvot_torch.config import TrackerConfig
    from pvot_torch.tracker.mega import track_video_mega

    def digest(*values) -> str:
        h = hashlib.sha256()
        for v in values:
            v = v.detach().cpu().contiguous().numpy() if torch.is_tensor(v) else np.asarray(v)
            h.update(np.ascontiguousarray(v).tobytes())
        return h.hexdigest()[:16]

    config = TrackerConfig()
    spec, frames = clip
    gspec, gframes = gclip
    state, gstate = state_at(spec, frames, 0, dev), state_at(gspec, gframes, 0, dev)
    staged = torch.from_numpy(frames[1:2049]).to(dev)
    chunks = {"chunk64": (staged[:64], state, config),
              "reacquire48": (torch.from_numpy(gframes[1:]).to(dev), gstate, gconfig)}
    tracks = {"main2048": dict(frames=staged, batch=1),
              "batch4_2047": dict(frames=staged[:2047], batch=4)}
    out = {}
    for tier, kw in (("f32", dict(highest=True)), ("1pass", dict(highest=False, score_passes=1)),
                     ("2pass", dict(highest=False, score_passes=2)),
                     ("3pass", dict(highest=False, score_passes=3))):
        for name, (fr, st, cfg) in chunks.items():
            out.setdefault(name, {})[tier] = digest(*launch_one(fr, st, cfg, kw))
        for name, t in tracks.items():
            final, rec = track_video_mega(t["frames"], state, config, chunk_size=512,
                                          batch=t["batch"], **kw)
            out.setdefault(name, {})[tier] = digest(*rec, *final)
    return out


def _digest(*values) -> str:
    """sha256 (first 16 hex digits) of arrays or tensors, in order."""
    h = hashlib.sha256()
    for v in values:
        v = v.detach().cpu().contiguous().numpy() if torch.is_tensor(v) else np.asarray(v)
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def k45_digests(dev, clip) -> dict:
    """sha256 digests (first 16 hex digits) of what K4 and K5 decide, at
    float32 and 3 passes, {case: {"f32" | "3pass": digest}}, through entry
    points that the parent tree has too: the records of track_stream over the
    bench clip's 2048 frames (backend shared / pallas_fast: K5 every frame),
    of track_video over phase 3's re-acquisition clip (K4 on its global
    frames) and its 1080p/160/r160 clip with 2 frames from a state set
    global (K4's region path), of track_video_multi with phase 5's K = 4
    objects and of the masked scan over phase 4's 4 streams; then K5's rows
    (check_k5's lanes on bench and random frames, u8 and f32, and its forced
    tie) and K4's maps (check_k4's shapes) on inputs from a fixed seed."""
    from pvot_torch.bench import state_at
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.gray import gray_u8_to_f32
    from pvot_torch.io.pipeline import track_stream
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot_torch.ops.ncc_pallas import ncc_map_pallas, region_argmax_lanes
    from pvot_torch.ops.ncc_reference import template_stats
    from pvot_torch.parallel.multi import (
        init_multi_state, make_multi_stream_step, make_stream_masked_scan_fn, stack_states,
        track_video_multi,
    )
    from pvot_torch.tracker.scan import track_video

    config = TrackerConfig()
    spec, frames = clip
    state = state_at(spec, frames, 0, dev)
    gspec = SyntheticSpec(width=1280, height=720, num_frames=49, target_w=80, target_h=80,
                          seed=2, exit_and_reenter=True)
    gframes = generate_gray_video(gspec)
    gconfig = TrackerConfig(lost_frame_threshold=5)
    gstate = state_at(gspec, gframes, 0, dev)
    bspec = SyntheticSpec(width=1920, height=1080, num_frames=7, target_w=160, target_h=160,
                          seed=3, exit_and_reenter=True)
    bframes = generate_gray_video(bspec)
    bconfig = TrackerConfig(search_radius_x=160, search_radius_y=160, lost_frame_threshold=2)
    bstate = state_at(bspec, bframes, 0, dev)
    bheld = bstate._replace(use_global=torch.tensor(True, device=dev))
    oclip = frames[:49].copy()
    prng = np.random.default_rng(7)
    for px, py in ((200, 100), (900, 500), (600, 80)):
        oclip[:, py : py + 80, px : px + 80] = prng.integers(0, 256, (80, 80), np.uint8)
    g0 = gray_u8_to_f32(oclip[0])
    tx, ty = target_bbox(spec, 0)[:2]
    cut_at = [(tx, ty), (200, 100), (900, 500), (600, 80)]
    start_at = [(tx, ty), (200, 100), (900, 500), (-300, 300)]
    uni = [g0[y : y + 80, x : x + 80] for x, y in cut_at]
    urois = [(x, y, 80, 80) for x, y in start_at]
    fr4 = torch.from_numpy(np.stack([frames[1:49], gframes[1:49], frames[400:448],
                                     frames[800:848]])).to(dev)
    sstates = stack_states([state, gstate, state_at(spec, frames, 399, dev),
                            state_at(spec, frames, 799, dev)])
    valid = np.stack([np.arange(48) < n for n in (48, 48, 0, 20)], axis=1)
    out = {}
    for tier, backend, passes in (("f32", "shared", 0), ("3pass", "pallas_fast", 3)):
        _, rec = track_stream(iter(frames[1:2049]), state, frames.shape[1:], config,
                              backend=backend, chunk_size=32)
        out.setdefault("main2048_stream", {})[tier] = _digest(*rec)
        _, rec = track_video(gframes[1:], gstate, gconfig, backend=backend)
        out.setdefault("reacquire48", {})[tier] = _digest(*rec)
        _, rec = track_video(bframes[1:], bstate, bconfig, backend=backend)
        _, held = track_video(bframes[1:3], bheld, bconfig, backend=backend)
        out.setdefault("r160_1080p", {})[tier] = _digest(*rec, *held)
        _, rec = track_video_multi(oclip[1:], init_multi_state(uni, urois, device=dev), config,
                                   backend=backend)
        out.setdefault("objects4", {})[tier] = _digest(*rec)
        scan = make_stream_masked_scan_fn(make_multi_stream_step(
            (720, 1280), (80, 80), gconfig, backend=backend))
        _, rec = scan(sstates, fr4.permute(1, 0, 2, 3), valid)
        out.setdefault("streams4", {})[tier] = _digest(*rec)
        # K5 rows and K4 maps on check_k5's and check_k4's kinds of input.
        rng = np.random.default_rng(29)
        x, y, w, h = target_bbox(spec, 0)
        templ = torch.from_numpy(frames[0, y : y + h, x : x + w]).to(dev).float() / 255.0
        tm, ts = template_stats(templ)
        lanes = [(x - 60, y - 60, 0, 120, 0, 120), (x - 50, y - 70, 5, 100, 11, 117),
                 (100, 200, 70, 120, 0, 40), (30, 40, 10, 9, 0, 120)]
        rows = [region_argmax_lanes(images, templ, tm, ts, lanes, (121, 121), passes)
                for images in (torch.from_numpy(frames[1:5]).to(dev),
                               torch.from_numpy(frames[3]).to(dev),
                               torch.from_numpy(frames[3]).to(dev).float() / 255.0,
                               torch.from_numpy(rng.random((4, 720, 1280), dtype=np.float32)
                                                ).to(dev))]
        flat = torch.full((1, 300, 300), 0.5, device=dev)
        rows.append(region_argmax_lanes(flat, templ[:16, :16].contiguous(),
                                        *template_stats(templ[:16, :16]),
                                        [(0, 0, 7, 60, 13, 50)], (121, 121), passes))
        out.setdefault("k5_rows", {})[tier] = _digest(*rows)
        maps = []
        for (ih, iw), (th, tw), u8 in (((720, 1280), (80, 80), True),
                                       ((720, 1280), (80, 80), False),
                                       ((1080, 1920), (160, 160), True),
                                       ((57, 133), (9, 11), False), ((200, 140), (17, 13), True),
                                       ((300, 301), (80, 256), False)):
            img = (torch.from_numpy(rng.integers(0, 256, (ih, iw), np.uint8)) if u8
                   else torch.from_numpy(rng.random((ih, iw), dtype=np.float32))).to(dev)
            t = torch.from_numpy(rng.random((th, tw), dtype=np.float32)).to(dev)
            maps.append(ncc_map_pallas(img, t, highest=passes == 0))
        out.setdefault("k4_maps", {})[tier] = _digest(*maps)
    return out


def graph_ms(launch, n: int = 100, replays: int = 5) -> float:
    """A kernel's device ms a launch: CUDA events around replays of a CUDA
    graph of n calls of launch(stream handle), captured after a warm call;
    the launches' host time stays out of it.  The same route as
    `pvot_torch.tools.region_step_breakdown.graph_us`, which this tree's
    process uses; phase 29's `time_tree` children use this copy, since the
    parent tree's `pvot_torch` has no such tool and both trees must be timed
    by one code."""
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
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n)


def k45_inputs(dev, clip) -> dict:
    """The operands of phase 29's K4/K5 timings: K5's local frame at 720p /
    80x80 / r60 (bench frame 1, the template at the ground-truth box, the
    whole window), K4's global frame (the same frame and template) and its
    321 x 321 region at 1080p / 160x160 / r160 (phase 3's 1080p clip)."""
    from pvot_torch.bench import state_at
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox

    spec, frames = clip
    st = state_at(spec, frames, 0, dev)
    x, y = target_bbox(spec, 0)[:2]
    bspec = SyntheticSpec(width=1920, height=1080, num_frames=1, target_w=160, target_h=160,
                          seed=3, exit_and_reenter=True)
    bframes = generate_gray_video(bspec)
    bst = state_at(bspec, bframes, 0, dev)
    bx, by = target_bbox(bspec, 0)[:2]
    return {"frame": torch.from_numpy(frames[1]).to(dev), "state": st,
            "lane": torch.tensor([[x - 60, y - 60, 0, 120, 0, 120]], dtype=torch.int32,
                                 device=dev),
            "bframe": torch.from_numpy(bframes[0]).to(dev), "bstate": bst,
            "blane": torch.tensor([[max(bx - 160, 0), max(by - 160, 0), 0, 320, 0, 320]],
                                  dtype=torch.int32, device=dev)}


def k45_device_ms(dev, clip, timer=graph_ms) -> dict:
    """K5's and K4's device ms a launch by the graph route (`timer(launch,
    n)`, `graph_ms` by default), through their C entries, whose signatures
    the parent tree shares, on preallocated operands (`k45_inputs`): K5's
    local frame at float32 and 3 passes (it leaves its counter at zero, so
    the launches repeat), K4's global frame at float32 (as the engines score
    full maps) and its 1080p region at both tiers."""
    from pvot_torch.ops import _build

    lib = _build.load_library()
    a = k45_inputs(dev, clip)
    st, bst = a["state"], a["bstate"]
    ptr = lambda t: t.data_ptr()  # noqa: E731
    tiles = 16 * 8
    part_val = torch.zeros(tiles, dtype=torch.float32, device=dev)
    part_yx = torch.zeros(2 * tiles, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.empty((1, 3), dtype=torch.float32, device=dev)
    gmap = torch.empty((1, 641, 1201), dtype=torch.float32, device=dev)
    rmap = torch.empty((1, 321, 321), dtype=torch.float32, device=dev)

    def k5(passes):
        return lambda s: _build.check(lib.pvot_ncc_region_argmax(
            ptr(a["frame"]), 1, 720, 1280, 1280, 0, ptr(a["lane"]), 1, 121, 121,
            ptr(st.template), 0, 80, 80, ptr(st.t_mean), ptr(st.t_std), 0, ptr(rows),
            ptr(part_val), ptr(part_yx), ptr(done), passes, s), "K5")

    def k4_region(passes):
        return lambda s: _build.check(lib.pvot_ncc_map(
            ptr(a["bframe"]), 1, 1080, 1920, 1920, 0, ptr(a["blane"]), 1, 321, 321,
            ptr(bst.template), 0, 160, 160, ptr(bst.t_mean), ptr(bst.t_std), 0, ptr(rmap),
            passes, s), "K4 region")

    return {"k5_local_f32_ms": timer(k5(0), 100), "k5_local_3pass_ms": timer(k5(3), 100),
            "k4_global_f32_ms": timer(lambda s: _build.check(lib.pvot_ncc_map(
                ptr(a["frame"]), 1, 720, 1280, 1280, 0, None, 1, 641, 1201, ptr(st.template),
                0, 80, 80, ptr(st.t_mean), ptr(st.t_std), 0, ptr(gmap), 0, s), "K4 global"), 20),
            "k4_region_f32_ms": timer(k4_region(0), 20),
            "k4_region_3pass_ms": timer(k4_region(3), 20)}


def k5_call_us(dev, clip) -> dict:
    """One K5 wrapper call's us (`region_argmax_lanes`, which both trees
    have, on `k45_inputs`' local frame at float32 and 3 passes): CUDA events
    around 200 calls after a warm one.  The kernel takes 18-30 us, less than
    the call's host work, so this reads the wrapper's host time a call: its
    checks, the lane ints' copy, the scratch and the stats it passes."""
    from pvot_torch.ops.ncc_pallas import region_argmax_lanes

    a = k45_inputs(dev, clip)
    st = a["state"]
    lane = [tuple(int(v) for v in a["lane"][0].tolist())]
    out = {}
    for name, passes in (("f32", 0), ("3pass", 3)):
        call = functools.partial(region_argmax_lanes, a["frame"], st.template, st.t_mean,
                                 st.t_std, lane, (121, 121), passes)
        out[f"k5_call_{name}_us"] = time_ms(call, 200) * 1e3
    return out


@contextlib.contextmanager
def kernels_from(path: str = None):
    """Within the block, the wrappers launch the kernels of the library at
    `path` (bound as pvot_torch.ops._build binds its own, each entry it has;
    K4/K5's C entries keep their signatures across the trees); None: this
    tree's.  Phase 31 runs the region-step ladder on the parent's library."""
    import ctypes

    from pvot_torch.ops import _build

    if path is None:
        yield
        return
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    saved = _build.load_library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def engine_fps(dev, clip) -> float:
    """Frames/s of the engine path, track_stream(shared) over the bench
    clip's 2048 frames from its ground-truth box, host clock, best of 3 after
    a warm 64 frames, each run 0 px."""
    from pvot_torch.bench import max_l1_err_px, state_at
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.pipeline import track_stream

    spec, frames = clip
    state, config = state_at(spec, frames, 0, dev), TrackerConfig()
    track_stream(iter(frames[1:65]), state, frames.shape[1:], config, backend="shared")
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        _, rec = track_stream(iter(frames[1:2049]), state, frames.shape[1:], config,
                              backend="shared", chunk_size=32)
        best = min(best, time.perf_counter() - t0)
        if max_l1_err_px(spec, rec.bbox) != 0:
            raise AssertionError("the engine path is off the ground truth")
    return 2048 / best


def time_tree(clip_path: str, digests: bool = False) -> dict:
    """The timings that phase 29 takes of one tree, in a process whose
    `pvot_torch` is that tree's (parent or change; only entry points both
    have): frames/s of the main path (`run_bench` over the bench clip, saved
    at `clip_path`) at float32 and 1, 2 and 3 passes, each 0 px; ms a step of
    K2 at S = 8 and K3 at K = 8, all local, and of K1 on a global frame;
    K5's and K4's device ms a launch (`k45_device_ms`) and a K5 wrapper
    call's us (`k5_call_us`); the engine path's
    frames/s (track_stream(shared) over the clip's 2048 frames, host clock,
    best of 3, each 0 px); with `digests`, `k45_digests` of the tree."""
    from pvot_torch.bench import run_bench, state_at
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.synthetic import SyntheticSpec
    from pvot_torch.ops.ncc_mega import (
        mega_track_chunk, mega_track_chunk_multi, mega_track_chunk_objects,
    )
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.tracker.state import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    frames = np.load(clip_path)
    spec = SyntheticSpec(width=1280, height=720, num_frames=frames.shape[0], target_w=80,
                         target_h=80, seed=1)
    config = TrackerConfig()
    out = {"pvot_torch": __import__("pvot_torch").__file__}
    for name, kw in (("f32", {}), ("1pass", dict(highest=False, score_passes=1)),
                     ("2pass", dict(highest=False, score_passes=2)),
                     ("3pass", dict(highest=False, score_passes=3))):
        r = run_bench(clip=(spec, frames), **kw)
        if r["max_l1_err_px"] != 0:
            raise AssertionError(f"{name}: main path {r['max_l1_err_px']} px off")
        out[f"main_{name}_fps"] = r["value"]
    states = [state_at(spec, frames, 64 * i, dev) for i in range(8)]
    f8 = torch.stack([torch.from_numpy(frames[64 * i + 1 : 64 * i + 33])
                      for i in range(8)]).to(dev)
    s8 = stacked_args(states)
    nv8 = torch.full((8,), 32, dtype=torch.int32, device=dev)
    out["k2_s8_ms_per_step"] = time_ms(lambda: mega_track_chunk_multi(f8, *s8, nv8, config),
                                       20) / 32
    k8 = stack_states([states[0]] * 8)
    lchunk = torch.from_numpy(frames[1:49]).to(dev)
    k8args = (lchunk, torch.stack(list(k8.bbox), dim=-1), k8.template, k8.t_mean, k8.t_std,
              k8.lost_count, k8.use_global, 48, config)
    out["k3_k8_ms_per_step"] = time_ms(lambda: mega_track_chunk_objects(*k8args), 20) / 48
    noise = np.random.default_rng(8).random((80, 80), dtype=np.float32)
    held = init_state(noise, (600, 300, 80, 80), device=dev)._replace(
        use_global=torch.tensor(True, device=dev))
    hargs = chunk_args(lchunk[:16], held, config)
    out["k1_global_ms_per_frame"] = time_ms(lambda: mega_track_chunk(*hargs), 5) / 16
    out.update(k45_device_ms(dev, (spec, frames)))
    out.update(k5_call_us(dev, (spec, frames)))
    out["engine_fps"] = engine_fps(dev, (spec, frames))
    if digests:
        out["k45_digests"] = k45_digests(dev, (spec, frames))
    return out


def in_turns(parent_root: str, frames: np.ndarray) -> dict:
    """Phase 29: `time_tree` of the parent tree at `parent_root` and of this
    one in turns (parent, change, change, parent), each in its own process
    on this card.  Returns {"runs": [(tree, timings)], "verdicts"}: the
    float32 main path faster than the parent in both pairs, and each other
    timing at most 3 % slower than the parent in both pairs."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    clip_path = os.path.join(here, "build", "in_turns_clip.npy")
    os.makedirs(os.path.dirname(clip_path), exist_ok=True)
    np.save(clip_path, frames)
    runs = []
    for i, (tree, root) in enumerate((("parent", parent_root), ("change", here),
                                      ("change", here), ("parent", parent_root))):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                               os.path.abspath(root), clip_path] + (["digests"] if i == 0 else []),
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"timing the {tree} tree failed:\n{proc.stderr[-3000:]}")
        runs.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"in turns, {tree}: {json.dumps(runs[-1][1])}", flush=True)
    # The engine path is host-bound and swings more between processes of one
    # tree than the bound: four more processes a tree time it alone, in turns,
    # and its verdict compares the trees' medians of their six runs.
    engine = {"parent": [runs[0][1]["engine_fps"], runs[3][1]["engine_fps"]],
              "change": [runs[1][1]["engine_fps"], runs[2][1]["engine_fps"]]}
    for tree, root in (("parent", parent_root), ("change", here), ("change", here),
                       ("parent", parent_root)) * 2:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                               os.path.abspath(root), clip_path, "engine"],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"timing the {tree} tree failed:\n{proc.stderr[-3000:]}")
        engine[tree].append(json.loads(proc.stdout.strip().splitlines()[-1])["engine_fps"])
    print(f"in turns, the engine path's frames/s: {json.dumps(engine)}", flush=True)
    pairs = ((runs[0][1], runs[1][1]), (runs[3][1], runs[2][1]))  # (parent, change)
    verdicts = {}
    for key in ("k5_local_f32_ms", "k5_local_3pass_ms", "k4_global_f32_ms", "k4_region_f32_ms",
                "k4_region_3pass_ms"):
        verdicts[f"{key}_faster"] = all(c[key] < p_[key] for p_, c in pairs)
    # A median of six cannot resolve a 3 % bound when one tree's own runs
    # spread wider than that: the verdict then says so instead of passing.
    med = {t: float(np.median(v)) for t, v in engine.items()}
    spread = {t: (max(v) - min(v)) / med[t] for t, v in engine.items()}
    ratio = med["change"] / med["parent"]
    verdicts["engine_fps_median_change_over_parent"] = ratio
    verdicts["engine_fps_spread_within_tree"] = spread
    verdicts["engine_fps_median_at_most_3pct_lower"] = (
        f"unresolved: one tree's runs spread {max(spread.values()):.1%}, more than the 3 % "
        f"bound" if max(spread.values()) > 0.03 else ratio >= 0.97)
    print(f"in turns, the engine path: medians {med['change']:.1f} (change) against "
          f"{med['parent']:.1f} (parent) frames/s, x{ratio:.4f}; each tree's spread (max - min) "
          f"/ median: parent {spread['parent']:.1%}, change {spread['change']:.1%}; a 3 % "
          f"verdict: {verdicts['engine_fps_median_at_most_3pct_lower']}", flush=True)
    print("in turns, a K5 wrapper call's us (events, host time; parent, change, change, "
          "parent): " + "; ".join(
              f"{k} " + " / ".join(f"{r[k]:.2f}" for _, r in runs)
              for k in ("k5_call_f32_us", "k5_call_3pass_us")), flush=True)
    for key in ("main_f32_fps", "main_1pass_fps", "main_2pass_fps", "main_3pass_fps"):
        verdicts[f"{key}_within_3pct"] = all(c[key] >= 0.97 * p_[key] for p_, c in pairs)
    for key in ("k2_s8_ms_per_step", "k3_k8_ms_per_step", "k1_global_ms_per_frame"):
        verdicts[f"{key}_within_3pct"] = all(c[key] <= 1.03 * p_[key] for p_, c in pairs)
    return {"runs": runs, "engine_fps": engine, "verdicts": verdicts,
            "parent_k45_digests": runs[0][1].pop("k45_digests")}

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


K4_ATOL = 1e-4  # pvot/ops/ncc_pallas.py:650-654: the JAX probe's bound for a map
TIERS = (1, 2, 3)  # the chunk kernels' bf16 score passes (highest=False)
K5_ATOL = 1e-5  # the fused argmax's value; (x, y) exactly


def check_k4(dev, rng, highest: bool = True) -> float:
    """K4 (ncc_map_lanes) against its plain version on random-uniform images:
    720p / 80x80, 1080p / 160x160 and odd shapes, u8 and f32, at the tier
    `highest` selects (False: 3 bf16 passes); at the float32 tier also the
    batched form over N = 8 frames equal to N single calls.  Returns the
    largest absolute difference."""
    from pvot_torch.ops.ncc_pallas import (
        ncc_map_lanes_reference, ncc_map_pallas, ncc_map_pallas_batched,
        ncc_map_pallas_reference,
    )

    err = 0.0
    tier = "f32" if highest else "3-pass"
    for (h, w), (th, tw), u8 in (((720, 1280), (80, 80), True), ((720, 1280), (80, 80), False),
                                 ((1080, 1920), (160, 160), True), ((57, 133), (9, 11), False),
                                 ((200, 140), (17, 13), True), ((300, 301), (80, 256), False),
                                 ((400, 421), (176, 176), True), ((330, 301), (256, 256), False),
                                 ((150, 171), (37, 45), True)):
        img = (torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)) if u8
               else torch.from_numpy(rng.random((h, w), dtype=np.float32))).to(dev)
        templ = torch.from_numpy(rng.random((th, tw), dtype=np.float32)).to(dev)
        got = ncc_map_pallas(img, templ, highest=highest)
        want = ncc_map_pallas_reference(img, templ, highest=highest)
        d = float((got - want).abs().max())
        print(f"K4 {tier} {h}x{w} / {th}x{tw} {'u8' if u8 else 'f32'}: map {tuple(got.shape)}, "
              f"max |kernel - plain| {d:.3g} (<= {K4_ATOL})")
        if not d <= K4_ATOL:
            raise AssertionError("K4 and its plain version disagree")
        err = max(err, d)
    err = max(err, k4_lanes(dev, rng, highest))
    if not highest:
        return err
    frames = torch.from_numpy(rng.integers(0, 256, (8, 720, 1280), np.uint8)).to(dev)
    templ = frames[0, 300:380, 600:680].float() / 255.0
    batched = ncc_map_pallas_batched(frames, templ)
    for i in range(8):
        if not torch.equal(batched[i], ncc_map_pallas(frames[i], templ)):
            raise AssertionError(f"K4 batched frame {i} differs from its single call")
    from pvot_torch.ops.ncc_reference import template_stats

    t_mean, t_std = template_stats(templ)
    d = float((batched - ncc_map_lanes_reference(frames, templ, t_mean, t_std)).abs().max())
    print(f"K4 batched N=8 720p/80 u8: equal to 8 single calls; max |kernel - plain| {d:.3g}")
    if not d <= K4_ATOL:
        raise AssertionError("K4 batched and its plain version disagree")
    return max(err, d)


def k4_lanes(dev, rng, highest: bool) -> float:
    """K4 over 1, 4 and 8 lanes (ncc_map_lanes) against its plain version,
    maps within 1e-4: lanes on one frame with origins at varied x0 mod 16 and
    one template, and lanes on their own frames with their own templates,
    u8 and f32, maps that are not whole tiles (77 x 133) and a 321 x 321
    region of a 160 x 160 template in row chunks.  Returns the largest
    absolute difference."""
    from pvot_torch.ops.ncc_pallas import ncc_map_lanes, ncc_map_lanes_reference
    from pvot_torch.ops.ncc_reference import template_stats

    passes = 0 if highest else 3
    err = 0.0
    for n in (1, 4, 8):
        for u8 in (True, False):
            imgs = (torch.from_numpy(rng.integers(0, 256, (n, 480, 640), np.uint8)) if u8
                    else torch.from_numpy(rng.random((n, 480, 640), dtype=np.float32))).to(dev)
            tpls = torch.from_numpy(rng.random((n, 80, 80), dtype=np.float32)).to(dev)
            stats = [template_stats(t) for t in tpls]
            tms, tss = torch.stack([m for m, _ in stats]), torch.stack([s_ for _, s_ in stats])
            origins = [(16 * i + i % 16 + 3 * (i // 2), 7 * i) for i in range(n)]
            for label, args in (("one frame, one template", (imgs[0], tpls[0], tms[0], tss[0])),
                                ("own frames and templates", (imgs, tpls, tms, tss))):
                got = ncc_map_lanes(*args, origins, (77, 133), passes)
                want = ncc_map_lanes_reference(*args, origins, (77, 133), passes)
                d = float((got - want).abs().max())
                if not d <= K4_ATOL:
                    raise AssertionError(f"K4 {n} lanes, {label}, {'u8' if u8 else 'f32'}: "
                                         f"{d} from the plain version")
                err = max(err, d)
    big = torch.from_numpy(rng.integers(0, 256, (1080, 1920), np.uint8)).to(dev)
    t160 = torch.from_numpy(rng.random((160, 160), dtype=np.float32)).to(dev)
    m160, s160 = template_stats(t160)
    d = float((ncc_map_lanes(big, t160, m160, s160, [(777, 333)], (321, 321), passes)
               - ncc_map_lanes_reference(big, t160, m160, s160, [(777, 333)], (321, 321),
                                         passes)).abs().max())
    if not d <= K4_ATOL:
        raise AssertionError(f"K4 1080p/160 region: {d} from the plain version")
    print(f"K4 {'f32' if highest else '3-pass'} lanes (1, 4, 8; one frame and own frames, "
          f"u8 and f32, 77x133 maps) and the 1080p/160 321x321 region: max "
          f"|kernel - plain| {max(err, d):.3g} (<= {K4_ATOL})")
    return max(err, d)


def check_k5(dev, clip, rng, passes: int = 0) -> float:
    """K5 (region_argmax_lanes) against its plain version at the tier
    `passes` (0: float32, 3: bf16 hi/lo): the value within 1e-5 and (x, y)
    exactly, at 720p / 80x80 / span 121 on the bench clip's frames (the
    target's template) and on random ones, with windows whole, partly masked
    and fully masked, u8 and f32, lanes sharing one frame and lanes each with
    their own; and forced ties (a constant region, whose every position
    scores the same, must give the window's first position).  Returns the
    largest value difference."""
    from pvot_torch.ops.ncc_pallas import region_argmax_lanes, region_argmax_lanes_reference

    spec, frames = clip
    from pvot_torch.io.synthetic import target_bbox

    x, y, w, h = target_bbox(spec, 0)
    templ = torch.from_numpy(frames[0, y : y + h, x : x + w]).to(dev).float() / 255.0
    from pvot_torch.ops.ncc_reference import template_stats

    t_mean, t_std = template_stats(templ)
    span = (121, 121)
    lanes = [  # (x0, y0, rx0, rx1, ry0, ry1)
        (x - 60, y - 60, 0, 120, 0, 120),       # whole window
        (x - 50, y - 70, 5, 100, 11, 117),      # partly masked
        (100, 200, 70, 120, 0, 40),             # partly masked, off the target
        (30, 40, 10, 9, 0, 120),                # fully masked: (-inf, x0, y0)
    ]
    err = 0.0
    for label, images in (
        ("bench frames, own frame a lane, u8", torch.from_numpy(frames[1:5]).to(dev)),
        ("bench frame shared by 4 lanes, u8", torch.from_numpy(frames[3]).to(dev)),
        ("bench frame shared, f32", torch.from_numpy(frames[3]).to(dev).float() / 255.0),
        ("random frames, f32", torch.from_numpy(rng.random((4, 720, 1280), dtype=np.float32)
                                                ).to(dev)),
    ):
        label = f"{label}, {passes or 'f32'}{'-pass' if passes else ''}"
        got = region_argmax_lanes(images, templ, t_mean, t_std, lanes, span,
                                  passes).cpu().numpy()
        want = region_argmax_lanes_reference(images, templ, t_mean, t_std, lanes,
                                             span, passes).cpu().numpy()
        if not (np.array_equal(got[:, 1:], want[:, 1:])
                and np.array_equal(np.isfinite(got[:, 0]), np.isfinite(want[:, 0]))):
            raise AssertionError(f"K5 {label}: kernel {got.tolist()} vs plain {want.tolist()}")
        fin = np.isfinite(want[:, 0])
        d = float(np.abs(got[fin, 0] - want[fin, 0]).max())
        if not (d <= K5_ATOL and got[3].tolist() == [-np.inf, 30.0, 40.0]):
            raise AssertionError(f"K5 {label}: value differs by {d} or the masked lane is "
                                 f"{got[3].tolist()}")
        print(f"K5 {label}: (x, y) equal on 4 lanes, max |value diff| {d:.3g} (<= {K5_ATOL}); "
              f"fully masked lane {got[3].tolist()}")
        err = max(err, d)
    err = max(err, k5_edges(dev, frames, templ, t_mean, t_std, rng, passes))
    flat = torch.full((1, 300, 300), 0.5, device=dev)
    tie = [(0, 0, 7, 60, 13, 50)]
    got = region_argmax_lanes(flat, templ[:16, :16].contiguous(), *template_stats(
        templ[:16, :16]), tie, (121, 121), passes).cpu().numpy()[0]
    if got[1:].tolist() != [7.0, 13.0]:
        raise AssertionError(f"K5 tie on a constant region went to {got[1:].tolist()}, not (7, 13)")
    print(f"K5 forced tie (constant region, passes {passes}): the window's first position "
          f"(7, 13)")
    return err


def k5_edges(dev, frames, templ, t_mean, t_std, rng, passes: int) -> float:
    """The K5 cases that cross the tile body's edges, each against the plain
    version (value within 1e-5, (x, y) exactly): every window origin x0 mod
    16 from 0 to 15 (16 lanes on one frame, u8 and f32); 1, 4 and 8 lanes
    on their own frames with their own templates (u8 bench frames, f32
    random ones); templates whose width is not a multiple of 4 (80x78,
    37x45) and templates in row chunks (176x176, 256x256) at spans that are
    not whole tiles; a lane whose region runs past the frame.  Returns the
    largest value difference."""
    from pvot_torch.ops.ncc_pallas import region_argmax_lanes, region_argmax_lanes_reference
    from pvot_torch.ops.ncc_reference import template_stats

    u8 = torch.from_numpy(frames[1:9]).to(dev)
    rand = torch.from_numpy(rng.random((8, 720, 1280), dtype=np.float32)).to(dev)
    x0, y0 = 540, 240
    cases = []
    mod16 = [(x0 + m, y0 + m % 5, m % 3, 120 - m % 4, m % 7, 120) for m in range(16)]
    cases += [("x0 mod 16 = 0..15, shared u8 frame", u8[0], templ, t_mean, t_std, mod16,
               (121, 121)),
              ("x0 mod 16 = 0..15, shared f32 frame", rand[0], templ, t_mean, t_std, mod16,
               (121, 121))]
    for n in (1, 4, 8):
        tpls = torch.stack([templ * (1 + 0.01 * i) for i in range(n)])
        stats = [template_stats(t) for t in tpls]
        tms, tss = torch.stack([m for m, _ in stats]), torch.stack([s_ for _, s_ in stats])
        cases += [(f"{n} lanes, own u8 frames and templates", u8[:n], tpls, tms, tss,
                   mod16[:n], (121, 121)),
                  (f"{n} lanes, own f32 frames and templates", rand[:n], tpls, tms, tss,
                   mod16[-n:], (121, 121))]
    for th, tw, span in ((80, 78, (121, 121)), (37, 45, (50, 77)), (176, 176, (33, 17)),
                         (256, 256, (17, 33))):
        t2 = torch.from_numpy(rng.random((th, tw), dtype=np.float32)).to(dev)
        m2, s2 = template_stats(t2)
        lanes = [(7, 9, 0, span[1] - 1, 0, span[0] - 1), (103, 50, 1, span[1] - 2, 2, span[0]),
                 (1280 - tw - span[1] + 5, 720 - th - span[0] + 3, 0, span[1], 0, span[0])]
        cases += [(f"{th}x{tw} span {span}, shared u8 frame", u8[2], t2, m2, s2, lanes, span),
                  (f"{th}x{tw} span {span}, shared f32 frame", rand[2], t2, m2, s2, lanes, span)]
    err = 0.0
    tier = f"{passes}-pass" if passes else "f32"
    for label, images, tpl, tm, ts, lanes, span in cases:
        got = region_argmax_lanes(images, tpl, tm, ts, lanes, span, passes).cpu().numpy()
        want = region_argmax_lanes_reference(images, tpl, tm, ts, lanes, span,
                                             passes).cpu().numpy()
        fin = np.isfinite(want[:, 0])
        d = float(np.abs(got[fin, 0] - want[fin, 0]).max(initial=0.0))
        if not (np.array_equal(got[:, 1:], want[:, 1:])
                and np.array_equal(np.isfinite(got[:, 0]), fin) and d <= K5_ATOL):
            raise AssertionError(f"K5 {label}, {tier}: kernel {got.tolist()} vs plain "
                                 f"{want.tolist()}")
        err = max(err, d)
    print(f"K5 {tier} edge cases ({len(cases)}: x0 mod 16, 1/4/8 lanes shared and own, u8 and "
          f"f32, tw % 4 != 0, row chunks, spans not whole tiles): (x, y) equal, max |value "
          f"diff| {err:.3g} (<= {K5_ATOL})")
    return err


def check_ladder(dev, spec, frames) -> tuple:
    """Phase 22's checks of K1's rung ladder on a 64-frame chunk of the bench
    clip from its ground-truth box, global search off, at every tier: the
    CUDA `full` rung's records and template bit-equal to mega_track_chunk's;
    `full` and `argmax` against their plain versions under the contract;
    every earlier rung's checksum against its plain version's (integer rungs
    exactly, float rungs within CHECKSUM_RTOL).  Returns (the contract's
    largest difference, the checksums' largest relative difference, the
    plain `full` rung's ms a frame at float32)."""
    from pvot_torch.bench import state_at
    from pvot_torch.ops.ncc_mega import mega_track_chunk
    from pvot_torch.tools import mega_breakdown as bd

    config = bd.local_config()
    state = state_at(spec, frames, 0, dev)
    chunk = torch.from_numpy(frames[1:65]).to(dev)
    err = rel = 0.0
    plain = {}
    for tier in bd.TIERS:
        for rung in bd.RUNGS:
            got = bd.mega_breakdown_chunk(rung, chunk, state, config, tier)
            # empty .. score_box do not depend on the tier.
            key = (rung, tier if rung in ("score", "argmax", "full") else None)
            if key not in plain:
                plain[key] = bd.mega_breakdown_reference(rung, chunk, state, config, tier)
            if rung in ("argmax", "full"):
                err = max(err, compare(f"ladder {tier} {rung} rung vs plain", got, plain[key]))
            else:
                rel = max(rel, bd.checksums_agree(rung, got[0], plain[key][0]))
        full = bd.mega_breakdown_chunk("full", chunk, state, config, tier)
        k1 = mega_track_chunk(*chunk_args(chunk, state, config), **bd.tier_kw(tier))
        if not (torch.equal(full[0], k1[0]) and torch.equal(full[1], k1[1])):
            raise AssertionError(f"ladder {tier}: the full rung differs from mega_track_chunk")
        print(f"ladder {tier}: full rung bit-equal to mega_track_chunk over 64 frames; "
              f"checksums of empty .. score equal to the plain versions' (largest relative "
              f"difference so far {rel:.3g}, float rungs within {bd.CHECKSUM_RTOL})")
    plain_ms = time_ms(lambda: bd.mega_breakdown_reference("full", chunk, state, config), 1) / 64
    return err, rel, plain_ms


def check_strip_probes(dev) -> dict:
    """Phase 23's checks: each probe of pvot_torch.tools.global_strip_probe on
    its input (the border clip included) against the numpy oracle and the
    plain version.  Returns {kernel: largest |kernel - plain|}."""
    from pvot_torch.tools import global_strip_probe as gsp

    errs = {"strip_best": 0.0, "slab_refetch": 0.0}
    for name, frames in gsp.probe_inputs():
        res = gsp.run_probe(name, frames, dev)
        for kernel, e in res["max_abs_err"].items():
            errs[kernel] = max(errs[kernel], e)
        print(f"strip probe {name}: {res['got']} equal to the plain version and the oracle "
              f"(largest relative value difference {res['max_rel_err']:.3g} <= {gsp.VALUE_RTOL})")
    return errs


def run_probe_catalogue(dev, tool, k45_probes, k_launches: dict, counts, reset_counts) -> dict:
    """Phases 24-25: every probe of a catalogue (pvot_torch.tools
    .fused_argmax_probe or .pallas_probe) on the card, the launch counters
    reset just before and read just after: each probe's kernel against the
    JAX probe's own assertion and its plain version (fap.run_case), every
    probe kernel launched once a probe that uses it, and K4/K5 (`k45_probes`)
    exactly `k_launches` times.  Then each probe timed: its us a call over
    200 calls (CUDA events around the wrapper's calls: the host's time shows
    where it exceeds the kernel's), its kernels' device us a call
    (torch.profiler),
    its plain version's ms, its bound and the library call's ms
    (fap.time_case).  Returns the kernels' line entry's fields."""
    from pvot_torch.tools import fused_argmax_probe as fap

    wrappers = tuple(dict.fromkeys(fap.WRAPPERS + tool.WRAPPERS))
    cases = [(name, make()) for name, make in tool.PROBES]
    fap.reset_launches(*wrappers)
    reset_counts()
    results = {name: fap.run_case(name, case, dev) for name, case in cases}
    got = {w.__name__: w.launches for w in wrappers}
    want = {w.__name__: sum(c.kernel is w for n, c in cases if n not in k45_probes)
            for w in wrappers}
    if got != want or counts() != {**{n: 0 for n in counts()}, **k_launches}:
        raise AssertionError(f"{tool.__name__}: launches {got} and {counts()}, expected {want} "
                             f"and {k_launches}")
    launches = sum(got.values()) + sum(counts().values())
    probes = {}
    for name, case in cases:
        t = fap.time_case(case, dev)
        probes[name] = {"kernel": case.kernel.__name__, "ms": t["us"] / 1e3,
                        "device_ms": None if t["device_us"] is None else t["device_us"] / 1e3,
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "max_abs_err": results[name]["max_abs_err"],
                        "probe_err": results[name]["err"]}
        lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.3f} us"
        dev_us = "not measured" if t["device_us"] is None else f"{t['device_us']:.3f} us"
        print(f"{tool.__name__.rsplit('.', 1)[1]} {name} ({case.kernel.__name__}): probe error "
              f"{results[name]['err']:.3g}, max |kernel - plain| "
              f"{results[name]['max_abs_err']:.3g}; {t['us']:.3f} us a call (its kernels "
              f"on the device {dev_us}), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.5f} us ({t['bound_by']}), "
              f"library {lib}")
    by_ops = sum(p["bound_ms"] for p in probes.values() if p["bound_by"] == "operations")
    bound = sum(p["bound_ms"] for p in probes.values())
    return {"launches": launches, "kernel_launches": got, "k45_launches": k_launches,
            "max_abs_err": max(p["max_abs_err"] for p in probes.values()),
            "ms": sum(p["ms"] for p in probes.values()),
            "plain_ms": sum(p["plain_ms"] for p in probes.values()), "bound_ms": bound,
            "bound_by": "operations" if by_ops >= bound - by_ops else "bytes",
            "library_ms": None, "probes": probes}


# The product probes of T4 and T5 (csrc/argmax_probe.cu's two P3 kernels).
PRODUCT_PROBES = ("dot_high_emul", "dot_rhs_lane", "matmul", "big_matmul", "dot_highest",
                  "dot_high", "scratch_copy_dot", "unrolled_dots", "selector_dot")


def product_sweep(dev) -> dict:
    """Phases 24-25's product sweep: every product probe of T4 and T5 and
    every edge shape (fused_argmax_probe.GEMM_EDGES) on the card, the gemm
    counter reset just before: each held to its own check and to its plain
    version (float32 within 1e-6, bf16 passes 1e-5 of the plain version's
    largest value), one launch a call, two calls bit-equal;
    `product_timings` times them after phase 28."""
    from pvot_torch.tools import fused_argmax_probe as fap
    from pvot_torch.tools import pallas_probe as pp

    out = {}
    for name, make in [*((n, m) for n, m in fap.PROBES + pp.PROBES if n in PRODUCT_PROBES),
                       *fap.GEMM_EDGE_PROBES]:
        case = make()
        args = case.args(dev)
        fap.reset_launches(fap.gemm)
        res = fap.run_case(name, case, dev)
        one, two = case.call(*args), case.call(*args)
        torch.cuda.synchronize()
        if fap.gemm.launches != 3 or not torch.equal(one, two):
            raise AssertionError(f"product {name}: {fap.gemm.launches} launches for 3 calls, "
                                 f"two calls bit-equal: {torch.equal(one, two)}")
        m, k, n = fap.gemm_shape(*case.product(*args))
        passes = case.passes
        plan = fap.gemm_plan(m, n, k, passes,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
        out[name] = {"shape": [m, k, n], "passes": passes, "splits": plan.splits,
                     "blocks": plan.blocks, "probe_err": res["err"],
                     "max_abs_err": res["max_abs_err"]}
        print(f"product {name} {out[name]['shape']} (m, k, n) at {passes} passes: {plan.splits} "
              f"splits, {plan.blocks} blocks; probe error {res['err']:.3g}, max |kernel - plain| "
              f"{res['max_abs_err']:.3g}; one launch a call, two calls bit-equal", flush=True)
    return out


def product_timings(dev, smi: str, parent_lib: str = None) -> dict:
    """After phase 28, with the other graph-route timings: each product
    probe's device us a launch by the graph route (`graph_ms` over its C
    entry) beside the library call's (fused_argmax_probe.library_device_us,
    the same route);
    with `parent_lib` (the parent tree's kernel library), the parent's
    pvot_probe_gemm and this tree's on the same operands in turns (parent,
    change, change, parent); raises AssertionError, after every product is
    timed, where the change is more than 10 % slower than the parent in
    either pair."""
    import ctypes

    from pvot_torch.ops import _build
    from pvot_torch.tools import fused_argmax_probe as fap
    from pvot_torch.tools import pallas_probe as pp

    lib = _build.load_library()
    if parent_lib:
        # The parent's pvot_probe_gemm: a, lda, b, b_lo, b_kind, ldb, c, m, n, k, passes,
        # stream (no plan, no workspace).
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int  # noqa: E741
        parent = ctypes.CDLL(parent_lib).pvot_probe_gemm
        parent.argtypes, parent.restype = [P, L, P, P, I, I, P, I, I, I, I, P], I
    out = {}
    for name, make in ((n, m) for n, m in fap.PROBES + pp.PROBES if n in PRODUCT_PROBES):
        case = make()
        args = case.args(dev)  # kept alive with the output: xs points into both
        keep, xs = fap.gemm_c_args(*case.product(*args))
        change = lambda s: _build.check(lib.pvot_probe_gemm(*xs, s), name)  # noqa: E731
        t = out[name] = {"graph_us": graph_ms(change) * 1e3,
                         "library_graph_us": fap.library_device_us(case, dev)}
        line = (f"product {name}: graph route {t['graph_us']:.3f} us a launch, torch.matmul "
                f"{t['library_graph_us']:.3f} us")
        if parent_lib:
            before = lambda s: _build.check(parent(*xs[:11], s), name)  # noqa: E731
            turns = t["in_turns_us"] = [graph_ms(f) * 1e3 for f in (before, change, change, before)]
            p1, c1, c2, p2 = turns
            t["within_10pct"] = c1 <= 1.1 * p1 and c2 <= 1.1 * p2
            line += (f"; in turns (parent, change, change, parent) "
                     f"{' / '.join(f'{v:.3f}' for v in turns)}, at most 10 % slower in both "
                     f"pairs: {t['within_10pct']}")
        print(f"{line} on {smi}", flush=True)
    slower = [name for name, t in out.items() if t.get("within_10pct") is False]
    if slower:
        raise AssertionError(f"products more than 10 % slower than the parent's: {slower}")
    return out


def parent_library(root: str) -> str:
    """The parent tree's kernel library, built by its own _build in its
    own checkout at `root`."""
    import subprocess

    return subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from pvot_torch.ops import _build; print(_build.build())", root],
        cwd=root, capture_output=True, text=True, check=True).stdout.split()[-1]


def check_full_map_on_card(dev, frames_u8, rows, state) -> None:
    """Phase 26 (ROADMAP C, open check 1): the `xla` engine's full map
    (ops/ncc_matmul.py make_full_fn, its products under full_f32 on the
    card) of a global frame on the card and on the CPU, under the tracker's
    contract: the same argmax, the peak within 1e-5, the whole map within
    2e-3.  frames_u8 (F, H, W) numpy, rows the chunk's records (the first
    global frame is checked), state the chunk's start state."""
    from pvot_torch.ops.ncc_matmul import make_full_fn
    from pvot_torch.ops.search import best_rows

    t = int(np.nonzero(rows[:, 9] != 0)[0][0])
    full_fn = make_full_fn()
    maps = {}
    for where in (dev, torch.device("cpu")):
        maps[where.type] = full_fn(torch.from_numpy(frames_u8[t]).to(where),
                                   state.template.to(where), state.t_mean.to(where),
                                   state.t_std.to(where)).cpu()
    card, host = maps["cuda"], maps["cpu"]
    b_card, b_host = best_rows(card).numpy(), best_rows(host).numpy()
    diff = (card - host).abs()
    worst = int(torch.argmax(diff))
    wy, wx = divmod(worst, card.shape[1])
    out = {"frame": t, "peak_diff": float(abs(b_card[0] - b_host[0])),
           "max_abs_diff": float(diff.max()), "worst_card": float(card[wy, wx]),
           "worst_cpu": float(host[wy, wx])}
    print(f"open check 1: xla full map of global frame {t} ({tuple(card.shape)}), card against "
          f"CPU: argmax (x, y) {b_card[1:].tolist()} vs {b_host[1:].tolist()}, peak "
          f"{b_card[0]:.8f} vs {b_host[0]:.8f} (diff {out['peak_diff']:.3g} <= 1e-5), whole map "
          f"max diff {out['max_abs_diff']:.3g} (<= 2e-3) at (y, x) ({wy}, {wx}): "
          f"{out['worst_card']:.8f} vs {out['worst_cpu']:.8f}")
    if not (np.array_equal(b_card[1:], b_host[1:]) and out["peak_diff"] <= 1e-5
            and out["max_abs_diff"] <= 2e-3):
        raise AssertionError(f"open check 1: the card's xla full map differs from the CPU's: {out}")


def profiled(fn, kernel: str):
    """fn() under torch.profiler: (device ms per launch of the CUDA kernels
    whose name holds `kernel`, or 0.0 if the profiler saw none; {kernel name:
    (launches, device ms)} of every CUDA kernel; wall ms, profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if str(e.device_type).endswith("CUDA") and us > 0:
            by_kernel[e.key] = (e.count, us / 1e3)
    hits = [v for k, v in by_kernel.items() if kernel in k]
    n = sum(c for c, _ in hits)
    return (sum(ms for _, ms in hits) / n if n else 0.0), by_kernel, wall


def sharded_rank(rank: int, world: int, mesh_shape, backend: str) -> dict:
    """Phase 34 (c) on one rank of a gloo world on cuda:0: phase 11's
    re-acquisition clip (as many copies as the mesh has data ranks) through
    track_video_sharded, the K4 and K5 counters reset just before and read
    just after.  The first K4 call at each shape the path gives it (this
    rank's slabs and strips) is kept, and after the counters are read K4 is
    held on those inputs to its plain version, on the card as in phase 8
    (on the CPU its 80x80 correlations in float64 take tens of GiB)."""
    from pvot_torch.bench import state_at
    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video
    from pvot_torch.ops import _build
    from pvot_torch.ops.ncc_mega import reset_launches
    from pvot_torch.ops.ncc_pallas import (
        ncc_map_lanes, ncc_map_lanes_reference, ncc_map_pallas, ncc_region_argmax_pallas,
    )
    from pvot_torch.parallel import sharded
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.parallel.sharded import make_mesh, track_video_sharded

    calls = {}  # (rows, cols) -> the first K4 call's inputs at that shape

    def keep_call(images, templates, t_mean, t_std, origins, out_shape):
        calls.setdefault(tuple(out_shape), (images.clone(), templates.clone(), t_mean.clone(),
                                            t_std.clone(), list(origins)))
        return ncc_map_lanes(images, templates, t_mean, t_std, origins, out_shape)

    sharded.ncc_map_lanes = keep_call

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load_library()  # built by the parent process: this loads it
    gspec = SyntheticSpec(width=1280, height=720, num_frames=49, target_w=80, target_h=80,
                          seed=2, exit_and_reenter=True)
    gframes = generate_gray_video(gspec)
    data = mesh_shape[0]
    mesh = make_mesh(mesh_shape)
    states = stack_states([state_at(gspec, gframes, 0, dev)] * data, dev)
    reset_launches(ncc_map_pallas, ncc_region_argmax_pallas)
    _, out = track_video_sharded(np.stack([gframes[1:]] * data), states, mesh,
                                 TrackerConfig(lost_frame_threshold=5), chunk_size=16,
                                 backend=backend, device=dev)
    got = {"out": out._asdict(), "K4": ncc_map_pallas.launches,
           "K5": ncc_region_argmax_pallas.launches, "k4_err": {}}
    for shape, (images, *args, origins) in calls.items():
        card = ncc_map_lanes(images, *args, origins, shape)
        plain = ncc_map_lanes_reference(images, *args, origins, shape)
        got["k4_err"][f"{len(origins)}x{shape[0]}x{shape[1]}"] = float(
            (card - plain).abs().max())
    return got


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of pvot_torch on one NVIDIA GPU.")
    ap.add_argument("--parent", default=None,
                    help="root of a checkout of the parent tree: phase 29 times it against "
                         "this one in turns")
    opts = ap.parse_args(argv)
    # Phase 1.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pvot_torch.bench import (
        bench_clip, bound_ms, gpu_identity, max_l1_err_px, run_bench, scored_positions,
        scored_windows, state_at, stream_cuts, stream_err_px, stream_states, union_pixels,
    )

    smi = gpu_identity()[0]
    print(f"gpu: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from pvot_torch.runtime import native

    native_build = native.build_info()
    print(f"native host library: {json.dumps(native_build)}")
    if not native_build["built"]:
        raise AssertionError("the native host library (libpvot) did not build or load")
    # Serving's feeds take libpvot's frame ring whenever the library loaded.
    host_path = f"frame ring native (libpvot, {native_build['openmp']})"

    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.gray import gray_u8_to_f32
    from pvot_torch.io.serving import serve_objects, serve_streams
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot_torch.ops import _build
    from pvot_torch.ops.ncc_mega import (
        PLANS, MegaGeometry, chunk_launches, mega_track_chunk, mega_track_chunk_multi,
        mega_track_chunk_multi_reference, mega_track_chunk_objects,
        mega_track_chunk_objects_reference, mega_track_chunk_reference, reset_launches,
    )
    from pvot_torch.parallel.multi import (
        init_multi_state, init_multi_state_bucketed, stack_states, unstack_state,
    )
    from pvot_torch.tracker.mega import track_objects_mega, track_video_mega
    from pvot_torch.tracker.state import StepOutput, init_state

    from pvot_torch.cli.main import main as cli_main
    from pvot_torch.io.pipeline import track_stream
    from pvot_torch.ops import search as search_ops
    from pvot_torch.ops.ncc_pallas import (
        ncc_map_lanes, ncc_map_lanes_reference, ncc_map_pallas, ncc_region_argmax_pallas,
        region_argmax_lanes, region_argmax_lanes_reference,
    )
    from pvot_torch.ops.ncc_reference import template_stats
    from pvot_torch.parallel.multi import (
        make_multi_stream_step, make_stream_masked_scan_fn, track_video_multi,
    )
    from pvot_torch.tracker.scan import track_video, track_video_batched
    from pvot_torch.tracker.step import host_read, make_step

    kernels = (mega_track_chunk, mega_track_chunk_multi, mega_track_chunk_objects,
               ncc_map_pallas, ncc_region_argmax_pallas)
    names = ("K1", "K2", "K3", "K4", "K5")

    def counts() -> dict:
        return {n: k.launches for n, k in zip(names, kernels)}

    def expect_counts(what: str, **want) -> None:
        """Every kernel's launches since the last reset_counts(): those named,
        the others none."""
        got = counts()
        if got != {n: want.get(n, 0) for n in names}:
            raise AssertionError(f"{what}: launches {got}, expected {want} and no others")

    def reset_counts():
        reset_launches(*kernels)

    def chunk_bound(lanes, n_steps, passes=0, shared_frame=False, extra_bytes=0):
        """(ms per step, what bounds it) of the least time for lanes [(start
        bbox, host rows (F, 10), n_valid, frame shape, template shape,
        config)], the correlation at the tier `passes` (0: float32).  Bytes:
        each scored frame's window (the whole u8 frame on a global step) read
        once, the union of the lanes' windows where they share one frame (K3),
        the template read and written, the records written, and
        `extra_bytes`."""
        fma = n_bytes = 0
        windows = []
        for start, rows, nv, fshape, tshape, cfg in lanes:
            th, tw = tshape
            windows.append(scored_windows(start, rows[:nv, :4], rows[:nv, 9] != 0, fshape,
                                          tshape, cfg))
            fma += th * tw * sum((ww - tw + 1) * (wh - th + 1) for _, _, ww, wh in windows[-1])
            n_bytes += 2 * 4 * th * tw + 40 * len(rows)
        if shared_frame:
            n_bytes += sum(union_pixels([lane[t] for lane in windows if t < len(lane)])
                           for t in range(max(len(lane) for lane in windows)))
        else:
            n_bytes += sum(ww * wh for lane in windows for _, _, ww, wh in lane)
        least, by = bound_ms(fma, n_bytes + extra_bytes, passes)
        return least / n_steps, by

    def windows_of(clip, start, rows, th, tw, radius):
        """Each frame's input to its local window, (F, 1, th + 2r, tw + 2r),
        from the box it starts from (clamped into the frame)."""
        h, w = clip.shape[1:]
        boxes = np.concatenate([np.asarray(start)[None], rows[:-1, :4]]).astype(int)
        out = []
        for t, (x, y, bw, bh) in enumerate(boxes.tolist()):
            y0 = min(max(0, y + bh // 2 - th // 2 - radius), h - th - 2 * radius)
            x0 = min(max(0, x + bw // 2 - tw // 2 - radius), w - tw - 2 * radius)
            out.append(clip[t, y0 : y0 + th + 2 * radius, x0 : x0 + tw + 2 * radius])
        return torch.stack(out).float()[:, None] / 255.0

    def conv2d_corr_ms(windows, templates, repeats=5, dtype=torch.float32):
        """F.conv2d on the correlation term alone over windows (N, K, h, w)
        against K templates (K, th, tw), per row of windows, in `dtype`
        (bfloat16: the 1-pass term alone): the nearest PyTorch call, a
        yardstick that the port never calls."""
        import torch.nn.functional as tnf

        weight = templates[:, None].to(dtype).contiguous()
        windows = windows.to(dtype)
        return time_ms(lambda: tnf.conv2d(windows, weight, groups=len(weight)),
                       repeats) / len(windows)

    # Phase 2.
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {_build.build_info['path']} loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_info['seconds']:.1f} s)")
    print("  compile seconds by source (in parallel): " + ", ".join(
        f"{unit} {sec:.1f}" for unit, sec in _build.build_info["units"].items()))
    entries = ptxas_entries(_build.build_info["log"])
    for unit in ("ncc_mega.cu", "ncc_pallas.cu"):  # the production kernels, beside PR 5's
        for label, figures in entries.get(unit, {}).items():
            parent = PARENT_PTXAS.get(parent_label(label))
            verdict = ("not recorded" if parent is None else
                       "the same" if parent == figures else f"DIFFERENT: {parent}")
            print(f"  ptxas {unit} {label}: {figures[0]} registers, spill stores/loads "
                  f"{figures[1]}/{figures[2]} bytes; parent: {verdict}")
    for unit in ("mega_breakdown.cu", "strip_probe.cu", "argmax_probe.cu", "pallas_probe.cu"):
        print(f"  ptxas {unit} (registers, spill stores/loads): " + "; ".join(
            f"{label} {r} {st}/{ld}" for label, (r, st, ld) in entries.get(unit, {}).items()))
    for th, lanes in ((80, 1), (80, 8), (160, 1), (256, 1)):
        blocks = tuple(lib.pvot_mega_score_blocks_per_sm(th, th, lanes, 0, p) for p in (0, 1, 3))
        parent = PARENT_BLOCKS_PER_SM.get((th, lanes))
        print(f"  score blocks per SM, {th}x{th} template, {lanes} lane(s), float32 / 1 / 3 "
              f"passes: {' / '.join(map(str, blocks))}; parent: "
              + ("not recorded" if parent is None else "the same" if parent == blocks
                 else f"DIFFERENT: {parent}"))
    print("  K4/K5 template rows staged at once: "
          + ", ".join(f"{t}x{t}: {lib.pvot_ncc_chunk_rows(t, t)}" for t in (80, 160, 256)))
    # ... and the K4/K5 wrapper's copy of their launch plan (tile height,
    # chunk rows, shared memory) mirrors the kernel's.
    import ctypes

    from pvot_torch.ops.ncc_pallas import ncc_plan

    for th, tw in ((80, 80), (160, 160), (176, 176), (256, 256), (9, 11), (37, 45), (80, 256)):
        for argmax in (0, 1):
            for passes in (0, 3):
                smem = ctypes.c_int(0)
                tile_h = lib.pvot_ncc_plan(th, tw, argmax, passes, ctypes.byref(smem))
                plan = ncc_plan(th, tw, bool(argmax), passes)
                if (tile_h, smem.value, lib.pvot_ncc_chunk_rows(th, tw)) != (
                        plan.tile_h, plan.smem_bytes, plan.chunk_rows):
                    raise AssertionError(f"ncc_plan({th}, {tw}, {argmax}, {passes}): kernel "
                                         f"{tile_h}, {smem.value}; wrapper {plan}")
    # The wrapper's envelope check mirrors the kernel's shared-memory plan.
    for th, tw, lanes in ((80, 80, 1), (80, 80, 8), (143, 143, 1), (143, 143, 256),
                          (160, 160, 1), (176, 176, 3), (256, 256, 1), (256, 256, 64)):
        mirror = MegaGeometry((1080, 1920), (th, tw), TrackerConfig()).stage_rows(lanes)
        if lib.pvot_mega_stage_rows(th, tw, lanes) != mirror:
            raise AssertionError(f"stage_rows({th}, {tw}, {lanes}): kernel "
                                 f"{lib.pvot_mega_stage_rows(th, tw, lanes)}, wrapper {mirror}")
    # ... and its plan (whole, resident or chunked, with the bytes) the
    # kernel's plan_of, at float32 and at a bf16 tier.
    plans = []
    for th, tw, lanes in ((80, 80, 1), (80, 80, 8), (143, 143, 256), (160, 160, 1), (160, 160, 8),
                          (161, 160, 4), (176, 176, 3), (176, 256, 1), (176, 256, 200),
                          (256, 256, 1), (256, 256, 64)):
        for passes in (0, 1):
            smem = ctypes.c_int(0)
            kplan = lib.pvot_mega_plan(th, tw, lanes, passes, ctypes.byref(smem))
            mirror = MegaGeometry((1080, 1920), (th, tw), TrackerConfig()).plan(lanes, passes)
            if (PLANS[kplan], smem.value) != (mirror.name, mirror.smem_bytes):
                raise AssertionError(f"plan({th}, {tw}, {lanes}, {passes}): kernel "
                                     f"{kplan} {smem.value}, wrapper {mirror}")
            if passes == 0:
                plans.append(f"{th}x{tw} at {lanes}: {mirror.name} {mirror.smem_bytes}")
    print("  chunk kernel plans, float32, bytes (kernel = wrapper; bf16 tiers too): "
          + "; ".join(plans))

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
    k1_plain = mega_track_chunk_reference(*args)
    k1_err = compare("K1 parity 720p tracked chunk", mega_track_chunk(*args), k1_plain)
    n = chunk.shape[0]
    ms = time_ms(lambda: mega_track_chunk(*args), 10) / n
    plain_ms = time_ms(lambda: mega_track_chunk_reference(*args), 1) / n
    k1_rows = mega_track_chunk(*args)[0].cpu().numpy()
    k1_start = args[1].tolist()
    k1_bound, k1_by = chunk_bound([(k1_start, k1_rows, n, frames.shape[1:], (80, 80),
                                    config)], n)
    k1_conv = conv2d_corr_ms(windows_of(chunk, k1_start, k1_rows, 80, 80, 60), args[2][None])
    print(f"K1 local frames (720p/80/r60), ms per frame: kernel {ms:.5f}, plain {plain_ms:.5f}, "
          f"bound {k1_bound:.5f} ({k1_by}); F.conv2d on the correlation term alone {k1_conv:.5f}")

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
    # Global frames timed over a chunk held in global search (a noise
    # template matches nothing), so the host's enqueue hides behind the card.
    noise160 = np.random.default_rng(8).random((160, 160), dtype=np.float32)

    def held_global(frames_u8, templ, cfg):
        held = init_state(noise160[:templ, :templ], (600, 300, templ, templ))._replace(
            use_global=torch.tensor(True, device=dev))
        hargs = chunk_args(frames_u8, held, cfg)
        hrows = mega_track_chunk(*hargs)[0].cpu().numpy()
        if not (hrows[:, 9] != 0).all():
            raise AssertionError(f"a {templ}x{templ} held template left global search")
        return hargs, hrows

    gh = 16
    hargs, hrows = held_global(chunk[:gh], 80, config)
    g_ms = time_ms(lambda: mega_track_chunk(*hargs), 3) / gh
    g_plain_ms = time_ms(lambda: mega_track_chunk_reference(*hargs), 1) / gh
    g_bound = chunk_bound([(hargs[1].tolist(), hrows, gh, frames.shape[1:], (80, 80), config)],
                          gh)[0]
    print(f"K1 global frames (720p/80, 641x1201 positions), ms per frame over {gh}: kernel "
          f"{g_ms:.4f}, plain {g_plain_ms:.4f}, bound {g_bound:.4f}")

    # The repaired envelope: 1080p / 160 x 160 / r160 (the JAX suite's
    # 1080p_t160_r160 geometry) with global frames, and a 256 x 256 template.
    bspec = SyntheticSpec(width=1920, height=1080, num_frames=7, target_w=160,
                          target_h=160, seed=3, exit_and_reenter=True)
    bframes = generate_gray_video(bspec)
    bconfig = TrackerConfig(search_radius_x=160, search_radius_y=160, lost_frame_threshold=2)
    bstate = state_at(bspec, bframes, 0, dev)
    bargs = chunk_args(torch.from_numpy(bframes[1:]).to(dev), bstate, bconfig)
    resident_before = mega_track_chunk.launches_by_plan["resident"]
    got = mega_track_chunk(*bargs)
    if mega_track_chunk.launches_by_plan["resident"] != resident_before + 1:
        raise AssertionError("K1 at 1080p/160/r160 did not launch the resident plan")
    k1_err = max(k1_err, compare("K1 parity 1080p/160/r160 (resident plan)", got,
                                 mega_track_chunk_reference(*bargs), 160 * 160))
    bglob = chunk_args(bargs[0][:2], bstate._replace(use_global=torch.tensor(True, device=dev)),
                       bconfig)
    got = mega_track_chunk(*bglob)
    if not bool((got[0][:, 9] != 0).any()):
        raise AssertionError("1080p/160 check ran no global frame")
    k1_err = max(k1_err, compare("K1 parity 1080p/160 global frames", got,
                                 mega_track_chunk_reference(*bglob), 160 * 160))
    # The template's own frame six times over: every frame local, on the target.
    b_local = chunk_args(torch.from_numpy(bframes[:1]).to(dev).expand(6, -1, -1).contiguous(),
                         bstate, bconfig)
    b_rows = mega_track_chunk(*b_local)[0].cpu().numpy()
    if (b_rows[:, 9] != 0).any():
        raise AssertionError("1080p/160 local timing chunk left local tracking")
    b_ms = time_ms(lambda: mega_track_chunk(*b_local), 5) / 6
    b_bound = chunk_bound([(b_local[1].tolist(), b_rows, 6, bframes.shape[1:], (160, 160),
                            bconfig)], 6)[0]
    b_global, bg_rows = held_global(b_local[0][:4], 160, bconfig)
    bg_ms = time_ms(lambda: mega_track_chunk(*b_global), 3) / 4
    bg_bound = chunk_bound([(b_global[1].tolist(), bg_rows, 4, bframes.shape[1:], (160, 160),
                             bconfig)], 4)[0]
    print(f"K1 1080p/160/r160, ms per frame: local {b_ms:.4f} (bound {b_bound:.4f}), global "
          f"{bg_ms:.4f} (bound {bg_bound:.4f})")
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
    if mega_track_chunk_multi.launches - before != chunk_launches(f4):
        raise AssertionError("K2 did not launch once for the chunk")
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
    k2_rows = got[0].cpu().numpy()
    k2_bound, k2_by = chunk_bound(
        [(st4[0][s_].tolist(), k2_rows[s_], int(nv4[s_]), frames.shape[1:], (80, 80), gconfig)
         for s_ in range(4)], f4)
    print(f"K2 S=4 (one stream global on {n_global} of {f4} steps), ms per frame step over "
          f"the same {f4} steps: kernel {k2_ms:.5f}, plain {k2_plain_ms:.5f}, "
          f"bound {k2_bound:.5f} ({k2_by})")
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
    chunked_before = (mega_track_chunk.launches_by_plan["chunked"],
                      mega_track_chunk_multi.launches_by_plan["chunked"])
    k1 = mega_track_chunk(*cargs)
    many = [v.expand(200, *v.shape).contiguous() for v in cargs[1:7]]
    got = mega_track_chunk_multi(cargs[0].expand(200, *cargs[0].shape), *many, [3] * 200,
                                 cconfig)
    if not (torch.equal(got[0], k1[0].expand_as(got[0]))
            and torch.equal(got[1], k1[1].expand_as(got[1]))):
        raise AssertionError("K2 with 176x256 in chunks of a quarter differs from K1 in halves")
    # Neither fits the resident plan (tests/test_torch_multi.py's bytes).
    if (mega_track_chunk.launches_by_plan["chunked"],
            mega_track_chunk_multi.launches_by_plan["chunked"]) != tuple(
                c + 1 for c in chunked_before):
        raise AssertionError("the 176x256 launches did not run the chunked plan")
    print(f"K2 176x256, 200 streams staged in chunks of {cgeom.stage_rows(200)} rows: "
          f"bit-equal to K1 staged in halves ({int(k1[0][:, 5].sum())} of 3 frames accepted)")

    # Phase 5: K3.  Two static patches stamped into a copy of the clip's
    # first frames; the fourth object's template is cut from a third patch
    # and it starts outside the frame.
    of = 48
    oclip = frames[: of + 1].copy()
    prng = np.random.default_rng(7)
    for px, py in ((200, 100), (900, 500), (600, 80)):
        oclip[:, py : py + 80, px : px + 80] = prng.integers(0, 256, (80, 80), np.uint8)
    g0 = gray_u8_to_f32(oclip[0])
    tx, ty = target_bbox(spec, 0)[:2]
    cut_at = [(tx, ty), (200, 100), (900, 500), (600, 80)]
    start_at = [(tx, ty), (200, 100), (900, 500), (-300, 300)]
    ochunk = torch.from_numpy(oclip[1:]).to(dev)
    k3_err = 0.0
    k4_ms, k4_plain_ms, k4_bound = {}, {}, {}
    for label, extents in (("uniform", [(80, 80)] * 4),
                           ("bucketed", [(80, 80), (64, 48), (48, 64), (32, 32)])):
        templates = [g0[y : y + eh, x : x + ew] for (x, y), (eh, ew) in zip(cut_at, extents)]
        rois = [(x, y, ew, eh) for (x, y), (eh, ew) in zip(start_at, extents)]
        init = init_multi_state if label == "uniform" else init_multi_state_bucketed
        ost = init(templates, rois)  # no device given: the current CUDA device
        if not all(v.is_cuda for v in ost):
            raise AssertionError("states built with no device argument are not on the card")
        bucket = None if label == "uniform" else extents
        oargs = (ochunk, torch.stack(list(ost.bbox), dim=-1), ost.template, ost.t_mean, ost.t_std,
                 ost.lost_count, ost.use_global, of, config)
        before = mega_track_chunk_objects.launches
        got = mega_track_chunk_objects(*oargs, bucket_extents=bucket)
        if mega_track_chunk_objects.launches - before != chunk_launches(of):
            raise AssertionError(f"K3 {label} did not launch once for the chunk")
        if not bool((got[0][3, :, 9] != 0).any()):
            raise AssertionError(f"K3 {label}: the object started outside ran no global frame")
        k3_err = max(k3_err, compare(
            f"K3 parity {label} K=4 (target, two patches, one from outside)", got,
            mega_track_chunk_objects_reference(*oargs, bucket_extents=bucket)))
        for i, (eh, ew) in enumerate(extents):
            one = [a[i] for a in oargs[1:7]]
            one[1] = one[1][:eh, :ew].contiguous()
            k1 = mega_track_chunk(ochunk, *one, of, config)
            if not (torch.equal(k1[0], got[0][i]) and torch.equal(k1[1], got[1][i, :eh, :ew])
                    and not got[1][i, eh:].any() and not got[1][i, :, ew:].any()):
                raise AssertionError(f"K3 {label} object {i} differs from K1 on it alone")
        print(f"K3 {label} ({extents}): each object's records and template bit-equal to K1 on "
              f"that object alone at its true extent; one launch")
        # Both K = 4 sets timed over the same 48 steps, kernel and plain,
        # beside their bounds (each object's FMA at its own extent).
        rows4 = got[0].cpu().numpy()
        k4_ms[label] = time_ms(lambda: mega_track_chunk_objects(*oargs, bucket_extents=bucket),
                               5) / of
        k4_plain_ms[label] = time_ms(lambda: mega_track_chunk_objects_reference(
            *oargs, bucket_extents=bucket), 1) / of
        k4_bound[label] = chunk_bound(
            [(oargs[1][i].tolist(), rows4[i], of, frames.shape[1:], extents[i], config)
             for i in range(4)], of, shared_frame=True)[0]
        print(f"K3 {label} K=4 (one object global on {int(rows4[3, :, 9].sum())} of {of} "
              f"steps), ms per step over the same {of} steps: kernel {k4_ms[label]:.5f}, plain "
              f"{k4_plain_ms[label]:.5f}, bound {k4_bound[label]:.5f}")

    # A bucket too large to stage whole beside its tile: every lane, the
    # small ones too (shorter than one chunk), sums its own halves in row
    # chunks sized for the bucket, and must still be K1 on that object alone.
    xspec = SyntheticSpec(width=1920, height=1080, num_frames=9, target_w=176, target_h=176,
                          seed=5)
    xclip = generate_gray_video(xspec)
    for px, py, (eh, ew) in ((300, 200, (64, 48)), (1500, 800, (32, 32))):
        xclip[:, py : py + eh, px : px + ew] = prng.integers(0, 256, (eh, ew), np.uint8)
    xg0 = gray_u8_to_f32(xclip[0])
    xx, xy = target_bbox(xspec, 0)[:2]
    xext = [(176, 176), (64, 48), (32, 32)]
    if not MegaGeometry(xclip.shape[1:], (176, 176), config).stage_rows(3) < 176:
        raise AssertionError("the 176x176 bucket at 3 lanes does not stage in chunks")
    xst = init_multi_state_bucketed(
        [xg0[y : y + eh, x : x + ew] for (x, y), (eh, ew) in zip(
            [(xx, xy), (300, 200), (1500, 800)], xext)],
        [(x, y, ew, eh) for (x, y), (eh, ew) in zip([(xx, xy), (300, 200), (-200, 500)], xext)])
    xf = xclip.shape[0] - 1
    xchunk = torch.from_numpy(xclip[1:]).to(dev)
    xargs = (xchunk, torch.stack(list(xst.bbox), dim=-1), xst.template, xst.t_mean, xst.t_std,
             xst.lost_count, xst.use_global, xf, config)
    got = mega_track_chunk_objects(*xargs, bucket_extents=xext)
    if not bool((got[0][2, :, 9] != 0).any()):
        raise AssertionError("K3 176x176 bucket: the object started outside ran no global frame")
    k3_err = max(k3_err, compare(
        "K3 parity 1080p bucket 176x176 (176x176, 64x48, 32x32 from outside)", got,
        mega_track_chunk_objects_reference(*xargs, bucket_extents=xext), 176 * 176))
    for i, (eh, ew) in enumerate(xext):
        one = [a[i] for a in xargs[1:7]]
        one[1] = one[1][:eh, :ew].contiguous()
        k1 = mega_track_chunk(xchunk, *one, xf, config)
        if not (torch.equal(k1[0], got[0][i]) and torch.equal(k1[1], got[1][i, :eh, :ew])
                and not got[1][i, eh:].any() and not got[1][i, :, ew:].any()):
            raise AssertionError(f"K3 176x176 bucket: object {i} differs from K1 on it alone")
    xrows = got[0].cpu().numpy()
    k3_x_ms = time_ms(lambda: mega_track_chunk_objects(*xargs, bucket_extents=xext), 5) / xf
    k3_x_bound = chunk_bound([(xargs[1][i].tolist(), xrows[i], xf, xclip.shape[1:], xext[i],
                               config) for i in range(3)], xf, shared_frame=True)[0]
    print(f"K3 1080p bucket 176x176 staged in chunks of "
          f"{MegaGeometry(xclip.shape[1:], (176, 176), config).stage_rows(3)} rows: each object "
          f"bit-equal to K1 alone at its true extent; ms per step over {xf} steps (one object "
          f"global on {int(xrows[2, :, 9].sum())}): kernel {k3_x_ms:.5f}, bound {k3_x_bound:.5f}")
    # The objects cell's shape (1080p, 160x160, r160, all local) in the
    # resident plan: K = 8 objects, and a bucket of odd extents that still
    # runs it (161x157 sets the bucket; 157, 64, 27, 31 and 35 columns leave
    # 0, 1, 2, 3 and 4 groups of 4 taps past the micro-tile loop's groups of
    # 5):
    # each object bit-equal to K1 alone, the contract against the plain
    # version, every launch resident; then serve_objects at the cell's
    # chunk of 16, every launch resident.
    rconfig = TrackerConfig(search_radius_x=160, search_radius_y=160)
    rrng = np.random.default_rng(17)
    rbase = rrng.integers(0, 256, (1080 + 16, 1920 + 16), np.uint8)
    rclip = np.stack([rbase[f : f + 1080, f : f + 1920] for f in range(13)])
    rg0 = gray_u8_to_f32(rclip[0])
    rspots = [(200 + 420 * (i % 4), 150 + 560 * (i // 4)) for i in range(8)]
    rchunk = torch.from_numpy(rclip[1:]).to(dev)
    rf = rchunk.shape[0]
    k3_cell_ms = k3_cell_bound = None
    for label, rext in (("K=8 160x160", [(160, 160)] * 8),
                        ("bucket 161x157 (161x157, 100x64, 33x27, 45x31, 50x35)",
                         [(161, 157), (100, 64), (33, 27), (45, 31), (50, 35)])):
        bucketed = len(set(rext)) > 1
        rrois = [(x, y, w, h) for (x, y), (h, w) in zip(rspots, rext)]
        rst = (init_multi_state_bucketed if bucketed else init_multi_state)(
            [rg0[y : y + h, x : x + w] for x, y, w, h in rrois], rrois, device=dev)
        rargs = (rchunk, torch.stack(list(rst.bbox), dim=-1), rst.template, rst.t_mean,
                 rst.t_std, rst.lost_count, rst.use_global, rf, rconfig)
        bucket = rext if bucketed else None
        before = dict(mega_track_chunk_objects.launches_by_plan)
        got = mega_track_chunk_objects(*rargs, bucket_extents=bucket)
        if mega_track_chunk_objects.launches_by_plan != {**before,
                                                         "resident": before["resident"] + 1}:
            raise AssertionError(f"K3 {label}: the launch was not the resident plan")
        want = mega_track_chunk_objects_reference(*rargs, bucket_extents=bucket)
        k3_err = max(k3_err, compare(f"K3 parity 1080p/r160 {label}, resident plan", got, want,
                                     max(h * w for h, w in rext)))
        for i, (eh, ew) in enumerate(rext):
            one = [a[i] for a in rargs[1:7]]
            one[1] = one[1][:eh, :ew].contiguous()
            k1 = mega_track_chunk(rchunk, *one, rf, rconfig)
            if not (torch.equal(k1[0], got[0][i]) and torch.equal(k1[1], got[1][i, :eh, :ew])):
                raise AssertionError(f"K3 {label}: object {i} differs from K1 on it alone")
        if not bucketed:
            rrows = got[0].cpu().numpy()
            k3_cell_ms = time_ms(lambda: mega_track_chunk_objects(*rargs), 5) / rf
            k3_cell_bound = chunk_bound([(rargs[1][i].tolist(), rrows[i], rf, rclip.shape[1:],
                                          (160, 160), rconfig) for i in range(8)], rf,
                                        shared_frame=True)[0]
        print(f"K3 1080p/r160 {label}, resident plan: each object bit-equal to K1 alone"
              + (f"; ms per step {k3_cell_ms:.5f}, bound {k3_cell_bound:.5f}" if not bucketed
                 else ""))
    reset_counts()
    _, rserved = serve_objects(iter(rclip[1:]), init_multi_state(
        [rg0[y : y + 160, x : x + 160] for x, y in rspots], [(x, y, 160, 160) for x, y in rspots],
        device=dev), rclip.shape[1:], rconfig, chunk_size=16)
    if mega_track_chunk_objects.launches_by_plan != {"whole": 0, "resident": 1, "chunked": 0}:
        raise AssertionError(f"serve_objects at the cell's shape: launches by plan "
                             f"{mega_track_chunk_objects.launches_by_plan}")
    print(f"serve_objects, 8 objects 1080p/160/r160, chunk 16: launches by plan "
          f"{mega_track_chunk_objects.launches_by_plan}")
    lchunk = torch.from_numpy(frames[1 : of + 1]).to(dev)
    l8 = stack_states([state] * 8)
    l8args = (lchunk, torch.stack(list(l8.bbox), dim=-1), l8.template, l8.t_mean, l8.t_std,
              l8.lost_count, l8.use_global, of, config)
    k3_ms = time_ms(lambda: mega_track_chunk_objects(*l8args), 5) / of
    k3_plain_ms = time_ms(lambda: mega_track_chunk_objects_reference(*l8args), 1) / of
    l8_rows = mega_track_chunk_objects(*l8args)[0].cpu().numpy()
    k3_bound, k3_by = chunk_bound(
        [(l8args[1][i].tolist(), l8_rows[i], of, frames.shape[1:], (80, 80), config)
         for i in range(8)], of, shared_frame=True)
    k3_conv = conv2d_corr_ms(torch.cat([windows_of(lchunk, l8args[1][i].tolist(), l8_rows[i],
                                                   80, 80, 60) for i in range(8)], dim=1),
                             l8.template)
    noise = np.random.default_rng(8).random((80, 80), dtype=np.float32)
    lost = init_state(noise, (600, 300, 80, 80))._replace(
        use_global=torch.tensor(True, device=dev))  # matches nothing: stays global
    g8 = stack_states([state] * 3 + [lost] + [state] * 4)
    g8args = (lchunk, torch.stack(list(g8.bbox), dim=-1), g8.template, g8.t_mean, g8.t_std,
              g8.lost_count, g8.use_global, of, config)
    if not bool((mega_track_chunk_objects(*g8args)[0][3, :, 9] != 0).all()):
        raise AssertionError("K3 K=8: the held object left global search")
    k3_g8_ms = time_ms(lambda: mega_track_chunk_objects(*g8args), 3) / of
    print(f"K3 K=8 all local, ms per step: kernel {k3_ms:.5f}, plain {k3_plain_ms:.5f}, bound "
          f"{k3_bound:.5f} ({k3_by}); F.conv2d on the correlation term alone {k3_conv:.5f}. "
          f"K=8 with one object held in global search: {k3_g8_ms:.5f}")

    n_serve = 1024
    starts8 = stack_states([state] * 8)
    staged = torch.from_numpy(frames[1 : n_serve + 1]).to(dev)
    _, dev_out = track_objects_mega(staged, starts8, config, chunk_size=64)
    dev_fps = n_serve / (time_ms(lambda: track_objects_mega(staged, starts8, config,
                                                            chunk_size=64), 2) / 1000.0)
    reset_counts()
    t0 = time.perf_counter()
    _, served_o = serve_objects(iter(frames[1 : n_serve + 1]), starts8, frames.shape[1:], config,
                                chunk_size=64)
    serve_o_s = time.perf_counter() - t0
    k3_launches = mega_track_chunk_objects.launches
    if (mega_track_chunk.launches or mega_track_chunk_multi.launches
            or k3_launches != -(-n_serve // 64) * chunk_launches(64)):
        raise AssertionError(f"serve_objects launched K3 {k3_launches} times, K1 "
                             f"{mega_track_chunk.launches}, K2 {mega_track_chunk_multi.launches}")
    o_err = max(max_l1_err_px(spec, served_o.bbox[:, k]) for k in range(8))
    if o_err != 0:
        raise AssertionError(f"serve_objects max_l1_err_px {o_err} != 0")
    if not all(np.array_equal(a, b) for a, b in zip(served_o, dev_out)):
        raise AssertionError("serve_objects and track_objects_mega disagree")
    print(f"serve_objects: 8 objects over {n_serve} frames in {serve_o_s:.3f} s: "
          f"{n_serve / serve_o_s:.1f} frames/s ({8 * n_serve / serve_o_s:.1f} object-frames/s); "
          f"device path (track_objects_mega, frames on the card) {dev_fps:.1f} frames/s; 0 px, "
          f"equal to track_objects_mega; {k3_launches} K3 launches; "
          f"{host_path}; on {smi}")

    # Phase 6 (run_bench zeroes K1's count again just before the main path's
    # checked run and reads it just after; nothing else runs in between).
    reset_counts()
    result = run_bench(clip=(spec, frames))
    if mega_track_chunk_multi.launches or mega_track_chunk_objects.launches:
        raise AssertionError("the main path launched K2 or K3")
    print("main path:", json.dumps(result))
    if result["max_l1_err_px"] != 0:
        raise AssertionError(f"main path max_l1_err_px {result['max_l1_err_px']} != 0")
    if result["kernel_launches"] != 2048 // 512 * chunk_launches(512):
        raise AssertionError(f"kernel launches {result['kernel_launches']} != 4, one a chunk")
    print(f"main path: {result['value']:.1f} frames/s, {result['ms_per_frame']:.5f} ms/frame "
          f"on {smi}")

    # Phase 7.
    lengths = [1200 - 50 * s for s in range(8)]
    offsets = stream_cuts(8, frames.shape[0], lengths)
    starts = stream_states(spec, frames, offsets, dev)
    chunk_size = 64
    timings: list = []
    reset_counts()
    t0 = time.perf_counter()
    _, served = serve_streams([iter(frames[o + 1 : o + 1 + n]) for o, n in zip(offsets, lengths)],
                              starts, frames.shape[1:], config,
                              chunk_size=chunk_size, timings=timings)
    serve_s = time.perf_counter() - t0
    serve_launches = mega_track_chunk_multi.launches
    if (mega_track_chunk.launches or mega_track_chunk_objects.launches
            or serve_launches != len(timings) * chunk_launches(chunk_size)):
        raise AssertionError(f"serving launched K2 {serve_launches} times, K1 "
                             f"{mega_track_chunk.launches}, K3 "
                             f"{mega_track_chunk_objects.launches}")
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
          f"ground truth and equal to track_video_mega alone; {serve_launches} K2 launches; "
          f"{host_path}; on {smi}")

    # Phase 8: K4 and K5 against their plain versions.
    rng = np.random.default_rng(11)
    arg_err = check_k5(dev, (spec, frames), rng)
    map_err = check_k4(dev, rng)

    def plain_step(frame_shape, templ_shape, cfg):
        """The per-frame step on the plain versions of K4 and K5, on the card."""
        span = (2 * cfg.search_radius_y + 1, 2 * cfg.search_radius_x + 1)

        def full_fn(frame, templ, t_mean, t_std):
            return ncc_map_lanes_reference(frame, templ, t_mean, t_std)[0]

        def region_fn(frame, templ, t_mean, t_std, x0, y0):
            return ncc_map_lanes_reference(frame, templ, t_mean, t_std, [(x0, y0)], span)[0]

        def argmax_fn(frame, templ, t_mean, t_std, x0, y0, b):
            lane = (x0, y0, b.min_tx - x0, b.max_tx - x0, b.min_ty - y0, b.max_ty - y0)
            return region_argmax_lanes_reference(frame, templ, t_mean, t_std, [lane], span)[0]

        return make_step(frame_shape, templ_shape, cfg, ncc_full_fn=full_fn,
                         ncc_region_fn=region_fn,
                         ncc_region_argmax_fn=argmax_fn if max(span) <= 128 else None)

    def plain_video(clip_frames, start, cfg):
        """track_video on the plain engine, on the card."""
        return track_video(clip_frames, start, cfg, step=plain_step(
            clip_frames.shape[1:], tuple(start.template.shape), cfg))[1]

    # Phase 9: this slice's main path, track_stream(backend="shared") over the
    # bench clip, beside track_video_mega on the same frames.
    n_main = 2048
    staged = torch.from_numpy(frames[1 : n_main + 1]).to(dev)
    reads0 = host_read.count
    t0 = time.perf_counter()
    _, mega_out = track_video_mega(staged, state, config, chunk_size=512)
    mega_s = time.perf_counter() - t0
    mega_reads = (host_read.count - reads0) / n_main
    reset_counts()
    reads0 = host_read.count
    t0 = time.perf_counter()
    _, stream_out = track_stream(iter(frames[1 : n_main + 1]), state, frames.shape[1:], config,
                                 backend="shared", chunk_size=32)
    stream_s = time.perf_counter() - t0
    stream_reads = (host_read.count - reads0) / n_main
    expect_counts("track_stream(shared)", K5=n_main)
    arg_launches = ncc_region_argmax_pallas.launches
    if max_l1_err_px(spec, stream_out.bbox) != 0:
        raise AssertionError("track_stream(shared) is off the ground truth")
    compare_outputs("track_stream(shared) vs track_video_mega", stream_out, mega_out)
    t0 = time.perf_counter()
    _, dev_out = track_video(staged, state, config, backend="shared")
    engine_s = time.perf_counter() - t0
    compare_outputs("track_video(shared), frames on the card", dev_out, stream_out)
    print(f"main path of the engines: track_stream(shared) over {n_main} frames of the bench "
          f"clip in {stream_s:.3f} s: {n_main / stream_s:.1f} frames/s, "
          f"{stream_reads:.4f} host reads a frame, 0 px, equal to track_video_mega, "
          f"{arg_launches} K5 launches and no other; track_video(shared) with the frames on "
          f"the card {n_main / engine_s:.1f} frames/s; track_video_mega "
          f"{n_main / mega_s:.1f} frames/s (one call, host clock), {mega_reads:.6f} host reads "
          f"a frame; on {smi}")

    # Phase 10: the same path through the pvot-torch CLI, over its synthetic
    # clip of the bench geometry (SyntheticSpec(1280, 720, 2049), seed 0).
    cspec = SyntheticSpec(width=1280, height=720, num_frames=n_main + 1)
    cx, cy, cw, ch = target_bbox(cspec, 0)
    traj = "build/chip_smoke_cli_trajectory.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["--synthetic", f"1280x720x{n_main + 1}", "--max-frames", str(n_main),
                   "--first", "--roi", f"{cx},{cy},{cw},{ch}", "--shared", "--device", "cuda",
                   "--no-display", "--trajectory-out", traj])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"pvot-torch --shared exited {rc}")
    expect_counts("pvot-torch --shared", K5=n_main)
    with open(traj) as f:
        recs = [json.loads(line) for line in f]
    cli_out = StepOutput(np.array([r["bbox"] for r in recs], np.int32),
                         np.array([r["score"] for r in recs], np.float32),
                         np.array([r["used_global"] for r in recs]),
                         np.array([r["updated"] for r in recs]))
    if len(recs) != n_main or max_l1_err_px(cspec, cli_out.bbox) != 0:
        raise AssertionError("pvot-torch --shared is off the ground truth")
    cframes = generate_gray_video(cspec)
    _, cli_mega = track_video_mega(cframes[1:], state_at(cspec, cframes, 0, dev), config,
                                   chunk_size=512)
    compare_outputs("pvot-torch --shared vs track_video_mega", cli_out, cli_mega)
    print(f"pvot-torch --shared: {n_main} frames in {cli_s:.3f} s (synthesis of the clip "
          f"included), 0 px, equal to track_video_mega, {n_main} K5 launches and no other")

    # Phase 11: re-acquisition at 720p (phase 3's clip, lost threshold 5):
    # one K4 launch per global frame, one K5 launch per local one.
    reset_counts()
    _, g_out = track_video(gframes[1:], gstate, gconfig, backend="shared")
    n_glob = int(g_out.used_global.sum())
    expect_counts("re-acquisition", K4=n_glob, K5=len(g_out.bbox) - n_glob)
    map_launches = n_glob
    if not n_glob:
        raise AssertionError("the re-acquisition clip ran no global frame")
    compare_outputs("re-acquisition 720p: CUDA engine vs plain engine", g_out,
                    plain_video(gframes[1:], gstate, gconfig))
    print(f"re-acquisition 720p/80/r60: {n_glob} global frames of {len(g_out.bbox)}, K4 "
          f"launched once per global frame, K5 once per local one; equal to the plain engine")

    # Phase 12: 1080p / 160x160 / r160: the span (321) takes the K4 region
    # path; with global frames (a state set in global search).
    b_clip = bframes[1:]
    reset_counts()
    _, b_out = track_video(b_clip, bstate, bconfig, backend="shared")
    expect_counts("1080p/160/r160", K4=len(b_out.bbox))
    compare_outputs("1080p/160/r160: CUDA engine vs plain engine", b_out,
                    plain_video(b_clip, bstate, bconfig), 160 * 160)
    bheld = bstate._replace(use_global=torch.tensor(True, device=dev))
    _, bh_out = track_video(b_clip[:2], bheld, bconfig, backend="shared")
    if not bh_out.used_global[0]:
        raise AssertionError("1080p/160: the held state ran no global frame")
    compare_outputs("1080p/160 global frames: CUDA engine vs plain engine", bh_out,
                    plain_video(b_clip[:2], bheld, bconfig), 160 * 160)
    # A local frame's search both ways: K4 over the region + the argmax by
    # torch ops (the gated path), and K5 forced over the whole 321 x 321 span.
    bframe = torch.from_numpy(bframes[0]).to(dev)
    b_tm, b_ts = bstate.t_mean, bstate.t_std
    bx, by = int(bstate.bbox_x), int(bstate.bbox_y)
    bb = search_ops.local_window_bounds(bx + 80, by + 80, 160, 160, 1920 - 159, 1080 - 159,
                                        160, 160)
    bx0, by0 = search_ops.region_origin(bb, 1920 - 159, 1080 - 159, 321, 321)
    blane = (bx0, by0, bb.min_tx - bx0, bb.max_tx - bx0, bb.min_ty - by0, bb.max_ty - by0)
    gated = search_ops.masked_region_best(ncc_map_lanes(
        bframe, bstate.template, b_tm, b_ts, [(bx0, by0)], (321, 321))[0], bx0, by0, bb)
    forced = region_argmax_lanes(bframe, bstate.template, b_tm, b_ts, [blane], (321, 321))[0]
    if gated[1:].tolist() != forced[1:].tolist():
        raise AssertionError(f"1080p/160: K5 forced over the span {forced.tolist()} vs "
                             f"K4 + argmax {gated.tolist()}")
    b_gated_ms = time_ms(lambda: search_ops.masked_region_best(ncc_map_lanes(
        bframe, bstate.template, b_tm, b_ts, [(bx0, by0)], (321, 321))[0], bx0, by0, bb), 10)
    b_forced_ms = time_ms(lambda: region_argmax_lanes(bframe, bstate.template, b_tm, b_ts,
                                                      [blane], (321, 321)), 10)
    print(f"1080p/160/r160: {len(b_out.bbox)} frames ({int(b_out.used_global.sum())} global) "
          f"and 2 from a state set global, each one K4 launch, equal to the plain engine; a "
          f"local frame's "
          f"search: K4 region + torch argmax {b_gated_ms:.4f} ms, K5 forced over the span "
          f"{b_forced_ms:.4f} ms (same winner)")

    # Phase 13: several lanes.  (a) K = 4 objects on phase 5's clip (one from
    # outside the frame): one K5 launch per frame step for all four;
    # (b) 4 streams in one masked chunk (phase 4's streams, one ended, one
    # partial); (c) a bucketed set, all local, on the bucketed torch-ops
    # engine.  Each lane held against the plain engine on that lane alone.
    uni = [g0[y : y + 80, x : x + 80] for x, y in cut_at]
    urois = [(x, y, 80, 80) for x, y in start_at]
    reset_counts()
    _, m_out = track_video_multi(oclip[1:], init_multi_state(uni, urois), config,
                                 backend="shared")
    n_mglob = int(m_out.used_global.any(axis=1).sum())
    expect_counts("track_video_multi K=4", K5=of, K4=n_mglob)
    if not m_out.used_global[:, 3].any():
        raise AssertionError("K=4: the object from outside ran no global frame")
    for k in range(4):
        compare_outputs(f"K=4 object {k}", StepOutput(*(v[:, k] for v in m_out)),
                        plain_video(oclip[1:], init_state(uni[k], urois[k]), config))
    sstates = stack_states([state, gstate, state_at(spec, frames, 399, dev),
                            state_at(spec, frames, 799, dev)])
    nv = [f4, f4, 0, 20]
    valid = np.stack([np.arange(f4) < n for n in nv], axis=1)
    scan = make_stream_masked_scan_fn(make_multi_stream_step((720, 1280), (80, 80), gconfig,
                                                             backend="shared"))
    reset_counts()
    _, s_out = scan(sstates, fr4.permute(1, 0, 2, 3), valid)
    if ncc_region_argmax_pallas.launches != f4:
        raise AssertionError(f"4 streams: K5 launched {ncc_region_argmax_pallas.launches} "
                             f"times for {f4} frame steps")
    for s_, n in enumerate(nv):
        if n:
            compare_outputs(f"stream {s_}", StepOutput(*(v[:n, s_] for v in s_out)),
                            plain_video(fr4[s_, :n], unstack_state(sstates, s_), gconfig))
    bext = [(80, 80), (64, 48), (48, 64), (32, 32)]
    btempl = [g0[y : y + eh, x : x + ew] for (x, y), (eh, ew) in zip(cut_at, bext)]
    brois = [(x, y, ew, eh) for (x, y), (eh, ew) in zip(cut_at, bext)]
    _, bk_out = track_video_multi(oclip[1:], init_multi_state_bucketed(btempl, brois), config)
    for k in range(4):
        compare_outputs(f"bucketed object {k} {bext[k]}", StepOutput(*(v[:, k] for v in bk_out)),
                        plain_video(oclip[1:], init_state(btempl[k], brois[k]), config))
    print(f"lanes: K=4 objects ({n_mglob} global steps) one K5 launch a step, 4 streams "
          f"(one ended, one partial) one K5 launch a step, bucketed {bext}; every lane "
          f"equal to the plain engine on it alone")

    # Phase 14: batch mode at n = 4 over 203 frames (3 left over).
    reset_counts()
    _, bt_out = track_video_batched(frames[1:204], state, config, batch_size=4,
                                    backend="shared")
    expect_counts("batch mode", K5=50)
    last = plain_video(frames[4:201:4], state, config)
    compare_outputs("batch mode, batch-final frames", StepOutput(*(v[3:200:4] for v in bt_out)),
                    last)
    held = [i for i in range(203) if i % 4 != 3 or i >= 200]
    if (bt_out.updated[held].any() or not (bt_out.score[held] == -1.0).all()
            or not (bt_out.bbox[200:] == bt_out.bbox[199]).all()):
        raise AssertionError("batch mode: a held frame updated, or the tail moved")
    print("batch mode n=4, 203 frames: 50 K5 launches, batch-final frames equal to the plain "
          "engine, the 150 held frames and the 3-frame tail re-emit the bbox")

    # Phase 15: TF32.  The xla engine on the card with PyTorch's default
    # TF32 flags (cuDNN on, cuBLAS off) still scores in full float32.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _, x_out = track_video(frames[1:65], state, config, backend="xla")
    torch.backends.cudnn.allow_tf32 = False
    compare_outputs("xla engine, TF32 flags at their defaults, vs plain engine", x_out,
                    plain_video(frames[1:65], state, config))
    print("xla engine with the default TF32 flags: 64 frames equal to the plain engine")

    # Kernel times at the main path's shapes: device time per launch from
    # torch.profiler (CUDA events around the calls time the wrappers' host
    # work when it is the longer), and the engine path's device time by kernel.
    gframe = torch.from_numpy(frames[1]).to(dev)
    templ0, (tm0, ts0) = state.template, (state.t_mean, state.t_std)
    x0m, y0m = int(state.bbox_x) - 60, int(state.bbox_y) - 60
    lane5 = [(x0m, y0m, 0, 120, 0, 120)]
    map_call_ms = time_ms(lambda: ncc_map_lanes(gframe, templ0, tm0, ts0), 20)
    map_ms = profiled(lambda: [ncc_map_lanes(gframe, templ0, tm0, ts0) for _ in range(20)],
                      "ncc_kernel")[0] or map_call_ms
    map_plain_ms = time_ms(lambda: ncc_map_lanes_reference(gframe, templ0, tm0, ts0), 1)
    map_conv = time_ms(lambda: torch.nn.functional.conv2d(
        gframe.float()[None, None] / 255.0, templ0[None, None]), 5)
    map_bound, map_by = bound_ms(641 * 1201 * 6400, 720 * 1280 + 4 * (6400 + 641 * 1201))
    arg_call_ms = time_ms(lambda: region_argmax_lanes(gframe, templ0, tm0, ts0, lane5,
                                                      (121, 121)), 50)
    arg_ms = profiled(lambda: [region_argmax_lanes(gframe, templ0, tm0, ts0, lane5, (121, 121))
                               for _ in range(50)], "ncc_kernel")[0] or arg_call_ms
    arg_plain_ms = time_ms(lambda: region_argmax_lanes_reference(gframe, templ0, tm0, ts0,
                                                                 lane5, (121, 121)), 3)
    start_box = [int(v) for v in torch.stack(list(state.bbox)).tolist()]
    arg_fma = 6400 * scored_positions(start_box, stream_out.bbox, stream_out.used_global,
                                      frames.shape[1:], (80, 80), config)
    arg_bound, arg_by = bound_ms(arg_fma / n_main, 200 * 200 + 4 * 6400 + 12)
    arg_conv = conv2d_corr_ms(windows_of(staged[:64], start_box, mega_out.bbox[:64], 80, 80, 60),
                              templ0[None])
    print(f"K4 global frame 720p/80: kernel {map_ms:.4f} ms (a call {map_call_ms:.4f}), plain "
          f"{map_plain_ms:.4f}, bound {map_bound:.4f} ({map_by}), F.conv2d correlation alone "
          f"{map_conv:.4f}; K5 local frame 720p/80/r60: kernel {arg_ms:.5f} ms (a call "
          f"{arg_call_ms:.5f}), plain {arg_plain_ms:.5f}, bound {arg_bound:.5f} ({arg_by}), "
          f"F.conv2d correlation alone {arg_conv:.5f}")
    n_prof = 512
    _, by_kernel, prof_wall = profiled(lambda: track_video(staged[:n_prof], state, config,
                                                           backend="shared"), "ncc_kernel")
    busy = sum(ms for _, ms in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"engine path under the profiler, {n_prof} frames: wall {prof_wall:.2f} ms "
          f"({prof_wall / n_prof:.4f} a frame, profiler on), device busy {busy:.2f} ms "
          f"({100 * busy / prof_wall:.1f} %); by kernel (launches, ms): "
          + "; ".join(f"{name[:60]}: {n}, {ms:.3f}" for name, (n, ms) in top))

    # Phase 16: the bf16 score tiers of K1 against their plain versions, TF32
    # off: phase 3's chunk, its re-acquisition clip (global frames score at
    # the tier in the strips), 1080p/160/r160 with global frames and the
    # 256 x 256 template; then per tier the times of a local and a global
    # frame beside their bounds (bf16 passes at the tensor-core peak), the
    # plain version's and F.conv2d's in bf16 (the 1-pass term alone).
    k1_tiers, k2_tiers, k3_tiers, fps_tiers = {}, {}, {}, {"f32": result["value"]}
    launches_by_tier = {"f32": result["kernel_launches_by_passes"][0]}
    k1_bf16_conv = conv2d_corr_ms(windows_of(chunk, k1_start, k1_rows, 80, 80, 60), args[2][None],
                                  dtype=torch.bfloat16)
    n_k1 = args[0].shape[0]
    g4 = (hargs[0][:4], *hargs[1:7], 4, config)
    for p in TIERS:
        kw = dict(highest=False, score_passes=p)
        reset_counts()
        err = compare(f"K1 {p}-pass 720p tracked chunk", mega_track_chunk(*args, **kw),
                      mega_track_chunk_reference(*args, **kw))
        if mega_track_chunk.launches_by_tier != {0: 0, 1: 0, 2: 0, 3: 0, p: chunk_launches(n_k1)}:
            raise AssertionError(f"K1 {p}-pass launched {mega_track_chunk.launches_by_tier}")
        got = mega_track_chunk(*gargs, **kw)
        if not bool((got[0][:, 9] != 0).any()):
            raise AssertionError(f"K1 {p}-pass: the re-acquisition clip ran no global frame")
        err = max(err, compare(f"K1 {p}-pass 720p re-acquisition clip", got,
                               mega_track_chunk_reference(*gargs, **kw)))
        err = max(err, compare(f"K1 {p}-pass 1080p/160/r160", mega_track_chunk(*bargs, **kw),
                               mega_track_chunk_reference(*bargs, **kw), 160 * 160))
        err = max(err, compare(f"K1 {p}-pass 1080p/160 global frames",
                               mega_track_chunk(*bglob, **kw),
                               mega_track_chunk_reference(*bglob, **kw), 160 * 160))
        err = max(err, compare(f"K1 {p}-pass 720p/256x256/r40", mega_track_chunk(*sargs, **kw),
                               mega_track_chunk_reference(*sargs, **kw), 256 * 256))
        t_ms = time_ms(lambda: mega_track_chunk(*args, **kw), 10) / n_k1
        t_plain = time_ms(lambda: mega_track_chunk_reference(*args, **kw), 1) / n_k1
        t_rows = mega_track_chunk(*args, **kw)[0].cpu().numpy()
        t_bound, t_by = chunk_bound([(k1_start, t_rows, n_k1, frames.shape[1:], (80, 80),
                                      config)], n_k1, p)
        hrows_p = mega_track_chunk(*hargs, **kw)[0].cpu().numpy()
        if not (hrows_p[:, 9] != 0).all():
            raise AssertionError(f"K1 {p}-pass: the held template left global search")
        tg_ms = time_ms(lambda: mega_track_chunk(*hargs, **kw), 3) / gh
        tg_plain = time_ms(lambda: mega_track_chunk_reference(*g4, **kw), 1) / 4
        tg_bound, tg_by = chunk_bound([(hargs[1].tolist(), hrows_p, gh, frames.shape[1:],
                                        (80, 80), config)], gh, p)
        k1_tiers[p] = dict(max_abs_err=err, ms=t_ms, plain_ms=t_plain, bound_ms=t_bound,
                           bound_by=t_by, conv2d_corr_ms=k1_bf16_conv, global_frame_ms=tg_ms,
                           plain_global_frame_ms=tg_plain, global_frame_bound_ms=tg_bound,
                           global_frame_bound_by=tg_by)
        print(f"K1 {p}-pass, ms per frame: local (720p/80/r60) kernel {t_ms:.5f}, plain "
              f"{t_plain:.5f}, bound {t_bound:.6f} ({t_by}), F.conv2d bf16 {k1_bf16_conv:.5f}; "
              f"global kernel {tg_ms:.4f}, plain {tg_plain:.4f}, bound {tg_bound:.5f} ({tg_by}) "
              f"[f32: local {ms:.5f}, global {g_ms:.4f}]")

    # Phase 17: lanes at each tier.  K2 at S = 4 (phase 4's streams: local,
    # re-acquiring, ended, partial) against its plain tier and each stream
    # bit-equal to K1 on it alone; K3 uniform and bucketed (phase 5's four
    # roles over 12 frames) likewise; then K2 at S = 8 and K3 at K = 8, all
    # local, timed beside the plain version and the bound.
    f8l = torch.stack([torch.from_numpy(frames[64 * i + 1 : 64 * i + 33]) for i in range(8)]).to(dev)
    st8l = stacked_args([state_at(spec, frames, 64 * i, dev) for i in range(8)])
    nv8l = torch.full((8,), 32, dtype=torch.int32, device=dev)

    def s8_windows(rows8):
        """The 8 local streams' windows side by side, (32, 8, 200, 200)."""
        return torch.cat([windows_of(f8l[i], st8l[0][i].tolist(), rows8[i], 80, 80, 60)
                          for i in range(8)], dim=1)

    of12 = 12
    roles = {}
    for label, extents in (("uniform", [(80, 80)] * 4),
                           ("bucketed", [(80, 80), (64, 48), (48, 64), (32, 32)])):
        templates = [g0[y : y + eh, x : x + ew] for (x, y), (eh, ew) in zip(cut_at, extents)]
        rois = [(x, y, ew, eh) for (x, y), (eh, ew) in zip(start_at, extents)]
        ost = (init_multi_state if label == "uniform" else init_multi_state_bucketed)(templates,
                                                                                    rois)
        roles[label] = ((ochunk[:of12], torch.stack(list(ost.bbox), dim=-1), ost.template,
                         ost.t_mean, ost.t_std, ost.lost_count, ost.use_global, of12, config),
                        None if label == "uniform" else extents)
    for p in TIERS:
        kw = dict(highest=False, score_passes=p)
        got = mega_track_chunk_multi(fr4, *st4, nv4, gconfig, **kw)
        e2 = compare(f"K2 {p}-pass S=4", got, mega_track_chunk_multi_reference(
            fr4, *st4, nv4, gconfig, **kw))
        for s_ in range(4):
            k1 = mega_track_chunk(fr4[s_], *(a[s_] for a in st4), int(nv4[s_]), gconfig, **kw)
            if not (torch.equal(k1[0], got[0][s_]) and torch.equal(k1[1], got[1][s_])):
                raise AssertionError(f"K2 {p}-pass stream {s_} differs from K1 on it alone")
        e3 = 0.0
        for label, (oa, bucket) in roles.items():
            got = mega_track_chunk_objects(*oa, bucket_extents=bucket, **kw)
            if not bool((got[0][3, :, 9] != 0).any()):
                raise AssertionError(f"K3 {p}-pass {label}: the object from outside ran no "
                                     "global frame")
            e3 = max(e3, compare(f"K3 {p}-pass {label} K=4", got,
                                 mega_track_chunk_objects_reference(*oa, bucket_extents=bucket,
                                                                    **kw)))
            for i, (eh, ew) in enumerate(bucket or [(80, 80)] * 4):
                one = [a[i] for a in oa[1:7]]
                one[1] = one[1][:eh, :ew].contiguous()
                k1 = mega_track_chunk(oa[0], *one, of12, config, **kw)
                if not (torch.equal(k1[0], got[0][i]) and torch.equal(k1[1], got[1][i, :eh, :ew])):
                    raise AssertionError(f"K3 {p}-pass {label} object {i} differs from K1 alone")
        print(f"K2 {p}-pass S=4 and K3 {p}-pass uniform and bucketed K=4: each lane's records "
              f"and template bit-equal to K1 on it alone")
        k2_rows = mega_track_chunk_multi(f8l, *st8l, nv8l, config, **kw)[0].cpu().numpy()
        k2t = time_ms(lambda: mega_track_chunk_multi(f8l, *st8l, nv8l, config, **kw), 5) / 32
        k2p = time_ms(lambda: mega_track_chunk_multi_reference(f8l, *st8l, nv8l, config, **kw),
                      1) / 32
        k2b, k2by = chunk_bound([(st8l[0][i].tolist(), k2_rows[i], 32, frames.shape[1:], (80, 80),
                                  config) for i in range(8)], 32, p)
        k2c = conv2d_corr_ms(s8_windows(k2_rows), st8l[1], dtype=torch.bfloat16)
        k2_tiers[p] = dict(max_abs_err=e2, ms=k2t, plain_ms=k2p, bound_ms=k2b, bound_by=k2by,
                           conv2d_corr_ms=k2c)
        l8_rows_p = mega_track_chunk_objects(*l8args, **kw)[0].cpu().numpy()
        k3t = time_ms(lambda: mega_track_chunk_objects(*l8args, **kw), 5) / of
        k3p = time_ms(lambda: mega_track_chunk_objects_reference(*l8args, **kw), 1) / of
        k3b, k3by = chunk_bound([(l8args[1][i].tolist(), l8_rows_p[i], of, frames.shape[1:],
                                  (80, 80), config) for i in range(8)], of, p,
                                shared_frame=True)
        k3c = conv2d_corr_ms(torch.cat([windows_of(lchunk, l8args[1][i].tolist(), l8_rows_p[i],
                                                   80, 80, 60) for i in range(8)], dim=1),
                             l8.template, dtype=torch.bfloat16)
        k3_tiers[p] = dict(max_abs_err=e3, ms=k3t, plain_ms=k3p, bound_ms=k3b, bound_by=k3by,
                           conv2d_corr_ms=k3c)
        print(f"K2 {p}-pass S=8 all local, ms per step: kernel {k2t:.5f}, plain {k2p:.5f}, bound "
              f"{k2b:.6f} ({k2by}), F.conv2d bf16 {k2c:.5f}; K3 {p}-pass K=8 all local: "
              f"kernel {k3t:.5f}, plain {k3p:.5f}, bound {k3b:.6f} ({k3by}), F.conv2d bf16 {k3c:.5f}")
    k2_f32_s8 = time_ms(lambda: mega_track_chunk_multi(f8l, *st8l, nv8l, config), 5) / 32
    k2_f32_s8_conv = conv2d_corr_ms(s8_windows(mega_track_chunk_multi(
        f8l, *st8l, nv8l, config)[0].cpu().numpy()), st8l[1])

    # Phase 18: the JAX package's headline configuration, track_video_mega at
    # 1 pass over the bench clip (2048 frames, chunk 512; bench.py:78-88),
    # with the counters reset just before: 0 px, only the 1-pass K1 launched,
    # once a chunk; then 3 and 2 passes, each 0 px; frames/s of every tier
    # from this run (the float32 one is phase 6's).
    for p in (1, 3, 2):
        reset_counts()
        tier_result = run_bench(clip=(spec, frames), highest=False, score_passes=p)
        # run_bench zeroes K1's counters just before its checked run and
        # reads them just after; the other kernels' stay 0 through its runs.
        others = {n_: c for n_, c in counts().items() if n_ != "K1"}
        if (any(others.values()) or tier_result["kernel_launches"] != 4
                or tier_result["kernel_launches_by_passes"] != {0: 0, 1: 0, 2: 0, 3: 0, p: 4}):
            raise AssertionError(f"main path at {p} passes launched {others}, "
                                 f"{tier_result['kernel_launches_by_passes']}")
        if tier_result["max_l1_err_px"] != 0:
            raise AssertionError(f"main path at {p} passes max_l1_err_px "
                                 f"{tier_result['max_l1_err_px']} != 0")
        fps_tiers[f"{p}pass"] = tier_result["value"]
        launches_by_tier[f"{p}pass"] = tier_result["kernel_launches_by_passes"][p]
        print(f"main path at {p} passes ({tier_result['tier']}): {tier_result['value']:.1f} "
              f"frames/s, {tier_result['ms_per_frame']:.5f} ms/frame, 0 px, "
              f"{tier_result['kernel_launches']} launches of the {p}-pass K1 only, on {smi}")
    print(f"main path frames/s by tier: {json.dumps(fps_tiers)}")

    # Phase 19: serving at 1 pass, serve_streams over phase 7's 8 streams,
    # counters reset just before: 0 px, each stream equal to track_video_mega
    # at 1 pass on it alone, only the 1-pass K2 launched.
    reset_counts()
    t0 = time.perf_counter()
    _, served1 = serve_streams([iter(frames[o + 1 : o + 1 + n_]) for o, n_ in zip(offsets, lengths)],
                               starts, frames.shape[1:], config, chunk_size=chunk_size,
                               highest=False, score_passes=1)
    serve1_s = time.perf_counter() - t0
    if (mega_track_chunk.launches or mega_track_chunk_objects.launches
            or mega_track_chunk_multi.launches != mega_track_chunk_multi.launches_by_tier[1]
            or mega_track_chunk_multi.launches != serve_launches):
        raise AssertionError(f"1-pass serving launched {counts()}, "
                             f"{mega_track_chunk_multi.launches_by_tier}")
    for s_, (o, n_) in enumerate(zip(offsets, lengths)):
        if stream_err_px(spec, o, served1[s_].bbox) != 0:
            raise AssertionError(f"1-pass stream {s_} is off the ground truth")
        _, alone = track_video_mega(frames[o + 1 : o + 1 + n_], unstack_state(starts, s_),
                                    config, chunk_size=chunk_size, highest=False, score_passes=1)
        compare_outputs(f"1-pass stream {s_}", served1[s_], alone)
    print(f"serving at 1 pass: 8 streams, {total} frames in {serve1_s:.3f} s: "
          f"{total / serve1_s:.1f} frames/s aggregate; every stream 0 px and equal to "
          f"track_video_mega at 1 pass alone; {serve_launches} launches of the 1-pass K2 only; "
          f"{host_path}")

    # Phase 20: K4 and K5 at 3 passes against their plain versions; the
    # pallas_fast engine path, track_stream over the bench clip (0 px, the
    # 3-pass K5 once a frame and nothing else); pvot-torch --fast (the
    # torch-ops engine at 3 passes: no kernel) on its synthetic clip.
    rng3 = np.random.default_rng(13)
    arg3_err = check_k5(dev, (spec, frames), rng3, passes=3)
    map3_err = check_k4(dev, rng3, highest=False)
    reset_counts()
    t0 = time.perf_counter()
    _, fast_out = track_stream(iter(frames[1 : n_main + 1]), state, frames.shape[1:], config,
                               backend="pallas_fast", chunk_size=32)
    fast_s = time.perf_counter() - t0
    expect_counts("track_stream(pallas_fast)", K5=n_main)
    if ncc_region_argmax_pallas.launches_by_tier[3] != n_main:
        raise AssertionError(f"pallas_fast launched K5 {ncc_region_argmax_pallas.launches_by_tier}")
    if max_l1_err_px(spec, fast_out.bbox) != 0:
        raise AssertionError("track_stream(pallas_fast) is off the ground truth")
    fast_argmax_launches = ncc_region_argmax_pallas.launches_by_tier[3]
    n_cli = 512
    fspec = SyntheticSpec(width=1280, height=720, num_frames=n_cli + 1)
    fx, fy, fw, fh = target_bbox(fspec, 0)
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["--synthetic", f"1280x720x{n_cli + 1}", "--first", "--roi",
                   f"{fx},{fy},{fw},{fh}", "--fast", "--device", "cuda", "--no-display",
                   "--trajectory-out", traj])
    cli_fast_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"pvot-torch --fast exited {rc}")
    expect_counts("pvot-torch --fast")
    with open(traj) as f:
        boxes = np.array([json.loads(line)["bbox"] for line in f], np.int32)
    if len(boxes) != n_cli or max_l1_err_px(fspec, boxes) != 0:
        raise AssertionError("pvot-torch --fast is off the ground truth")
    arg3_call = time_ms(lambda: region_argmax_lanes(gframe, templ0, tm0, ts0, lane5, (121, 121),
                                                    3), 50)
    arg3_ms = profiled(lambda: [region_argmax_lanes(gframe, templ0, tm0, ts0, lane5, (121, 121), 3)
                                for _ in range(50)], "ncc_kernel")[0] or arg3_call
    arg3_plain = time_ms(lambda: region_argmax_lanes_reference(gframe, templ0, tm0, ts0, lane5,
                                                               (121, 121), 3), 3)
    arg3_bound, arg3_by = bound_ms(arg_fma / n_main, 200 * 200 + 4 * 6400 + 12, 3)
    map3_ms = profiled(lambda: [ncc_map_lanes(bframe, bstate.template, b_tm, b_ts, [(bx0, by0)],
                                              (321, 321), 3) for _ in range(10)],
                       "ncc_kernel")[0] or time_ms(lambda: ncc_map_lanes(
                           bframe, bstate.template, b_tm, b_ts, [(bx0, by0)], (321, 321), 3), 10)
    map3_plain = time_ms(lambda: ncc_map_lanes_reference(bframe, bstate.template, b_tm, b_ts,
                                                         [(bx0, by0)], (321, 321), 3), 1)
    map3_bound, map3_by = bound_ms(321 * 321 * 160 * 160, 480 * 480 + 4 * (25600 + 321 * 321), 3)
    map_region_ms = profiled(lambda: [ncc_map_lanes(bframe, bstate.template, b_tm, b_ts,
                                                    [(bx0, by0)], (321, 321)) for _ in range(10)],
                             "ncc_kernel")[0] or b_gated_ms
    print(f"K5 3-pass local frame 720p/80/r60: kernel {arg3_ms:.5f} ms, plain {arg3_plain:.5f}, "
          f"bound {arg3_bound:.6f} ({arg3_by}) [f32 {arg_ms:.5f}]; K4 3-pass region 321x321 "
          f"at 1080p/160: kernel {map3_ms:.4f} ms, plain {map3_plain:.4f}, bound "
          f"{map3_bound:.5f} ({map3_by}) [f32 {map_region_ms:.4f}]; track_stream(pallas_fast) "
          f"{n_main} frames in {fast_s:.3f} s ({n_main / fast_s:.1f} frames/s), 0 px, "
          f"{n_main} 3-pass K5 launches and no other; pvot-torch --fast {n_cli} frames in "
          f"{cli_fast_s:.3f} s (synthesis included), 0 px, no kernel launched")

    # Phase 21: the batch cadence.  track_video_mega(batch=4) over 2047
    # frames of the bench clip (chunks of 512; the last, of 511, leaves a
    # 3-frame tail), counters reset just before; launches: one a chunk,
    # look-ahead rows and tail included.  As in phase
    # 14, the batch-final frames equal the plain engine over those frames
    # under the contract, and every other row is the look-ahead row: the
    # pre-batch bbox, score -1, not updated, not global.
    n_batch = 2047
    n_full = n_batch // 4 * 4
    reset_counts()
    _, bm_out = track_video_mega(staged[:n_batch], state, config, chunk_size=512, batch=4)
    want_launches = sum(chunk_launches(min(512, n_batch - c0), 4) for c0 in range(0, n_batch, 512))
    expect_counts("track_video_mega(batch=4)", K1=want_launches)
    compare_outputs("track_video_mega(batch=4), batch-final frames, vs the plain engine",
                    StepOutput(*(v[3:n_full:4] for v in bm_out)),
                    plain_video(frames[4 : n_full + 1 : 4], state, config))
    held = np.array([i for i in range(n_batch) if i % 4 != 3 or i >= n_full])
    pre_batch = np.concatenate([np.asarray(start_box)[None], bm_out.bbox])[
        np.minimum(held // 4 * 4, n_full)]
    if not (np.array_equal(bm_out.bbox[held], pre_batch) and (bm_out.score[held] == -1.0).all()
            and not bm_out.updated[held].any() and not bm_out.used_global[held].any()):
        raise AssertionError("batch 4: a held or tail row is not the look-ahead row")
    batch_ms = time_ms(lambda: track_video_mega(staged[:n_batch], state, config, chunk_size=512,
                                                batch=4), 2) / n_batch
    # Its bound a frame: the cadence frames' windows and correlation (one
    # score launch a batch), the template, and every frame's record, the
    # look-ahead rows included.
    cadence = np.zeros((n_full // 4, 10))
    cadence[:, :4] = bm_out.bbox[3:n_full:4]
    cadence[:, 9] = bm_out.used_global[3:n_full:4]
    batch_bound, batch_by = chunk_bound(
        [(start_box, cadence, len(cadence), frames.shape[1:], (80, 80), config)], n_batch,
        extra_bytes=40 * (n_batch - len(cadence)))
    print(f"batch mode n=4 on the chunk kernel: {n_batch} frames, {want_launches} K1 launches "
          f"({want_launches / n_batch:.4f} a frame), batch-final frames equal to the plain "
          f"engine, the held frames and the 3-frame tail look-ahead rows; {batch_ms:.5f} ms a "
          f"frame, bound {batch_bound:.6f} ({batch_by})")

    # Phase 22: K1's rung ladder.  Its checks on a 64-frame chunk of the bench
    # clip; then the ladder timed at every tier over its own clip (the JAX
    # ladder's, SyntheticSpec(1280, 720, 513, 80x80, seed=1)), global search
    # off, the counters reset just before and read just after.
    from pvot_torch.bench import FP32_FLOPS, HBM_BYTES_PER_S
    from pvot_torch.tools import global_strip_probe as gsp
    from pvot_torch.tools import mega_breakdown as bd

    ladder_err, ladder_rel, ladder_plain_ms = check_ladder(dev, spec, frames)
    ladder_clip = bench_clip(num_frames=512)
    reset_counts()
    bd.mega_breakdown_chunk.launches = 0
    ladder_runs = {tier: bd.ladder(tier, 512, dev, clip=ladder_clip) for tier in bd.TIERS}
    ladder_launches = bd.mega_breakdown_chunk.launches
    if ladder_launches == 0 or counts()["K1"] == 0:
        raise AssertionError("the ladder's run launched no rung or no production K1")
    expect_counts("the ladder's run (its production line)", K1=counts()["K1"])
    ladder_state = state_at(ladder_clip[0], ladder_clip[1], 0, dev)
    ladder_start = torch.stack(list(ladder_state.bbox)).tolist()
    ladder_frames = torch.from_numpy(ladder_clip[1][1:513]).to(dev)
    ladder_bounds = {}
    for tier, p in bd.TIERS.items():
        full_rows = bd.mega_breakdown_chunk("full", ladder_frames, ladder_state, bd.local_config(),
                                            tier)[0].cpu().numpy()
        ladder_bounds[tier] = chunk_bound([(ladder_start, full_rows, 512, frames.shape[1:],
                                            (80, 80), bd.local_config())], 512, p)
    print(f"ladder on {torch.cuda.get_device_name(0)} ({smi}), 720p/80/r60, chunk 512, "
          f"{bd.N_CALLS} calls a timing, best of 3; compile seconds by source: " + ", ".join(
              f"{unit} {sec:.1f}" for unit, sec in _build.build_info["units"].items()))
    for tier, run in ladder_runs.items():
        rungs = run["rungs"]
        print(f"ladder {tier}, us a frame (delta; the chunk kernel's device us): " + ", ".join(
            f"{r} {rungs[r]['us_per_frame']:.3f} ({run['deltas'][r]:+.3f}; "
            f"{rungs[r]['kernel_us_per_frame']:.3f})"
            for r in bd.RUNGS)
            + f"; production K1 {run['production']:.3f} (vs full "
            f"{run['production'] - rungs['full']['us_per_frame']:+.3f}); bound "
            f"{ladder_bounds[tier][0] * 1e3:.3f} ({ladder_bounds[tier][1]})")

    # Phase 23: the global-strip probes, counters reset just before.
    gsp.strip_best.launches = gsp.slab_refetch.launches = 0
    reset_counts()
    strip_errs = check_strip_probes(dev)
    strip_launches, refetch_launches = gsp.strip_best.launches, gsp.slab_refetch.launches
    expect_counts("the strip probes")
    if strip_launches == 0 or refetch_launches == 0:
        raise AssertionError("the strip probes launched no strip_best or no slab_refetch")
    x7, x8 = (torch.from_numpy(gsp.probe_frames(seed)).to(dev) for seed in (7, 8))
    strip_us, refetch_us = gsp.device_us(gsp.strip_best, x7), gsp.device_us(gsp.slab_refetch, x8)
    strip_plain_ms = time_ms(lambda: gsp.strip_best_reference(x7), 3)
    refetch_plain_ms = time_ms(lambda: gsp.slab_refetch_reference(x8), 3)
    # Bounds of one call on its probe's input: the bytes each strip's box
    # sums read (55 x 135 u8) and the operations (the convert, 7 + 7
    # additions an output of the separable sums, a comparison an output) at
    # the FP32 peak; the slabs the refetch reads (one or two of 64 x 256 u8 a
    # frame) and an addition a byte.
    n_strips = sum(len(gsp.strips_of(t)) for t in range(2))
    in_px = (gsp.DY_MAX + 7) * (gsp.TX + 7)
    strip_ops = n_strips * (in_px + 7 * gsp.DY_MAX * (gsp.TX + 7) + 8 * gsp.DY_MAX * gsp.TX)
    strip_t = (strip_ops / FP32_FLOPS, (n_strips * in_px + 2 * 3 * 4) / HBM_BYTES_PER_S)
    n_slabs = sum(1 + int(f[0, 0] & 1) for f in gsp.probe_frames(8))
    slab = gsp.SLAB_H * gsp.SLAB_W
    refetch_t = (n_slabs * slab / FP32_FLOPS, (n_slabs * slab + 2 * 2 * 4) / HBM_BYTES_PER_S)
    strip_bound, refetch_bound = (max(t) * 1e3 for t in (strip_t, refetch_t))
    strip_by, refetch_by = ("operations" if t[0] >= t[1] else "bytes" for t in (strip_t, refetch_t))
    print(f"strip probes: strip_best {strip_us:.3f} us a call (plain {strip_plain_ms:.4f} ms, "
          f"bound {strip_bound * 1e3:.5f} us, {strip_by}), slab_refetch {refetch_us:.3f} us "
          f"(plain {refetch_plain_ms:.4f} ms, bound {refetch_bound * 1e3:.5f} us, "
          f"{refetch_by}); launches {strip_launches} and {refetch_launches}")

    # Phases 24-25: the probe catalogues T4 and T5, the counters reset just
    # before each and read just after: T4's K5 probes launch K5 7 times
    # (3 + 3 windows and one 4-lane call), T5's K4 probes K4 twice.
    from pvot_torch.tools import fused_argmax_probe as fap
    from pvot_torch.tools import pallas_probe as pp

    t4 = run_probe_catalogue(dev, fap, fap.K5_PROBES, {"K5": 7}, counts, reset_counts)
    t5 = run_probe_catalogue(dev, pp, pp.K4_PROBES, {"K4": 2}, counts, reset_counts)
    print(f"probe catalogues on {torch.cuda.get_device_name(0)} ({smi}): T4 {t4['launches']} "
          f"launches, T5 {t5['launches']}; every probe held to its JAX bound and its plain "
          f"version (largest |kernel - plain| {t4['max_abs_err']:.3g}, {t5['max_abs_err']:.3g})")
    # The product sweep: the product probes and edge shapes, one launch a
    # call, two calls bit-equal (timed after phase 28).
    t_phase = time.perf_counter()
    products = product_sweep(dev)
    print(f"product sweep: {len(products)} products, {time.perf_counter() - t_phase:.1f} s")

    # Phase 26: ROADMAP C open check 1, the xla full map of a global frame of
    # phase 3's re-acquisition clip on the card against the CPU.
    check_full_map_on_card(dev, gframes[1:], mega_track_chunk(*gargs)[0].cpu().numpy(), gstate)

    # Phase 27: K1 bit for bit against the parent tree's (PARENT_DIGESTS): the
    # records, final state and final template at every tier, on phase 3's
    # chunk and re-acquisition clip, the main path and the batch-4 clip.
    from pvot_torch.ops.ncc_mega import _launch
    from pvot_torch.ops.ncc_reference import score_tier

    def launch_one(fr, st, cfg, kw):
        out = _launch(lib, "one", fr[None], torch.stack(list(st.bbox)), st.template, st.t_mean,
                      st.t_std, st.lost_count, st.use_global, [fr.shape[0]], cfg,
                      torch.cuda.current_stream(dev).cuda_stream,
                      passes=score_tier(kw.get("highest", True), kw.get("score_passes", 3)))
        _build.check(out.err, "mega_track_chunk")
        return out.rows, out.state_i, out.state_f, out.template

    digests = k1_digests(dev, (spec, frames), (gspec, gframes), gconfig, launch_one)
    differ = [f"{case} {tier}: {got} (parent {PARENT_DIGESTS[case][tier]})"
              for case, by_tier in digests.items() for tier, got in by_tier.items()
              if got != PARENT_DIGESTS[case][tier]]
    if differ:
        raise AssertionError("K1 differs from the parent tree's: " + "; ".join(differ))
    print(f"K1 digests: {len(digests)} clips x {len(digests['chunk64'])} tiers, records, final "
          f"state and template equal to the parent tree's bit for bit: {json.dumps(digests)}")

    # Phase 28: the main path under torch.profiler, in two sessions.  Each:
    # one kernel of the port's (the persistent chunk kernel), launched once a
    # chunk by its counter, and no commit kernel.  The second session's
    # records must count every launch; the first's count is reported: in this
    # process the first session after phases 24-27 has come back one chunk
    # kernel's record short (3 of the 4 launches) while the counter read 4.
    sessions = []
    for i in range(2):
        reset_counts()
        _, by_kernel, _ = profiled(
            lambda: track_video_mega(staged, state, config, chunk_size=512), "chunk_kernel")
        expect_counts(f"phase 28, profiler session {i + 1}", K1=n_main // 512)
        # The port's kernels are in an anonymous namespace of their own;
        # PyTorch's (the wrapper's small tensor ops) are under at::.
        ours = {k: v for k, v in by_kernel.items()
                if k.startswith("void (anonymous namespace)::")}
        if (len(ours) != 1 or "chunk_kernel" not in next(iter(ours))
                or any("commit_kernel" in k or "lookahead_kernel" in k for k in by_kernel)):
            raise AssertionError(f"the main path's kernels under profiler session {i + 1}: "
                                 f"{ours}")
        sessions.append(next(iter(ours.items())))
    prof_name, (prof_launches, prof_ms) = sessions[1]
    prof_first_records = sessions[0][1][0]
    if prof_launches != n_main // 512:
        raise AssertionError(f"the second profiler session recorded {prof_launches} chunk "
                             f"kernels for {n_main // 512} launches")
    print(f"main path under torch.profiler: one kernel of the port, {prof_name[:90]}, "
          f"{prof_launches} launches, {prof_ms / n_main * 1e3:.3f} us a frame on the device; "
          f"no commit kernel (first session: {prof_first_records} records of "
          f"{n_main // 512} launches)")

    # After phase 28: the graph-route timings of phases 24-25, every probe's
    # library call and the products (with --parent, in turns against the
    # parent tree's library, which phase 31 uses again).
    parent_lib = parent_library(opts.parent) if opts.parent else None
    for t_cat, tool in ((t4, fap), (t5, pp)):
        for name, make in tool.PROBES:
            us = fap.library_device_us(make(), dev)
            t_cat["probes"][name]["library_device_ms"] = None if us is None else us / 1e3
            if us is not None:
                print(f"{tool.__name__.rsplit('.', 1)[1]} {name}: the library call {us:.3f} us a "
                      f"call on the device (graph route)")
    t4["product_timings"] = product_timings(dev, smi, parent_lib)

    # Phase 29 (with --parent only): the parent tree and this one in turns.
    turns = in_turns(opts.parent, frames) if opts.parent else None
    if turns:
        print(f"in turns against the parent on {smi}: {json.dumps(turns['verdicts'])}")

    # Phase 30: K4 and K5 bit for bit against the parent tree's: the records
    # of the engine paths over them, K5's rows and K4's maps at float32 and 3
    # passes (`k45_digests`), equal to PARENT_K45_DIGESTS and, with --parent,
    # to the parent tree's own run in phase 29.
    k45 = k45_digests(dev, (spec, frames))
    wants = [("pasted", PARENT_K45_DIGESTS)]
    if turns:
        wants.append(("phase 29's parent tree", turns["parent_k45_digests"]))
    for source, want in wants:
        differ = [f"{case} {tier}: {got} ({source} {want[case][tier]})"
                  for case, by_tier in k45.items() for tier, got in by_tier.items()
                  if got != want[case][tier]]
        if differ:
            raise AssertionError("K4/K5 differ from the parent tree's: " + "; ".join(differ))
    print(f"K4/K5 digests: {len(k45)} cases x 2 tiers equal to the parent tree's "
          f"({' and '.join(source for source, _ in wants)}): {json.dumps(k45)}")

    # Phase 31: the region-step ladder of the engine step
    # (pvot_torch.tools.region_step_breakdown) over 1024 frames of the bench
    # clip, chunk 256, at both of the CUDA engine's tiers; its full rung's
    # records equal track_video's.  With --parent, in turns on the parent
    # tree's kernel library (parent, change, change, parent).  Then K4's and
    # K5's device times by the graph route, for the kernels' line.
    from pvot_torch.tools import region_step_breakdown as rsb

    libs = [None]
    if opts.parent:
        libs = [parent_lib, None, None, parent_lib]
    step_runs = []
    for lib in libs:
        with kernels_from(lib):
            step_runs += [("parent" if lib else "change", b,
                           rsb.ladder(b, 1024, 256, dev, clip=(spec, frames)))
                          for b in rsb.BACKENDS]
    steps = {b: res for tree, b, res in step_runs if tree == "change"}
    for tree, b, res in step_runs:
        print(f"region-step ladder, {tree} kernels, {b}, us a frame: " + ", ".join(
            f"{r} {v['us_per_frame']:.2f}" for r, v in res["rungs"].items())
              + "; " + ", ".join(f"{k} {v:.2f}" for k, v in res["diffs"].items())
              + f"; K5 device us a launch: profiler {res['k5']['profiler_us']:.2f}, graph "
              f"{res['k5']['graph_us']:.2f} (a wrapper call {res['k5']['call_us']:.2f}); full "
              f"equals track_video; build_only, no_build: no counterpart (R3)")
    k45_ms = k45_device_ms(dev, (spec, frames),
                           lambda launch, n: rsb.graph_us(launch, n) / 1e3)
    print(f"K4/K5 device ms a launch, graph route, on {smi}: {json.dumps(k45_ms)}")

    # Phase 32: serving over the scan engines and the remaining surfaces,
    # each drive with the counters reset just before and read just after.
    from pvot_torch.cli.serve import main as serve_main
    from pvot_torch.io.synthetic import generate_gray_frames
    from pvot_torch.tracker.mega import mega_chunk_step

    def lockstep_global_steps(outs, n_frames):
        """Frame steps of a lockstep run on which some live lane searched
        globally (an ended lane keeps a state that these clips leave local)."""
        return sum(any(t < n and bool(o.used_global[t]) for o, n in zip(outs, n_frames))
                   for t in range(max(n_frames)))

    t_phase = time.perf_counter()
    # (a) phase 7's 8 streams on the CUDA engine: one K5 launch a lockstep
    # frame step for all 8 lanes, K4 on a step where a lane is global.
    reset_counts()
    t0 = time.perf_counter()
    _, scan_served = serve_streams(
        [iter(frames[o + 1 : o + 1 + n]) for o, n in zip(offsets, lengths)], starts,
        frames.shape[1:], config, backend="shared", chunk_size=chunk_size)
    scan_s = time.perf_counter() - t0
    scan_counts = counts()
    scan_glob = lockstep_global_steps(scan_served, lengths)
    expect_counts("serve_streams(shared)", K5=max(lengths), K4=scan_glob)
    for s_, (o, n) in enumerate(zip(offsets, lengths)):
        if scan_served[s_].bbox.shape[0] != n or stream_err_px(spec, o, scan_served[s_].bbox):
            raise AssertionError(f"serve_streams(shared) stream {s_}: off the ground truth or "
                                 f"{scan_served[s_].bbox.shape[0]} records for {n} frames")
        _, alone = track_stream(iter(frames[o + 1 : o + 1 + n]), unstack_state(starts, s_),
                                frames.shape[1:], config, backend="shared", chunk_size=chunk_size)
        compare_outputs(f"serve_streams(shared) stream {s_} vs track_stream(shared)",
                        scan_served[s_], alone)
    scan_fps, mega_serve_fps = total / scan_s, total / serve_s
    print(f"scan serving: serve_streams(backend=\"shared\") over phase 7's 8 streams, {total} "
          f"frames in {scan_s:.3f} s: serve_fps {scan_fps:.1f} against the mega path's "
          f"{mega_serve_fps:.1f} (phase 7); every stream 0 px and equal to its own "
          f"track_stream(shared); {scan_counts['K5']} K5 launches ({max(lengths)} lockstep "
          f"frame steps), {scan_counts['K4']} K4 ({scan_glob} global steps), no K1-K3; "
          f"{host_path}; on {smi}")
    # (b) K = 4 objects on phase 13's clip, one from outside the frame.
    reset_counts()
    _, ob_served = serve_objects(iter(oclip[1:]), init_multi_state(uni, urois), oclip.shape[1:],
                                 config, backend="shared", chunk_size=16)
    ob_counts = counts()
    expect_counts("serve_objects(shared) K=4", K5=of, K4=n_mglob)
    for k in range(4):
        compare_outputs(f"serve_objects(shared) object {k} vs track_video_multi(shared)",
                        StepOutput(*(v[:, k] for v in ob_served)),
                        StepOutput(*(v[:, k] for v in m_out)))
    if max_l1_err_px(spec, ob_served.bbox[:, 0]) != 0:
        raise AssertionError("serve_objects(shared): the target object is off the ground truth")
    print(f"scan serving objects: K=4 over phase 13's clip, {of} K5 launches and {n_mglob} K4 "
          f"(the object from outside), the target 0 px, every object equal to "
          f"track_video_multi(shared)")
    # (c) out of the envelope: 1080p at radius 300 (span 601) through
    # serve_streams(backend="mega"), which serves on the CUDA engine's K4
    # region path.
    wspecs = [SyntheticSpec(width=1920, height=1080, num_frames=2049, seed=s_) for s_ in (1, 2)]
    wclips = [np.stack(list(itertools.islice(generate_gray_frames(sp), 65))) for sp in wspecs]
    wconfig = TrackerConfig(search_radius_x=300, search_radius_y=300)
    if MegaGeometry((1080, 1920), (80, 80), wconfig).supported():
        raise AssertionError("span 601 lies inside the mega envelope")
    reset_counts()
    t0 = time.perf_counter()
    _, wide = serve_streams([iter(c[1:]) for c in wclips],
                            stack_states([state_at(sp, c, 0, dev) for sp, c in zip(wspecs, wclips)]),
                            (1080, 1920), wconfig, chunk_size=32)
    wide_s = time.perf_counter() - t0
    wide_counts = counts()
    wide_glob = lockstep_global_steps(wide, [64, 64])
    expect_counts("span 601 through backend=mega", K4=64 + wide_glob)
    if any(max_l1_err_px(sp, o.bbox) for sp, o in zip(wspecs, wide)):
        raise AssertionError("span 601: off the ground truth")
    print(f"out of the envelope: 2 streams at 1080p/80/r300 (span 601) through "
          f"serve_streams(backend=\"mega\"): no K1-K3, {wide_counts['K4']} K4 launches "
          f"({wide_glob} global steps), 0 px, {128 / wide_s:.1f} frames/s; "
          f"{host_path}")
    # (d) the same route from the command line, on --scan-backend shared.
    reset_counts()
    rc = serve_main(["--synthetic", "1280x720x2049", "--max-frames", "32", "--streams", "2",
                     "--search-radius", "300", "--scan-backend", "shared", "--chunk-size", "16",
                     "--device", "cuda"])
    cli_scan_counts = counts()
    if rc != 0 or cli_scan_counts["K4"] < 32 or any(
            cli_scan_counts[k] for k in ("K1", "K2", "K3", "K5")):
        raise AssertionError(f"pvot-torch-serve --scan-backend shared exited {rc}, launches "
                             f"{cli_scan_counts}")
    print(f"pvot-torch-serve --search-radius 300 --scan-backend shared: exit 0, "
          f"{cli_scan_counts['K4']} K4 launches and no other")
    # (e) mega_chunk_step: one K1 launch for phase 8's 64-frame chunk, its
    # rows and final template held to K1's plain version on those frames
    # (phase 8's k1_plain, which no mega_chunk_step code computed).
    reset_counts()
    rows64, final64 = mega_chunk_step(chunk, state, 64, config)
    step_k1 = counts()["K1"]
    expect_counts("mega_chunk_step", K1=1)
    compare("mega_chunk_step vs K1's plain version", (rows64, final64.template), k1_plain)
    print(f"mega_chunk_step: {step_k1} K1 launch, its 64 rows and final template held to K1's "
          f"plain version")
    # (f) pvot-torch --host over phase 10's clip: no kernel, the bbox of
    # track_stream(shared) (phase 10's pvot-torch --shared).
    n_host = 128
    traj_h = "build/chip_smoke_host_trajectory.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["--synthetic", f"1280x720x{n_main + 1}", "--max-frames", str(n_host),
                   "--first", "--roi", f"{cx},{cy},{cw},{ch}", "--host", "--no-display",
                   "--trajectory-out", traj_h])
    host_s = time.perf_counter() - t0
    expect_counts("pvot-torch --host")
    with open(traj_h) as f:
        host_boxes = np.array([json.loads(line)["bbox"] for line in f], np.int32)
    if (rc != 0 or host_boxes.shape != (n_host, 4)
            or not np.array_equal(host_boxes, cli_out.bbox[:n_host])):
        raise AssertionError(f"pvot-torch --host exited {rc}, or its boxes differ from "
                             "track_stream(shared)'s")
    host_ncc = "native C++ (libpvot)" if native.available() else "numpy"
    print(f"pvot-torch --host: {n_host} frames in {host_s:.3f} s, no kernel launched, bbox "
          f"equal to track_stream(shared)'s, host NCC {host_ncc} (the numpy host NCC took "
          f"27.891 s for these 128 frames on an NVIDIA H100 80GB HBM3 at 700.00 W)")
    print(f"phase 32: {time.perf_counter() - t_phase:.1f} s")

    # Phase 34 (before phase 33's line): the last modules.
    t_phase = time.perf_counter()
    # (a) The native library's build (phase 1 fails without it), and the
    # host engine on it.
    print(f"native host library: {json.dumps(native_build)}; pvot-torch --host "
          f"{host_s:.3f} s for {n_host} frames (phase 32 (f)) against 27.891 s on the numpy "
          f"host NCC")
    # (b) The flow baseline on the card over the bench clip's first 257 frames.
    from pvot_torch.models.flow import track_video_flow

    n_flow = 257
    fclip = frames[:n_flow]
    fbox = target_bbox(spec, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fstate, fboxes = track_video_flow(fclip, fbox, device=dev)
    flow_s = time.perf_counter() - t0
    if {t.device.type for t in fstate} != {"cuda"}:
        raise AssertionError(f"flow state on {[t.device for t in fstate]}, not all on the card")
    # The CPU witness tracks a prefix: the flow is causal, so its boxes are
    # the card run's first n_witness.
    n_witness = 32
    t0 = time.perf_counter()
    _, cpu_boxes = track_video_flow(fclip[: n_witness + 1], fbox, device="cpu")
    flow_cpu_s = time.perf_counter() - t0
    flow_diff = np.flatnonzero((fboxes[:n_witness] != cpu_boxes).any(axis=1))
    gt = np.array([target_bbox(spec, i)[:2] for i in range(1, n_flow)])
    flow_err = float(np.abs(fboxes[:, :2] - gt).sum(axis=1).mean())
    flow_fps = (n_flow - 1) / flow_s
    print(f"flow baseline: track_video_flow over {n_flow - 1} tracked frames of the bench clip "
          f"on the card in {flow_s:.3f} s: {flow_fps:.2f} frames/s against the main path's "
          f"{result['value']:.1f} (phase 6); mean box error {flow_err:.3f} px (|dx| + |dy| "
          f"against the ground truth); {len(flow_diff)} of the first {n_witness} frames differ from "
          f"the CPU's run of them ({flow_cpu_s:.1f} s); its state on the card; on {smi}")
    if len(flow_diff):
        i = int(flow_diff[0])
        raise AssertionError(f"flow: frame {i + 1} box {fboxes[i].tolist()} on the card, "
                             f"{cpu_boxes[i].tolist()} on the CPU")
    # (c) Search-sharded tracking: 2 gloo processes on this card, K4 on the
    # slabs and strips, against the unsharded engine.
    from pvot_torch.tools.dryrun_multichip import spawn

    _, g_pallas = track_video(gframes[1:], gstate, gconfig, backend="pallas")
    n_glob_p = int(g_pallas.used_global.sum())
    sharded, sharded_err = {}, {}
    for mesh_shape in ((1, 2), (2, 1)):
        t0 = time.perf_counter()
        ranks = spawn(2, sharded_rank, mesh_shape, "pallas", timeout=600)
        for r, got in enumerate(ranks):
            out = StepOutput(**got["out"])
            for s_ in range(mesh_shape[0]):
                compare_outputs(f"sharded {mesh_shape} rank {r} stream {s_} vs unsharded",
                                StepOutput(*(v[:, s_] for v in out)), g_pallas)
            want_k4 = len(g_pallas.bbox) + n_glob_p  # a slab launch a frame, a strip one
            if got["K4"] != want_k4 or got["K5"]:
                raise AssertionError(f"sharded {mesh_shape} rank {r}: {got['K4']} K4 launches "
                                     f"(expected {want_k4}) and {got['K5']} K5")
            if len(got["k4_err"]) != 2 or not max(got["k4_err"].values()) <= K4_ATOL:
                raise AssertionError(f"sharded {mesh_shape} rank {r}: K4 at the slab and strip "
                                     f"shapes, max |kernel - plain| {got['k4_err']} "
                                     f"(<= {K4_ATOL} at two shapes)")
        mesh_key = f"mesh_{mesh_shape[0]}x{mesh_shape[1]}"
        sharded[mesh_key] = [got["K4"] for got in ranks]
        sharded_err[mesh_key] = [got["k4_err"] for got in ranks]
        print(f"search-sharded tracking: mesh (data {mesh_shape[0]}, search {mesh_shape[1]}), "
              f"2 gloo processes on cuda:0, backend pallas, phase 11's clip ({len(g_pallas.bbox)} "
              f"frames, {n_glob_p} global): boxes and used_global equal to the unsharded "
              f"track_video(backend=\"pallas\"), scores under the contract; K4 launches by rank "
              f"{[got['K4'] for got in ranks]}, no K5; K4 at each rank's slab and strip shapes "
              f"(lanes x rows x cols) against its plain version, max |kernel - "
              f"plain| by rank {[got['k4_err'] for got in ranks]} (<= {K4_ATOL}); "
              f"{time.perf_counter() - t0:.1f} s with the processes' start")
    # (d) Serving across devices: two stream groups on this card.
    reset_counts()
    t0 = time.perf_counter()
    _, served2 = serve_streams([iter(frames[o + 1 : o + 1 + n]) for o, n in zip(offsets, lengths)],
                               starts, frames.shape[1:], config, chunk_size=chunk_size,
                               devices=["cuda:0", "cuda:0"])
    serve2_s = time.perf_counter() - t0
    multi_k2 = counts()["K2"]
    bit_equal, score_diff = True, 0.0
    for s_ in range(8):
        compare_outputs(f"serve_streams over 2 devices stream {s_} vs one device", served2[s_],
                        served[s_])
        bit_equal &= all(np.array_equal(a, b) for a, b in zip(served2[s_], served[s_]))
        score_diff = max(score_diff, float(np.abs(served2[s_].score - served[s_].score).max()))
    print(f"serving across devices: serve_streams(devices=[\"cuda:0\", \"cuda:0\"]) over phase "
          f"7's 8 streams, {total} frames in {serve2_s:.3f} s: serve_fps {total / serve2_s:.1f} "
          f"against {total / serve_s:.1f} on one device (phase 7); every stream equal to the "
          f"one-device serve (bit-equal: {bit_equal}, max |score diff| {score_diff:.3g}: K2's "
          f"float sums depend on the lanes in its launch); {multi_k2} K2 launches; "
          f"{host_path}; on {smi}")
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s")

    def tier_fields(tiers):
        return {f"{p}pass": v for p, v in tiers.items()}

    def ladder_fields(key):
        return {tier: {r: run["rungs"][r][key] for r in bd.RUNGS}
                for tier, run in ladder_runs.items()}

    # Phase 33.
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
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
            "conv2d_corr_ms": k1_conv,
            "ms_unit": "per tracked local frame, 720p/80/r60",
            "global_frame_ms": g_ms,
            "plain_global_frame_ms": g_plain_ms,
            "global_frame_bound_ms": g_bound,
            "frame_1080p_160_r160_local_ms": b_ms,
            "frame_1080p_160_r160_local_bound_ms": b_bound,
            "frame_1080p_160_global_ms": bg_ms,
            "frame_1080p_160_global_bound_ms": bg_bound,
            "tiers": tier_fields(k1_tiers),
            "tiers_unit": "ms per local frame (720p/80/r60) and per global frame, bound at the "
                          "bf16 tensor-core peak times passes",
            "main_path_fps_by_tier": fps_tiers,
            "launches_by_tier_main_path": launches_by_tier,
            "batch4_launches": want_launches,
            "batch4_frames": n_batch,
            "batch4_ms_per_frame": batch_ms,
            "batch4_bound_ms_per_frame": batch_bound,
            "batch4_bound_by": batch_by,
            "digests_equal_parent": True,
            "mega_chunk_step_launches": step_k1,
            "main_path_profiler_device_us_per_frame": prof_ms / n_main * 1e3,
            "main_path_profiler_records_by_session": [prof_first_records, prof_launches],
            "in_turns": turns,
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
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
            "ms_unit": "per frame step of 4 streams over the same 48 steps, 720p/80/r60",
            "s8_one_global_ms_per_step": k2_s8_global_ms,
            "s8_all_local_ms_per_step": k2_f32_s8,
            "s8_all_local_conv2d_corr_ms": k2_f32_s8_conv,
            "tiers": tier_fields(k2_tiers),
            "tiers_unit": "ms per frame step of 8 local streams, 720p/80/r60",
            "serve_1pass_fps": total / serve1_s,
            "serve_1pass_launches": serve_launches,
        },
        {
            "name": "mega_track_chunk_objects",
            "route": "cuda",
            "source": "pvot_torch/csrc/ncc_mega.cu",
            "replaces": "pvot/ops/ncc_mega.py:1246",
            "launches": k3_launches,
            "max_abs_err": k3_err,
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound,
            "bound_by": k3_by,
            "library_ms": None,
            "conv2d_corr_ms": k3_conv,
            "ms_unit": "per frame step of 8 objects, all local, over the same 48 steps, "
                       "720p/80/r60",
            "k4_one_global_ms_per_step": k4_ms["uniform"],
            "k4_one_global_plain_ms_per_step": k4_plain_ms["uniform"],
            "k4_one_global_bound_ms_per_step": k4_bound["uniform"],
            "k4_bucketed_ms_per_step": k4_ms["bucketed"],
            "k4_bucketed_plain_ms_per_step": k4_plain_ms["bucketed"],
            "k4_bucketed_bound_ms_per_step": k4_bound["bucketed"],
            "k3_1080p_bucket176_chunked_ms_per_step": k3_x_ms,
            "k3_1080p_bucket176_chunked_bound_ms_per_step": k3_x_bound,
            "k3_1080p_160_k8_resident_ms_per_step": k3_cell_ms,
            "k3_1080p_160_k8_resident_bound_ms_per_step": k3_cell_bound,
            "k8_one_global_ms_per_step": k3_g8_ms,
            "serve_objects_fps": n_serve / serve_o_s,
            "device_path_fps": dev_fps,
            "tiers": tier_fields(k3_tiers),
            "tiers_unit": "ms per frame step of 8 local objects, 720p/80/r60",
        },
        {
            "name": "ncc_map_pallas",
            "route": "cuda",
            "source": "pvot_torch/csrc/ncc_pallas.cu",
            "replaces": "pvot/ops/ncc_pallas.py:406",
            "launches": map_launches,
            "launches_path": "re-acquisition clip, 720p/80/r60 (the bench clip has no global "
                             "frame: 0 launches there)",
            "max_abs_err": map_err,
            "ms": k45_ms["k4_global_f32_ms"],
            "profiler_ms": map_ms,
            "call_ms": map_call_ms,
            "plain_ms": map_plain_ms,
            "bound_ms": map_bound,
            "bound_by": map_by,
            "library_ms": None,
            "conv2d_corr_ms": map_conv,
            "ms_unit": "per global frame (641x1201 map), 720p/80",
            "region_1080p_160_r160_ms": b_gated_ms,
            "region_1080p_160_r160_device_ms": k45_ms["k4_region_f32_ms"],
            "region_1080p_160_r160_profiler_ms": map_region_ms,
            "digests_equal_parent": True,
            "sharded_launches_by_rank": sharded,
            "sharded_max_abs_err_by_rank": sharded_err,
            "sharded_launches_path": "phase 11's re-acquisition clip through "
                                     "track_video_sharded(backend=\"pallas\"), 2 gloo ranks on "
                                     "one card, meshes (data 1, search 2) and (data 2, search 1)",
            "scan_serving_launches": {
                "serve_streams_shared_8_streams": scan_counts["K4"],
                "serve_objects_shared_k4": ob_counts["K4"],
                "span601_1080p_backend_mega": wide_counts["K4"],
                "cli_span601_720p_scan_backend_shared": cli_scan_counts["K4"]},
            "tiers": {"3pass": dict(max_abs_err=map3_err, ms=k45_ms["k4_region_3pass_ms"],
                                    profiler_ms=map3_ms, plain_ms=map3_plain,
                                    bound_ms=map3_bound, bound_by=map3_by,
                                    conv2d_corr_ms=None)},
            "tiers_unit": "ms per 321x321 region at 1080p/160/r160 (the pallas_fast region "
                          "path); full maps stay float32",
        },
        {
            "name": "ncc_region_argmax_pallas",
            "route": "cuda",
            "source": "pvot_torch/csrc/ncc_pallas.cu",
            "replaces": "pvot/ops/ncc_pallas.py:531",
            "launches": arg_launches,
            "max_abs_err": arg_err,
            "ms": k45_ms["k5_local_f32_ms"],
            "profiler_ms": arg_ms,
            "call_ms": arg_call_ms,
            "plain_ms": arg_plain_ms,
            "bound_ms": arg_bound,
            "bound_by": arg_by,
            "library_ms": None,
            "conv2d_corr_ms": arg_conv,
            "ms_unit": "per local frame (121x121 region), 720p/80/r60",
            "forced_1080p_160_r160_span321_ms": b_forced_ms,
            "main_path_fps": n_main / stream_s,
            "main_path_host_reads_per_frame": stream_reads,
            "device_frames_fps": n_main / engine_s,
            "mega_fps_same_clip": n_main / mega_s,
            "mega_host_reads_per_frame": mega_reads,
            "digests_equal_parent": True,
            "scan_serving_launches": {
                "serve_streams_shared_8_streams": scan_counts["K5"],
                "serve_objects_shared_k4": ob_counts["K5"]},
            "scan_serve_fps": scan_fps,
            "mega_serve_fps": mega_serve_fps,
            "region_step_ladder": steps,
            "region_step_ladder_in_turns": [(tree, b, res["rungs"], res["diffs"], res["k5"])
                                            for tree, b, res in step_runs],
            "tiers": {"3pass": dict(max_abs_err=arg3_err, ms=k45_ms["k5_local_3pass_ms"],
                                    profiler_ms=arg3_ms, call_ms=arg3_call,
                                    plain_ms=arg3_plain, bound_ms=arg3_bound, bound_by=arg3_by,
                                    conv2d_corr_ms=k1_bf16_conv,
                                    launches=fast_argmax_launches,
                                    main_path_fps=n_main / fast_s)},
            "tiers_unit": "ms per local frame (121x121 region), 720p/80/r60; launches and "
                          "frames/s on track_stream(pallas_fast) over the bench clip",
        },
        {
            "name": "mega_breakdown",
            "route": "cuda",
            "source": "pvot_torch/csrc/mega_breakdown.cu",
            "replaces": "tools/mega_breakdown.py:409",
            "launches": ladder_launches,
            "max_abs_err": ladder_err,
            "checksum_max_rel_err": ladder_rel,
            "ms": ladder_runs["highest"]["rungs"]["full"]["us_per_frame"] / 1e3,
            "plain_ms": ladder_plain_ms,
            "bound_ms": ladder_bounds["highest"][0],
            "bound_by": ladder_bounds["highest"][1],
            "library_ms": None,
            "ms_unit": "per local frame of the full rung (K1), 720p/80/r60, chunk 512, float32",
            "rungs_us_per_frame": ladder_fields("us_per_frame"),
            "rungs_kernel_us_per_frame": ladder_fields("kernel_us_per_frame"),
            "deltas_us_per_frame": {tier: run["deltas"] for tier, run in ladder_runs.items()},
            "production_us_per_frame": {tier: run["production"]
                                        for tier, run in ladder_runs.items()},
            "tiers_bound_ms": {tier: b[0] for tier, b in ladder_bounds.items()},
        },
        {
            "name": "global_strip_best",
            "route": "cuda",
            "source": "pvot_torch/csrc/strip_probe.cu",
            "replaces": "tools/global_strip_probe.py:227",
            "launches": strip_launches,
            "max_abs_err": strip_errs["strip_best"],
            "ms": strip_us / 1e3,
            "plain_ms": strip_plain_ms,
            "bound_ms": strip_bound,
            "bound_by": strip_by,
            "library_ms": None,
            "ms_unit": "per call on the probe's input, 2 frames (7 strips)",
        },
        {
            "name": "slab_refetch",
            "route": "cuda",
            "source": "pvot_torch/csrc/strip_probe.cu",
            "replaces": "tools/global_strip_probe.py:306",
            "launches": refetch_launches,
            "max_abs_err": strip_errs["slab_refetch"],
            "ms": refetch_us / 1e3,
            "plain_ms": refetch_plain_ms,
            "bound_ms": refetch_bound,
            "bound_by": refetch_by,
            "library_ms": None,
            "ms_unit": "per call on the probe's input, 2 frames",
        },
        {
            "name": "fused_argmax_probe",
            "route": "cuda",
            "source": "pvot_torch/csrc/argmax_probe.cu",
            "replaces": "tools/fused_argmax_probe.py",
            **t4,
            "products": products,
            "ms_unit": "one call of every probe, summed (each probe's in `probes`)",
        },
        {
            "name": "pallas_probe",
            "route": "cuda",
            "source": "pvot_torch/csrc/pallas_probe.cu, pvot_torch/csrc/argmax_probe.cu",
            "replaces": "tools/pallas_probe.py",
            **t5,
            "ms_unit": "one call of every probe, summed (each probe's in `probes`)",
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-tree"]:  # a child of phase 29: time the tree at argv[2]
        sys.path.insert(0, sys.argv[2])
        if sys.argv[4:5] == ["engine"]:
            from pvot_torch.io.synthetic import SyntheticSpec

            frames = np.load(sys.argv[3])
            spec = SyntheticSpec(width=1280, height=720, num_frames=frames.shape[0], target_w=80,
                                 target_h=80, seed=1)
            print(json.dumps({"engine_fps": engine_fps(torch.device("cuda", 0),
                                                       (spec, frames))}))
        else:
            print(json.dumps(time_tree(sys.argv[3], sys.argv[4:5] == ["digests"])))
        sys.exit(0)
    sys.exit(main())
