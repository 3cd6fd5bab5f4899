"""Where do K1's per-frame microseconds go on the card?  The rung ladder.

The port of tools/mega_breakdown.py, which timed copies of the TPU mega
kernel with stages switched off at compile time.  Here a rung is K1's own
source (pvot_torch/csrc/mega_body.cuh) compiled with a stage parameter, so
the ladder measures the production kernel: the `full` rung is K1.  The rungs
are cumulative; each adds one stage of K1's persistent launch, whose blocks
walk the chunk's frames and meet at a grid barrier a frame:

  empty      the step's table (the walk bx + 1, by + (t & 1) in place of the
             commit; the lane's mode and window), each item's tile, the
             fold of a one-value record and the grid barrier — the floor of
             a step
  dma        + the window rows' u8 loads from global memory
  convert    + the u8 -> f32 convert and the shared-memory store
  score_box  + the template staging, the box sums and the normalisation,
             the correlation left out
  score      + the correlation (float32 FMAs, or the bf16 passes on the
             tensor cores) and the combine of tiles two blocks share
  argmax     + the block best and partials, their fold, and the deferred
             commit's gate and bbox/state commit, without the EMA
  full       + the template EMA and stats, in the staging: K1

Deltas between consecutive rungs attribute a frame's time to the stages.

`--case rows` runs the float32 row-chunk case instead: K1 at 1080p / 160 x
160 / r160 (a template too large to stage whole beside its tile, run by
chunk_kernel_rows under its shared-memory plan, `MegaGeometry.plan`), float32
only.  Every checksum is held to its plain version there (the window rungs'
through the plan's units), the `argmax` rung's boxes to its plain version's,
and the `full` rung's records to `mega_track_chunk`'s, bit for bit.
The JAX ladder's `roll` rung has no counterpart: the port addresses its
window in place, with no alignment roll, so the deltas run over the rungs
above.  Its floor-hunt rungs (`empty_const`, `empty_smem`, `empty_scratch`,
`empty4`, `empty8`, `full8`, `full_scratch`) tested hypotheses about the
TPU's sequential grid step; on the card that question is the launch floor,
which `empty` measures, so they have none either.  `prodkernel` and
`prodkernel_ikg` become the production line: `mega_track_chunk` timed in
the same process beside `full` (about 0 apart: the same code).

A rung before `argmax` writes its checksum in record field 4 (the header of
mega_body.cuh defines each); its plain version computes the same checksum,
exactly for the integer ones (`empty`, `dma`, `convert`, modulo 2^24) and
within CHECKSUM_RTOL for the float sums (`score_box`, `score`).  For `argmax`
and `full` the plain version is K1's, without the EMA for `argmax`.  The
JAX ladder has no global branch, so the entry point runs K1 with global
search off (`local_config`); the bench clip has no global frame either way.

    python -m pvot_torch.tools.mega_breakdown [--tier highest|1pass|2pass|3pass]
        [--case whole|rows] [--chunk 512] [--device cpu]

It tracks the bench clip (SyntheticSpec(1280, 720, chunk + 1, 80x80,
seed=1)) from its ground-truth box at radius 60 and prints one JSON line a
rung (`us_per_frame`: time per frame between CUDA events over 8
back-to-back chunk calls after a warm one, best of 3; `kernel_us_per_frame`:
the chunk kernel's device time a frame under torch.profiler over one more
call, so that the rest of `us_per_frame` is the card idle between chunks;
`chk`: the chunk's checksum sum), then the summary, then the production
line.  With `--device cpu` it runs the plain
versions and prints no time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops.ncc_mega import (
    _RES_TILE_H, MegaGeometry, _check_cuda_inputs, _frame_mode, _grid_blocks, _launch,
    chunk_launches, mega_track_chunk, mega_track_chunk_reference,
)
from pvot_torch.ops.ncc_reference import ncc_scores

RUNGS = ("empty", "dma", "convert", "score_box", "score", "argmax", "full")
INT_RUNGS = ("empty", "dma", "convert")  # exact integer checksums, modulo 2^24
# The float checksums (score_box, score) sum about 30,000 terms whose kernel
# and plain values differ by float32 rounding (the plain version sums the
# window moments in float64): a relative 1e-4 holds them with room.
CHECKSUM_RTOL = 1e-4
TIERS = {"highest": 0, "1pass": 1, "2pass": 2, "3pass": 3}
H100_SCORE_BLOCKS = 2 * 132  # a rung's grid on an H100: two blocks an SM
H100_ROW_BLOCKS = 132  # a row-chunk rung's: one block an SM
N_CALLS = 8  # back-to-back chunk calls a timed run
_MASK = (1 << 24) - 1
_TILE_H, _TILE_W = 8, 16
# The row-chunk case: 1080p, a 160 x 160 template, radius 160.
ROWS_FRAME, ROWS_TEMPLATE, ROWS_RADIUS = (1080, 1920), 160, 160


def tier_kw(tier: str) -> dict:
    """The highest / score_passes keywords of a tier name."""
    passes = TIERS[tier]
    return dict(highest=passes == 0, score_passes=passes or 3)


def local_config(config: TrackerConfig = None) -> TrackerConfig:
    """`config` (the defaults: radius 60) with global search off, as the JAX
    ladder, which has no global branch."""
    return dataclasses.replace(config or TrackerConfig(), enable_global_search=False)


def _state_args(state, n_frames: int) -> tuple:
    return (torch.stack(list(state.bbox)), state.template, state.t_mean, state.t_std,
            state.lost_count, state.use_global, n_frames)


def mega_breakdown_chunk(rung: str, frames_u8: torch.Tensor, state, config: TrackerConfig,
                         tier: str = "highest"):
    """One chunk (F, H, W) u8 through the rung `rung` from `state` (a
    TrackerState): (rows (F, 10), template), as `mega_track_chunk` returns
    them.  On a CUDA device: csrc/mega_breakdown.cu, one cooperative launch
    on the current stream (`chunk_launches`, as K1), no host
    synchronisation, `mega_breakdown_chunk.launches` grows by 1; a template
    that stages whole beside a tile (80 x 80 does) runs the main-path case
    at any tier, a larger one the float32 row-chunk case.  On the CPU: the
    plain version."""
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
    passes = TIERS[tier]
    if frames_u8.device.type == "cpu":
        return mega_breakdown_reference(rung, frames_u8, state, config, tier)
    bbox, template, t_mean, t_std, lost, useg, f = _state_args(state, frames_u8.shape[0])
    _check_cuda_inputs(frames_u8, 3, dict(bbox=bbox, template=template, t_mean=t_mean,
                                          t_std=t_std, lost_count=lost, use_global=useg))
    frames_u8 = frames_u8.contiguous()
    h, w = frames_u8.shape[1:]
    th, tw = template.shape
    if MegaGeometry((h, w), (th, tw), config).plan(1, passes).name not in ("whole", "resident"):
        raise ValueError(f"the row-chunk case ({th}x{tw}) has float32 rungs in the resident "
                         "plan only")
    from pvot_torch.ops import _build

    lib = _build.load_library()
    dev = frames_u8.device
    with torch.cuda.device(dev):
        out = _launch(
            lib, "one", frames_u8[None], bbox, template, t_mean, t_std, lost, useg, [f],
            config, torch.cuda.current_stream(dev).cuda_stream, passes=passes,
            rung=RUNGS.index(rung))
        _build.check(out.err, f"mega_breakdown_chunk({rung})")
        mega_breakdown_chunk.launches += chunk_launches(f)
    return out.rows[0], out.template[0, :, :tw].contiguous()


mega_breakdown_chunk.launches = 0


def _items(region, do_global: bool, n_blocks: int, th: int, plan: str = "whole"):
    """A step's items for a one-lane frame (csrc/mega_body.cuh chunk_body,
    kOne): (tile origins oy0, ox0, first and end template rows
    u0, u1), one per item; two items a tile, one half of the template rows
    each, when the launch has a block for each (never in the resident plan,
    whose tiles are _RES_TILE_H rows high)."""
    ry0, ry1, rx0, rx1 = region
    reg_h, reg_w = ry1 - ry0 + 1, rx1 - rx0 + 1
    if reg_h <= 0 or reg_w <= 0:
        return []
    tile_h = _RES_TILE_H if plan == "resident" else _TILE_H
    tiles_x = -(-reg_w // _TILE_W)
    n_tiles = -(-reg_h // tile_h) * tiles_x
    split = 2 if plan != "resident" and not do_global and 2 * n_tiles <= n_blocks else 1
    halves = [(0, th // 2), (th // 2, th)] if split == 2 else [(0, th)]
    return [(ry0 + (tile // tiles_x) * tile_h, rx0 + (tile % tiles_x) * _TILE_W, u0, u1)
            for tile in range(n_tiles) for u0, u1 in halves]


def _units(items, th: int, plan: str, stage_rows: int):
    """The window rows each item loads, one range [y0, y1) a unit: the
    item's rows (whole); chunks of stage_rows within each half (chunked);
    each template half with the tile's _RES_TILE_H - 1 more (resident)."""
    mid = th // 2
    out = []
    for oy0, ox0, u0, u1 in items:
        if plan == "whole":
            out.append((oy0 + u0, oy0 + u1 + _TILE_H - 1, ox0))
        elif plan == "resident":
            more = _RES_TILE_H - 1
            out += [(oy0, oy0 + mid + more, ox0), (oy0 + mid, oy0 + th + more, ox0)]
        else:
            a = u0
            while a < u1:
                b = min(a + stage_rows, mid if a < mid else th)
                out.append((oy0 + a, oy0 + b + _TILE_H - 1, ox0))
                a = b
    return out


def _integral(values: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((values.shape[0] + 1, values.shape[1] + 1), dtype=values.dtype,
                      device=values.device)
    out[1:, 1:] = values.cumsum(0).cumsum(1)
    return out


def _rect_sums(ii: torch.Tensor, y0, y1, x0, x1) -> torch.Tensor:
    """Sums over rows [y0, y1) x columns [x0, x1) (index tensors), clipped to
    the image, from its integral image."""
    y1 = y1.clamp(max=ii.shape[0] - 1)
    x1 = x1.clamp(max=ii.shape[1] - 1)
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def _checksum(rung: str, frame: torch.Tensor, region, do_global: bool, n_blocks: int,
              tpl: torch.Tensor, t_mean: torch.Tensor, t_std: torch.Tensor,
              sum_tc: torch.Tensor, passes: int, plan: str = "whole",
              stage_rows: int = 0) -> float:
    """The checksum of one frame at a rung before `argmax` (csrc/mega_body.cuh)."""
    th, tw = tpl.shape
    items = _items(region, do_global, n_blocks, th, plan)
    if not items:
        return 0.0
    oy0, ox0, u0, u1 = (torch.tensor(c, device=frame.device) for c in zip(*items))
    if rung == "empty":
        return float(int((oy0 + ox0).sum()) & _MASK)
    v32 = frame.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32,
                                                 device=frame.device)
    if rung in ("dma", "convert"):
        # Each unit loads its input rows (`_units`) and 16 + round_up4(tw)
        # columns from its tile's origin.
        vals = frame.to(torch.int64) if rung == "dma" else v32.view(torch.int32).to(torch.int64)
        in_wl = _TILE_W + -(-tw // 4) * 4
        y0, y1, x0 = (torch.tensor(c, device=frame.device)
                      for c in zip(*_units(items, th, plan, stage_rows)))
        s = _rect_sums(_integral(vals), y0, y1, x0, x0 + in_wl)
        return float(int(s.sum()) & _MASK)
    ry0, ry1, rx0, rx1 = region
    n = float(th * tw)
    if rung == "score":  # sum |score| over the window
        win = ensure_gray_f32(frame[ry0 : ry1 + th, rx0 : rx1 + tw])
        return float(ncc_scores(win, tpl - t_mean, t_std, sum_tc, n, passes).double().abs().sum())
    # score_box: sd + score with acc = 0 at each output of each item, over
    # the item's template rows (a half when two blocks share the tile).
    v = v32.double()
    ii, iq = _integral(v), _integral(v * v)
    ys = torch.arange(ry0, ry1 + 1, device=frame.device)[:, None]
    xs = torch.arange(rx0, rx1 + 1, device=frame.device)[None, :]
    t_den = float(t_std) + 1e-6
    total = 0.0
    for a, b in sorted({(int(a), int(b)) for a, b in zip(u0, u1)}):
        bs = _rect_sums(ii, ys + a, ys + b, xs, xs + tw)
        bq = _rect_sums(iq, ys + a, ys + b, xs, xs + tw)
        mean = bs / n
        sd = torch.sqrt(torch.clamp(bq / n - mean * mean, min=1e-6))
        total += float((sd - mean * float(sum_tc) / ((sd + 1e-6) * t_den * n)).sum())
    return total


def mega_breakdown_reference(rung: str, frames_u8: torch.Tensor, state, config: TrackerConfig,
                             tier: str = "highest"):
    """Plain version of `mega_breakdown_chunk`, (rows, template) on frames'
    device.  `full`: K1's plain version; `argmax`: the same without the
    template EMA (no frame is strong enough); a rung before them walks the
    state as the kernel does and computes each frame's checksum, in torch ops
    on the frames' device, for the rung's grid on that device (an H100's,
    two blocks an SM, for CPU frames), the template unchanged."""
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
    args = _state_args(state, frames_u8.shape[0])
    if rung in ("argmax", "full"):
        if rung == "argmax":
            config = dataclasses.replace(config, strong_confidence=math.inf)
        return mega_track_chunk_reference(frames_u8, *args, config, **tier_kw(tier))
    f, h, w = frames_u8.shape
    dev = frames_u8.device
    tpl = state.template.to(dev, torch.float32)
    th, tw = tpl.shape
    plan = MegaGeometry((h, w), (th, tw), config).plan(1, TIERS[tier])
    if dev.type == "cuda":
        from pvot_torch.ops import _build

        n_blocks = _grid_blocks(_build.load_library(), dev, th, tw, 1, False, TIERS[tier],
                                RUNGS.index(rung))
    else:
        n_blocks = H100_SCORE_BLOCKS if plan.name == "whole" else H100_ROW_BLOCKS
    t_mean, t_std = state.t_mean.to(dev, torch.float32), state.t_std.to(dev, torch.float32)
    sum_tc = torch.sum(tpl - t_mean)
    g = MegaGeometry((h, w), (th, tw), config)
    bx, by, bw, bh = (int(v) for v in args[0].tolist())
    lost, useg = int(state.lost_count), bool(state.use_global)
    rows = torch.zeros((f, 10), dtype=torch.float32)
    for t in range(f):
        _, do_global, region = _frame_mode(g, config, (bx, by, bw, bh), lost, useg, True)
        rows[t, 4] = _checksum(rung, frames_u8[t], region, do_global, n_blocks, tpl, t_mean,
                               t_std, sum_tc, TIERS[tier], plan.name, plan.stage_rows)
        bx, by = min(bx + 1, w - tw - 1), min(by + (t & 1), h - th - 1)
    return rows.to(dev), tpl.clone()


def checksums_agree(rung: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative difference of two rows' checksums (field 4), which
    must be equal for an integer rung and within CHECKSUM_RTOL for a float
    one; raises AssertionError otherwise."""
    a, b = got[:, 4].double().cpu(), want[:, 4].double().cpu()
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    if (rel != 0.0) if rung in INT_RUNGS else not rel <= CHECKSUM_RTOL:
        raise AssertionError(f"rung {rung}: checksums differ by {rel:.3g} relative: "
                             f"{a[:4].tolist()} vs {b[:4].tolist()}")
    return rel


def _best_us_per_frame(fn, n_frames: int) -> float:
    """Us a frame between CUDA events around N_CALLS back-to-back calls after
    a warm one, the best of 3."""
    fn()
    best = math.inf
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(N_CALLS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best / (N_CALLS * n_frames)


def device_us_per_frame(fn, n_frames: int, kernel: str = "chunk_kernel") -> float:
    """The device time a frame of the CUDA kernels whose name holds `kernel`
    (by default the chunk kernel) over one call of fn() under
    torch.profiler (0.0 where it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if kernel in e.key:
            out += us / n_frames
    return out


def ladder(tier: str = "highest", chunk: int = 512, device=None, clip=None) -> dict:
    """Run the ladder at one tier over `chunk` frames of the bench clip (or of
    `clip`, (spec, frames) as bench_clip makes it) and print its lines;
    returns {"rungs": {rung: line}, "deltas", "production"} (no times on the
    CPU)."""
    from pvot_torch.bench import bench_clip, state_at

    dev = torch.device(device or "cuda")
    config = local_config()
    spec, frames = clip or bench_clip(num_frames=chunk)
    frames = frames[: chunk + 1]
    state = state_at(spec, frames, 0, dev)
    staged = torch.from_numpy(frames[1:]).to(dev)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    result = {"rungs": {}, "deltas": {}, "production": None}
    for rung in RUNGS:
        rows = mega_breakdown_chunk(rung, staged, state, config, tier)[0]
        line = {"chk": float(rows[:, 4].double().sum())}
        if dev.type == "cuda":
            def call():
                return mega_breakdown_chunk(rung, staged, state, config, tier)

            line["us_per_frame"] = _best_us_per_frame(call, chunk)
            line["kernel_us_per_frame"] = device_us_per_frame(call, chunk)
        result["rungs"][rung] = line
        print(json.dumps({rung: line}))
    if dev.type == "cuda":
        prev = 0.0
        for rung in RUNGS:
            result["deltas"][rung] = result["rungs"][rung]["us_per_frame"] - prev
            prev = result["rungs"][rung]["us_per_frame"]
    print(json.dumps({"tier": tier, "mega_breakdown": {
        r: v.get("us_per_frame") for r, v in result["rungs"].items()},
        "deltas": result["deltas"] or None, "n_calls": N_CALLS, "chunk": chunk,
        "device": name}))
    if dev.type == "cuda":
        args = (staged, *_state_args(state, chunk), config)
        prod = _best_us_per_frame(lambda: mega_track_chunk(*args, **tier_kw(tier)), chunk)
        result["production"] = prod
        print(json.dumps({"tier": tier, "production": {"mega_track_chunk": prod},
                        "vs_full_rung": {"mega_track_chunk":
                                         prod - result["rungs"]["full"]["us_per_frame"]},
                        "device": name}))
    return result


def rows_clip(chunk: int):
    """The row-chunk case's clip: (spec, frames), SyntheticSpec(1920, 1080,
    chunk + 1, a 160 x 160 target, seed=3)."""
    from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video

    h, w = ROWS_FRAME
    spec = SyntheticSpec(width=w, height=h, num_frames=chunk + 1, target_w=ROWS_TEMPLATE,
                         target_h=ROWS_TEMPLATE, seed=3)
    return spec, generate_gray_video(spec)


def rows_ladder(chunk: int = 48, device=None) -> dict:
    """The row-chunk case's ladder (float32) over `chunk` frames of
    `rows_clip`, K1 tracking from the ground-truth box at radius 160 with
    global search off: one JSON line a rung, each held to its plain version
    (`checked`: the checksums' relative difference, "boxes equal" for the
    `argmax` rung, "bit-equal" for the `full` rung's records against
    `mega_track_chunk`), then the deltas;
    returns {"plan", "rungs", "deltas"} (no times on the CPU)."""
    from pvot_torch.bench import state_at

    dev = torch.device(device or "cuda")
    config = local_config(TrackerConfig(search_radius_x=ROWS_RADIUS, search_radius_y=ROWS_RADIUS))
    spec, frames = rows_clip(chunk)
    state = state_at(spec, frames, 0, dev)
    staged = torch.from_numpy(frames[1:]).to(dev)
    plan = MegaGeometry(frames.shape[1:], (ROWS_TEMPLATE, ROWS_TEMPLATE), config).plan()
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    result = {"plan": plan.name, "rungs": {}, "deltas": {}}
    for rung in RUNGS:
        rows = mega_breakdown_chunk(rung, staged, state, config)[0]
        if rung == "full":
            want = mega_track_chunk(staged, *_state_args(state, chunk), config)[0]
            if not torch.equal(rows.cpu(), want.cpu()):
                raise AssertionError("rows ladder: the full rung's records differ from K1's")
            checked = "bit-equal"
        elif rung == "argmax":
            want = mega_breakdown_reference(rung, staged, state, config)[0].cpu()
            if not torch.equal(rows.cpu()[:, [0, 1, 2, 3, 5]], want[:, [0, 1, 2, 3, 5]]):
                raise AssertionError("rows ladder: the argmax rung's boxes differ from plain")
            checked = "boxes equal"
        else:
            checked = checksums_agree(rung, rows, mega_breakdown_reference(rung, staged, state,
                                                                           config)[0])
        line = {"chk": float(rows[:, 4].double().sum()), "checked": checked}
        if dev.type == "cuda":
            def call():
                return mega_breakdown_chunk(rung, staged, state, config)

            line["us_per_frame"] = _best_us_per_frame(call, chunk)
            line["kernel_us_per_frame"] = device_us_per_frame(call, chunk)
        result["rungs"][rung] = line
        print(json.dumps({"rows": rung, **line}))
    if dev.type == "cuda":
        prev = 0.0
        for rung in RUNGS:
            result["deltas"][rung] = result["rungs"][rung]["kernel_us_per_frame"] - prev
            prev = result["rungs"][rung]["kernel_us_per_frame"]
    print(json.dumps({"case": "rows", "plan": plan.name, "mega_breakdown": {
        r: v.get("kernel_us_per_frame") for r, v in result["rungs"].items()},
        "deltas": result["deltas"] or None, "chunk": chunk, "device": name}))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tier", default="highest", choices=list(TIERS))
    ap.add_argument("--case", default="whole", choices=("whole", "rows"),
                    help="K1's main-path case (720p, 80x80) or its float32 row-chunk case "
                         "(1080p, 160x160, r160)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="frames a chunk (default 512 for whole, 48 for rows)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions, no time)")
    args = ap.parse_args(argv)
    if (args.device or "cuda").startswith("cuda") and not torch.cuda.is_available():
        print("mega_breakdown: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    if args.device is None or args.device.startswith("cuda"):
        from pvot_torch.bench import gpu_identity

        print(f"gpu: {gpu_identity()[0]}")
    if args.case == "rows":
        if args.tier != "highest":
            ap.error("the row-chunk case is float32 only")
        rows_ladder(args.chunk or 48, args.device)
    else:
        ladder(args.tier, args.chunk or 512, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
