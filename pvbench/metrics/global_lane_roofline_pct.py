"""global_lane_roofline_pct: the least time the card could take for the work
one global lane adds to a lockstep step (pvbench/roofline.py `bound_ms`, the
float32 tier's FP32 peak or HBM's rate, whichever is larger) over
global_lane_us, the time it adds on the program's step clock.

The work, as roofline.scored_windows counts a frame: a global lane scores
its whole (H - th + 1) x (W - tw + 1) map where a local lane scores its
(2 rx + 1) x (2 ry + 1) window (the scene keeps every local window inside
the frame), th * tw FMA a position; so it adds th * tw * ((H - th + 1)(W -
tw + 1) - (2 rx + 1)(2 ry + 1)) FMA, and reads one frame, H * W bytes."""

from pvbench import harness, roofline

UNIT = "%"
LAYER = "chunk kernel: csrc/mega_body.cuh via ops/ncc_mega.py"
MOVES = "track_fps"

_local = harness.load_module("metrics", "local_step_us")
_global = harness.load_module("metrics", "global_lane_us")


def lane_work(rec) -> tuple:
    """(FMA, bytes) one global lane adds to a step of rec's geometry."""
    (h, w), (th, tw), (rx, ry) = rec.frame_shape, rec.templ_shape, rec.radii
    return th * tw * ((h - th + 1) * (w - tw + 1) - (2 * rx + 1) * (2 * ry + 1)), h * w


def read(run):
    recs = _local.steps(run)
    us = _global.lane_us(recs)
    if us is None or us <= 0:
        return None
    ms, _ = roofline.bound_ms(*lane_work(next(r for r in recs if r.global_lanes > 0)))
    return 100.0 * ms * 1e3 / us
