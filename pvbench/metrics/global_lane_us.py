"""global_lane_us: what one whole-frame search adds to a lockstep step of the
multi-stream chunk kernel, from the program's step clock (local_step_us.py):
over the steps with a global lane, (the sum of their times less their count
times local_step_us) over the sum of their global lanes.  None where the
program keeps no step-clock records, or they hold no global step."""

from pvbench import harness

UNIT = "us"
LAYER = "chunk kernel: csrc/mega_body.cuh via ops/ncc_mega.py"
MOVES = "result_latency_p95_ms"

_local = harness.load_module("metrics", "local_step_us")


def lane_us(recs) -> float:
    base = _local.local_us(recs)
    glob = [r for r in recs if r.global_lanes > 0]
    if base is None or not glob:
        return None
    return (sum(r.ns * 1e-3 for r in glob) - len(glob) * base) / sum(r.global_lanes
                                                                      for r in glob)


def read(run):
    return lane_us(_local.steps(run))
