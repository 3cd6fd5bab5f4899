"""local_step_us: the median card time of the multi-stream chunk kernel's
lockstep frame steps in which no lane searched the whole frame, read from
the program's step clock (pvot_torch.utils.timing.step_clocks: block 0's
%globaltimer stamps around each step, one record a step with its count of
global lanes), over the traced span's calls.  The program keeps no such
records with the reference in its place, in an untraced run, or before it
had the clock: the reader then gives None."""

import statistics

UNIT = "us"
LAYER = "chunk kernel: csrc/mega_body.cuh via ops/ncc_mega.py"
MOVES = "track_fps"


def steps(run) -> list:
    """The step-clock records of the traced span's calls: the newest calls,
    whose chunk launches add up to the span's chunk kernels (the set-up's
    warm call, under a session of its own, comes before them).  [] where
    the program keeps no records, the run was not traced, or the records do
    not add up to the span's kernels."""
    from pvot_torch.utils import timing

    read = getattr(timing, "step_clocks", None)
    trace = getattr(run, "trace", None)
    if read is None or not trace:
        return []
    by = {}
    for r in read():
        by.setdefault(r.unit, []).append(r)
    kept, launches = [], 0
    for recs in reversed(list(by.values())):
        if launches >= trace["kernel_records"]:
            break
        launches += recs[0].launches
        kept = recs + kept
    return kept if launches == trace["kernel_records"] else []


def local_us(recs) -> float:
    """The median us of the steps with no global lane, or None."""
    local = [r.ns * 1e-3 for r in recs if r.global_lanes == 0]
    return float(statistics.median(local)) if local else None


def read(run):
    return local_us(steps(run))
