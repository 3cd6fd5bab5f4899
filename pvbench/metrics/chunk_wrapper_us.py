"""chunk_wrapper_us: the median host time of one chunk wrapper call, the
program's `pvot.chunk` span (ops/ncc_mega.py: the checks, the state's
packing, the buffers, the grid query, the C call and the launch counters),
over every call the profiler sessions saw."""

from pvbench import spans

UNIT = "us"
LAYER = "chunk wrappers: ops/ncc_mega.py"
MOVES = "track_fps"


def read(run):
    return spans.median(spans.durations_us("pvot.chunk"))
