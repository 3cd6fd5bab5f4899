"""result_latency_p95_ms: the 95th percentile, over every tracker-frame
completed in the window, of the time from its frame handed to the program
to its record readable on the host."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.latencies_ms, 95)) if len(run.latencies_ms) else None
