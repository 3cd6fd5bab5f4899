"""result_latency_p50_ms: the median of the same per-frame latencies as
result_latency_p95_ms (the traced run's window)."""

import numpy as np

UNIT = "ms"
LAYER = "entry: tracker/mega.py driver and io/serving.py"
MOVES = "result_latency_p95_ms"


def read(run):
    return float(np.median(run.latencies_ms)) if len(run.latencies_ms) else None
