"""serve_fill_ms_per_chunk: the median, over the served chunks the profiler
sessions saw whole, of the `pvot.serve.fill` span (io/serving.py): the time
the serving loop waits for a chunk's frames from the feed."""

from pvbench import spans

UNIT = "ms"
LAYER = "serving: io/serving.py::_serve_mega"
MOVES = "result_latency_p95_ms"


def read(run):
    us = spans.median([u["pvot.serve.fill"] for u in spans.units_us(spans.SERVE_CHUNK)])
    return None if us is None else us * 1e-3
