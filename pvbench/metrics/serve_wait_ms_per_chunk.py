"""serve_wait_ms_per_chunk: the median, over the served chunks the profiler
sessions saw whole, of the `pvot.serve.wait` span (io/serving.py): the time
the serving loop is blocked on the card before it drains a chunk's
records."""

from pvbench import spans

UNIT = "ms"
LAYER = "serving: io/serving.py::_serve_mega"
MOVES = "track_fps"


def read(run):
    us = spans.median([u["pvot.serve.wait"] for u in spans.units_us(spans.SERVE_CHUNK)])
    return None if us is None else us * 1e-3
