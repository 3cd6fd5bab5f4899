"""serve_host_us_per_chunk: the median, over the served chunks the profiler
sessions saw whole, of the serving loop's host time a chunk that is neither
the feed's nor a wait on the card: its `pvot.serve.copy`, `pvot.serve.step`
and `pvot.serve.drain` spans less `pvot.serve.wait` (io/serving.py)."""

from pvbench import spans

UNIT = "us"
LAYER = "serving: io/serving.py::_serve_mega"
MOVES = "track_fps"


def read(run):
    return spans.median([u["pvot.serve.copy"] + u["pvot.serve.step"] + u["pvot.serve.drain"]
                         - u["pvot.serve.wait"] for u in spans.units_us(spans.SERVE_CHUNK)])
