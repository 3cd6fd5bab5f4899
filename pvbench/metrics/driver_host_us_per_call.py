"""driver_host_us_per_call: the median, over the chunk driver's calls the
profiler sessions saw whole, of the call's `pvot.track` span less its
`pvot.read` span (tracker/mega.py): the program's host work a call that is
not waiting on the card.  In a closed loop of calls the card waits on it."""

from pvbench import spans

UNIT = "us"
LAYER = "chunk drivers: tracker/mega.py"
MOVES = "track_fps"


def read(run):
    return spans.median([u["pvot.track"] - u["pvot.read"]
                         for u in spans.units_us(("pvot.track", "pvot.read"))])
