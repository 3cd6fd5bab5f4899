"""The program's own spans (pvot_torch.utils.timing.span), as the span
readers of pvbench/metrics/ take them.

The program keeps a span's record while a profiler session is on: here the
warm session and the traced span of a `--trace 1` run.  A session can start
or stop inside a unit of work (the objects cell's starts and stops inside a
serve call), so the readers take only units that hold every span they read,
and medians over those.  Where the program keeps no spans (a program without
`timing.spans`, or the reference in its place) every reader gives None."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

# The spans of one served chunk (io/serving.py::_serve_mega).
SERVE_CHUNK = ("pvot.serve.fill", "pvot.serve.copy", "pvot.serve.step", "pvot.serve.drain",
               "pvot.serve.wait")


def records() -> list:
    """The program's span records ([] where it keeps none)."""
    from pvot_torch.utils import timing

    read = getattr(timing, "spans", None)
    return list(read()) if read is not None else []


def _us(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-3


def durations_us(name: str) -> List[float]:
    """The duration of every span named `name`."""
    return [_us(r) for r in records() if r.name == name]


def units_us(names: Sequence[str]) -> List[Dict[str, float]]:
    """Each unit that holds a span of every name in `names`: {name: the
    summed duration of its spans of that name, us}."""
    by: Dict[object, Dict[str, float]] = {}
    for r in records():
        if r.unit is not None and r.name in names:
            u = by.setdefault(r.unit, {})
            u[r.name] = u.get(r.name, 0.0) + _us(r)
    return [u for u in by.values() if len(u) == len(set(names))]


def median(values: Sequence[float]) -> Optional[float]:
    return float(statistics.median(values)) if values else None
