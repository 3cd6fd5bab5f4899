"""The traced span's reading: device work against the span, the breakdown,
and the refusal when the profiler's records and the launch counter differ."""

import pytest

from pvbench import trace


class _Event:
    def __init__(self, start, end, name, device, annotation=False):
        self.time_range = type("Interval", (), {"start": start, "end": end})()
        self.name = name
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.is_user_annotation = annotation


class _Session:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _tracer(events, launches):
    t = trace.Tracer(10.0, lambda: 0)
    t.state, t.prof, t.count = "done", _Session(events), launches
    return t


EVENTS = [
    _Event(0, 100, "pvbench.call", False, True),  # a host span
    _Event(10, 70, "pvbench.call", True, True),  # its device-side shadow: not work
    _Event(5, 20, "aten::copy_", False),
    _Event(30, 60, "cudaMemcpyAsync", False),
    _Event(10, 25, "chunk_kernel<false, false>", True),
    _Event(26, 28, "Memcpy DtoH (Device -> Pinned)", True),
    _Event(40, 70, "chunk_kernel<false, false>", True),
    _Event(80, 90, "reduce_kernel", True),  # after the last chunk kernel: outside the span
]


def test_read_span_busy_and_breakdown():
    r = trace.read(_tracer(EVENTS, (3, 5)))
    assert r["kernel_records"] == 2 and r["kernel_us"] == 45
    assert r["span_us"] == 60 and r["busy_us"] == 47
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == {"cudaMemcpyAsync": pytest.approx(12e-6), "pvbench.call": pytest.approx(1e-6)}
    assert [n for n, _ in r["breakdown"]["device_ops"]] == ["chunk_kernel<false, false>",
                                                           "Memcpy DtoH (Device -> Pinned)"]


def test_read_refuses_a_short_count():
    with pytest.raises(RuntimeError, match="launch counter"):
        trace.read(_tracer(EVENTS, (3, 6)))


def test_read_without_a_session():
    assert trace.read(trace.Tracer(10.0, lambda: 0)) is None
