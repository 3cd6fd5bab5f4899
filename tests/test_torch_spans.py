"""Spans of the port's host layers (pvot_torch.utils.timing.span) and the
benchmark's readers of them: no record and no record_function without a
profiler session; nesting, units and frame counts under one; the spans each
entry emits; the per-layer readers; and the traced span's breakdown naming
idle gaps after the innermost `pvot.*` span."""

import contextlib
import itertools
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvbench import harness
from pvbench import trace as pvtrace
from pvbench.spans import SERVE_CHUNK
from pvbench.tests.test_pvbench_trace import _Event, _Session
from pvot_torch.config import TrackerConfig
from pvot_torch.io.serving import serve_objects
from pvot_torch.parallel.multi import init_multi_state
from pvot_torch.tracker.mega import track_objects_mega, track_streams_mega
from pvot_torch.utils import timing

CFG = TrackerConfig(search_radius_x=8, search_radius_y=8)
F, S, H, W, CHUNK = 6, 2, 64, 96, 4  # two chunks a call: one of 4 frames, one of 2
TRACK = ("pvot.track", "pvot.chunk", "pvot.restack", "pvot.read", "pvot.records")


@pytest.fixture(autouse=True)
def _no_spans():
    timing.reset_spans()
    yield
    timing.reset_spans()


def _videos():
    return np.random.default_rng(5).integers(0, 256, (S, F, H, W), dtype=np.uint8)


def _states(videos):
    tpls = [videos[s, 0, 20:36, 30:46].astype(np.float32) for s in range(S)]
    return init_multi_state(tpls, [(30, 20, 16, 16)] * S, device="cpu")


def _run(entry: str):
    v = _videos()
    st = _states(v)
    if entry == "track_streams_mega":
        track_streams_mega(v, st, CFG, chunk_size=CHUNK)
    elif entry == "track_objects_mega":
        track_objects_mega(v[0], st, CFG, chunk_size=CHUNK)
    else:
        serve_objects(iter(list(v[0])), st, (H, W), CFG, chunk_size=CHUNK)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _refuse(*_, **__):
    raise AssertionError("record_function entered with no profiler session on")


@pytest.mark.parametrize("case", ["bare", "nested", "track_streams_mega", "serve_objects"])
def test_no_profiler_no_record_no_record_function(monkeypatch, case):
    monkeypatch.setattr(timing, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    if case == "bare":
        assert timing.span("pvot.a") is timing.span("pvot.b", unit=3, frames=4, lanes=2)
        with timing.span("pvot.a") as sp:
            assert sp is None
    elif case == "nested":
        with timing.span("pvot.a", unit=1):
            with timing.span("pvot.b"):
                pass
    else:
        _run(case)
    assert timing.spans() == []


def test_spans_nest_under_a_profiler():
    with _cpu_profile() as prof:
        with timing.span("pvot.outer", unit=7, frames=12, lanes=3):
            with timing.span("pvot.mid"):
                with timing.span("pvot.inner", unit="other"):
                    torch.ones(4) + 1
            with timing.span("pvot.mid"):
                pass
        with timing.span("pvot.alone"):
            pass
    got = {}
    for r in timing.spans():
        got.setdefault(r.name, []).append(r)
    outer, = got["pvot.outer"]
    mids, (inner,), (alone,) = got["pvot.mid"], got["pvot.inner"], got["pvot.alone"]
    assert (outer.parent, outer.unit, outer.frames, outer.lanes) == (None, 7, 12, 3)
    assert [(m.parent, m.unit, m.frames) for m in mids] == [(outer.id, 7, None)] * 2
    assert (inner.parent, inner.unit) == (mids[0].id, "other")
    assert (alone.parent, alone.unit) == (None, None)
    assert outer.start_ns <= mids[0].start_ns <= inner.start_ns <= inner.end_ns
    assert inner.end_ns <= mids[0].end_ns <= mids[1].start_ns <= mids[1].end_ns <= outer.end_ns
    # Each span is a host-side user annotation on the profiler's timeline.
    marks = [e for e in prof.events() if e.name.startswith("pvot.")]
    assert sorted(e.name for e in marks) == sorted(
        ["pvot.outer", "pvot.mid", "pvot.mid", "pvot.inner", "pvot.alone"])
    assert all(e.is_user_annotation for e in marks)
    timing.reset_spans()
    assert timing.spans() == []


def test_span_stacks_are_per_thread(monkeypatch):
    """A span's parent is the innermost open span of its own thread (the
    serving groups run in threads)."""
    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(timing, "record_function", lambda name: contextlib.nullcontext())
    go = threading.Barrier(2, timeout=30)

    def work(i):
        with timing.span("pvot.top", unit=i):
            go.wait()
            with timing.span("pvot.child"):
                go.wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    tops = {r.id: r.unit for r in timing.spans() if r.name == "pvot.top"}
    children = [r for r in timing.spans() if r.name == "pvot.child"]
    assert len(tops) == 2 and len(children) == 2
    assert sorted((tops[c.parent], c.unit) for c in children) == [(0, 0), (1, 1)]


@pytest.mark.parametrize("entry", ["track_streams_mega", "track_objects_mega"])
def test_drivers_emit_one_unit_a_call(entry):
    with _cpu_profile():
        _run(entry)
        _run(entry)
    recs = timing.spans()
    assert {r.name for r in recs} == set(TRACK)
    units = sorted({r.unit for r in recs})
    assert len(units) == 2 and all(isinstance(u, int) for u in units)
    for u in units:
        names = [r.name for r in recs if r.unit == u]
        chunks = -(-F // CHUNK)
        assert sorted(names) == sorted(["pvot.track", "pvot.read", "pvot.records"]
                                       + ["pvot.chunk", "pvot.restack"] * chunks)
        top, = [r for r in recs if r.unit == u and r.name == "pvot.track"]
        assert (top.frames, top.lanes, top.parent) == (F, S, None)
        assert all(r.parent == top.id for r in recs if r.unit == u and r is not top)


def test_serve_objects_emits_one_unit_a_chunk():
    with _cpu_profile():
        _run("serve_objects")
    recs = timing.spans()
    serve, = [r for r in recs if r.name == "pvot.serve"]
    assert {r.name for r in recs} == set(SERVE_CHUNK) | {"pvot.serve", "pvot.chunk",
                                                         "pvot.restack", "pvot.records"}
    by_id = {r.id: r for r in recs}
    chunks = -(-F // CHUNK)
    for k in range(chunks):
        unit = [r for r in recs if r.unit == (serve.unit, k)]
        assert sorted(r.name for r in unit) == sorted(
            SERVE_CHUNK + ("pvot.chunk", "pvot.restack", "pvot.records"))
        parent = {r.name: by_id[r.parent].name for r in unit}
        assert parent == {"pvot.serve.fill": "pvot.serve", "pvot.serve.copy": "pvot.serve",
                          "pvot.serve.step": "pvot.serve", "pvot.serve.drain": "pvot.serve",
                          "pvot.serve.wait": "pvot.serve.drain",
                          "pvot.records": "pvot.serve.drain",
                          "pvot.chunk": "pvot.serve.step", "pvot.restack": "pvot.serve.step"}
        step, = [r for r in unit if r.name == "pvot.serve.step"]
        assert (step.frames, step.lanes) == (min(CHUNK, F - k * CHUNK), S)
    # The feed's end: one last fill that finds no frame, and nothing after it.
    tail = [r.name for r in recs if r.unit == (serve.unit, chunks)]
    assert tail == ["pvot.serve.fill"]


_ids = itertools.count(1)


def _span(name, unit, us):
    return timing.Span(next(_ids), name, unit, None, 0, int(us * 1e3), None, None)


SYNTHETIC = (
    # Three whole calls (track less read: 700, 600, 800) and one the session cut.
    [_span("pvot.track", u, t) for u, t in ((0, 1000), (1, 1000), (2, 900), (3, 500))]
    + [_span("pvot.read", u, t) for u, t in ((0, 300), (1, 400), (2, 100))]
    + [_span("pvot.chunk", u, t) for u, t in ((0, 100), (1, 300), (2, 200))]
    # Three whole chunks and one whose fill, copy and step came before the session.
    + [_span(n, (9, k), t) for k, ts in enumerate([(2000, 50, 400, 40000, 39500),
                                                    (1000, 60, 500, 41000, 40200),
                                                    (3000, 40, 300, 38000, 37500)])
       for n, t in zip(SERVE_CHUNK, ts)]
    + [_span("pvot.serve.drain", (9, 3), 30000), _span("pvot.serve.wait", (9, 3), 29000)]
)
EXPECTED = {
    "chunk_wrapper_us": 200.0,
    "driver_host_us_per_call": 700.0,
    "serve_host_us_per_chunk": 950.0,  # copy + step + drain - wait: 950, 1360, 840
    "serve_fill_ms_per_chunk": 2.0,
    "serve_wait_ms_per_chunk": 39.5,
}
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("records", ["synthetic", "empty", "no_spans_kept"])
@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers(monkeypatch, metric, records):
    entry, = [m for m in BENCH["per_layer"] if m["name"] == metric]
    reader = harness.load_module("metrics", metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"],
                                                         entry["moves"])
    assert entry["source"] == "host_clock"
    if records == "synthetic":
        monkeypatch.setattr(timing, "spans", lambda: list(SYNTHETIC))
        assert reader.read(None) == pytest.approx(EXPECTED[metric], rel=1e-9)
    else:
        if records == "no_spans_kept":  # a program without the span mechanism
            monkeypatch.delattr(timing, "spans")
        assert reader.read(None) is None


@pytest.mark.parametrize("read_at", [(32, 45), (36, 40)])
def test_trace_names_gaps_after_the_innermost_span(read_at):
    """An idle gap is put down to the innermost `pvot.*` host span running
    at its middle; a span's device-side shadow is no device work."""
    r0, r1 = read_at
    events = [
        _Event(0, 100, "pvbench.call", False, True),
        _Event(2, 98, "pvot.track", False, True),
        _Event(5, 30, "pvot.chunk", False, True),
        _Event(6, 9, "aten::cat", False),
        _Event(r0, r1, "pvot.read", False, True),
        _Event(10, 60, "pvot.chunk", True, True),  # the device-side shadow
        _Event(10, 25, "chunk_kernel<false, false>", True),
        _Event(27, 28, "Memcpy DtoD (Device -> Device)", True),
        _Event(50, 70, "chunk_kernel<false, false>", True),
    ]
    t = pvtrace.Tracer(10.0, lambda: 0)
    t.state, t.prof, t.count = "done", _Session(events), (0, 2)
    got = pvtrace.read(t)
    assert got["span_us"] == 60 and got["busy_us"] == 36  # 15 + 1 + 20
    gaps = dict(got["breakdown"]["idle_gaps"])
    # 25-27 falls in pvot.chunk; 28-50 (middle 39) in pvot.read, inside pvot.track.
    assert gaps == {"pvot.chunk": pytest.approx(2e-6), "pvot.read": pytest.approx(22e-6)}
    assert "pvot.chunk" not in dict(got["breakdown"]["device_ops"])
