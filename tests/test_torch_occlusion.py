"""Full occlusion on many streams (the benchmark cell streams16-720p-occl100):
the port's multi-stream chunk driver against the benchmark's plain reference
on the cell's CPU-size copy, where every stream loses its target and finds it
again by the whole-frame search; the step clock of the multi-stream chunk
kernel (pvot_torch.utils.timing.step_clocks) and the benchmark's readers of
it.

The card-marked tests run the kernel.  This file imports no JAX, so that on
the card's machine it runs without the test suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_occlusion.py
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pvot_torch.tracker.mega as mega
from pvbench import harness, port, roofline
from pvbench.reference import tracker as ref
from pvbench.traffic import scene
from pvot_torch.config import TrackerConfig
from pvot_torch.ops.ncc_mega import mega_track_chunk_multi
from pvot_torch.tracker.mega import track_streams_mega
from pvot_torch.utils import timing

CELL = "streams16-720p-occl100"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
READERS = ("local_step_us", "global_lane_us", "global_lane_roofline_pct")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_records():
    timing.reset_spans()
    timing.reset_step_clocks()
    yield
    timing.reset_spans()
    timing.reset_step_clocks()


def _session():
    """A profiler session on the host: what turns spans and the clock on."""
    return profile(activities=[ProfilerActivity.CPU])


def _small():
    """The cell's CPU-size copy (its driver's `small`): 3 streams of 96 x 128,
    lost_frame_threshold 3, stream s hidden on frames 4 + 8s to 9 + 8s of 32."""
    cell = harness.load_cell(CELL, BENCH)
    return harness.load_module("drivers", cell.mix["driver"]).small(cell.config, cell.mix)


def _clips(config, mixes, seed, device, phase_step):
    """Clips (S, period, H, W) of mixes[s] and the boxes (period, S, 4) a
    correct tracker reports."""
    clips, truth = zip(*(scene.make_clip(config, mix, seed, s, s * phase_step, device)
                         for s, mix in enumerate(mixes)))
    return torch.stack(clips), np.stack([t[:, 0] for t in truth], axis=1)


def _start(clips, truth):
    """Reference lanes and the port's stacked state, every tracker started on
    its box in the clip's last frame."""
    per = clips.shape[1]
    lanes = [ref.initial_lane(clips[s, per - 1], truth[per - 1, s])
             for s in range(clips.shape[0])]
    states = port.init_states(torch.stack([ln.template for ln in lanes]), truth[per - 1],
                              clips.device)
    return lanes, states


def test_k2_plain_version_matches_the_reference_through_occlusion():
    config, mix = _small()
    clips, truth = _clips(config, [mix] * mix["streams"], 987_654_321_098, CPU,
                          mix["phase_step"])
    lanes, states = _start(clips, truth)
    p = ref.Params.from_config(config)
    n = clips.shape[1]
    final, out = track_streams_mega(clips, states, TrackerConfig(**config["tracker"]),
                                    chunk_size=mix["segment"])
    want = ref.track(lambda t: clips[:, t], n, lanes, p)
    got = port.records(out)
    assert np.array_equal(got[..., [0, 1, 2, 3, 5, 6]], want[..., [0, 1, 2, 3, 5, 6]])
    limit = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")["limits"]
    assert np.abs(got[..., 4] - want[..., 4]).max() < limit["score_gap"]
    assert out.used_global.any(axis=0).all()  # every stream searched the whole frame
    assert np.array_equal(out.bbox, truth[:n])  # the path, or the held box while hidden
    for s, ln in enumerate(lanes):
        assert torch.equal(final.template[s], ln.template)
        assert (int(final.lost_count[s]), bool(final.use_global[s])) == (ln.lost, ln.use_global)


def _clock(unit, steps_ns, global_lanes, lanes=16):
    """Step-clock records of one call at the cell's geometry, one step a
    frame: steps_ns[k] the interval of frame k."""
    stamps = np.concatenate([[1_000], 1_000 + np.cumsum(steps_ns)]).astype(np.int64)
    used = np.zeros((len(steps_ns), lanes), bool)
    for k, g in enumerate(global_lanes):
        used[k, :g] = True
    timing.add_step_clocks(unit, [(0, stamps)], used, 1, (720, 1280), (80, 80), (60, 60))


def _read(name, kernels=2):
    """A reader's value in a run whose traced span launched `kernels` chunk
    kernels (None: an untraced run)."""
    run = SimpleNamespace(trace=None if kernels is None else {"kernel_records": kernels})
    return harness.load_module("metrics", name).read(run)


def test_readers_split_the_steps_and_price_a_global_lane():
    assert [_read(m) for m in READERS] == [None] * 3  # no records
    # The set-up's warm call, under a session of its own, before the traced
    # span's two calls: left out.
    _clock(0, [90_000_000, 5_000_000], [0, 1])
    _clock(1, [200_000, 700_000, 1_200_000, 210_000, 190_000], [0, 1, 2, 0, 0])
    _clock(2, [205_000, 700_000], [0, 1])
    assert [_read(m, None) for m in READERS] == [None] * 3  # untraced
    assert [_read(m, 4) for m in READERS] == [None] * 3  # more kernels than calls
    assert _read("local_step_us") == 202.5  # the median of 200, 210, 190, 205 us
    lane = ((700 + 1_200 + 700) - 3 * 202.5) / (1 + 2 + 1)
    assert _read("global_lane_us") == pytest.approx(lane, rel=1e-12)
    # 80 x 80 at 720p, radius 60: the whole 641 x 1201 map less the 121 x 121
    # window, 2 FLOP a multiply-add at 67 TFLOP/s; one 1280 x 720 frame at
    # 3.35 TB/s is far less.
    fma = 80 * 80 * (641 * 1201 - 121 * 121)
    assert fma == 4_833_280_000
    bound_us = 2 * fma / 67e12 * 1e6
    assert _read("global_lane_roofline_pct") == pytest.approx(100 * bound_us / lane,
                                                             rel=1e-12)
    assert roofline.bound_ms(fma, 1280 * 720)[1] == "operations"


def test_readers_without_a_global_step():
    _clock(1, [200_000, 210_000, 190_000], [0, 0, 0])
    assert _read("local_step_us", 1) == 200.0
    assert _read("global_lane_us", 1) is None
    assert _read("global_lane_roofline_pct", 1) is None
    timing.reset_step_clocks()
    _clock(1, [700_000, 710_000], [1, 1])  # no local step to subtract
    assert [_read(m, 1) for m in READERS] == [None] * 3


def test_readers_count_a_call_by_its_launches():
    """A call of two chunks is two of the span's kernels."""
    stamps = [np.array([0, 200_000, 900_000]), np.array([900_000, 1_100_000, 1_300_000])]
    used = np.zeros((4, 16), bool)
    used[1, 0] = True
    timing.add_step_clocks(7, list(zip((0, 2), stamps)), used, 1, (720, 1280), (80, 80),
                           (60, 60))
    assert {r.launches for r in timing.step_clocks()} == {2}
    assert _read("local_step_us", 1) is None  # the call is not the span's one kernel
    assert _read("local_step_us", 2) == 200.0
    assert _read("global_lane_us", 2) == 500.0


def test_clock_buffer_only_under_a_session_on_a_card():
    assert timing.clock_buffer(5, CPU) is None
    with _session():
        assert timing.clock_buffer(5, CPU) is None  # the plain versions stamp nothing
    assert timing.clock_buffer(5, torch.device("cuda", 0)) is None


def _fake_clock(monkeypatch):
    """A clock on the CPU: buffers under a session, as on a card, and a
    wrapper that stamps 1 us a lane a step plus 5 us a global lane after its
    plain version ran."""
    monkeypatch.setattr(
        timing, "clock_buffer",
        lambda n, device: (torch.empty(n, dtype=torch.int64)
                           if torch.autograd._profiler_enabled() else None))

    def wrapper(*args, clock=None, **kw):
        rows, tpl = mega_track_chunk_multi(*args, **kw)
        if clock is not None:
            batch = args[11]  # step k scores frame k * batch + batch - 1
            g = (rows[:, batch - 1 :: batch, 9] != 0).sum(0).to(torch.int64)
            cost = rows.shape[0] * 1_000 + 5_000 * g
            clock.copy_(torch.cat([torch.tensor([7]), 7 + torch.cumsum(cost, 0)]))
        return rows, tpl

    monkeypatch.setattr(mega, "mega_track_chunk_multi", wrapper)


def test_clock_records_under_a_session_tied_to_the_call(monkeypatch):
    _fake_clock(monkeypatch)
    config, mix = _small()
    clips, truth = _clips(config, [mix] * mix["streams"], 5, CPU, mix["phase_step"])
    cfg = TrackerConfig(**config["tracker"])
    _, states = _start(clips, truth)
    track_streams_mega(clips[:, :12], states, cfg, chunk_size=8)
    assert timing.step_clocks() == []  # no session, no buffer, no record
    with _session():
        _, out = track_streams_mega(clips[:, :12], states, cfg, chunk_size=8)
    recs = timing.step_clocks()
    unit, = {r.unit for r in timing.spans() if r.name == "pvot.track"}
    assert [(r.unit, r.step, r.steps, r.launches, r.frame) for r in recs] == [
        (unit, k, 12, 2, k) for k in range(12)]  # two chunks, 8 and 4 frames, end to end
    g = out.used_global.sum(axis=1)
    assert g.any() and [r.global_lanes for r in recs] == g.tolist()
    assert [r.ns for r in recs] == (3 * 1_000 + 5_000 * g).tolist()
    r = recs[0]
    assert (r.lanes, r.frame_shape, r.templ_shape, r.radii) == (3, (96, 128), (16, 16), (8, 8))
    timing.reset_step_clocks()
    assert timing.step_clocks() == []


def test_clock_records_follow_the_cadence(monkeypatch):
    """With batch 2, step k of a chunk scores its frame 2k + 1."""
    _fake_clock(monkeypatch)
    config, mix = _small()
    clips, truth = _clips(config, [mix] * mix["streams"], 5, CPU, mix["phase_step"])
    _, states = _start(clips, truth)
    with _session():
        track_streams_mega(clips[:, :12], states, TrackerConfig(**config["tracker"]),
                           chunk_size=8, batch=2)
    assert [(r.step, r.frame) for r in timing.step_clocks()] == [
        (0, 1), (1, 3), (2, 5), (3, 7), (4, 9), (5, 11)]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chunk kernel and its clock have no CPU form)")
    return torch.device("cuda", 0)


def _on_card(size: str, dev, hide_one: bool = False):
    """(clips, truth, config) of an occluded streams mix on the card: the
    cell's CPU-size copy ("small"), or 16 streams of the cell's 1280 x 720 /
    80 x 80 / radius 60 over a period of 128, lost_frame_threshold 3 (every
    stream hidden for 12 frames, or with hide_one only stream 0, on frames
    20-29)."""
    config, mix = _small()
    if size == "720p":
        cell = harness.load_cell(CELL, BENCH)
        config = dict(cell.config, tracker=dict(cell.config["tracker"], lost_frame_threshold=3))
        mix = dict(cell.mix, period=128, phase_step=8,
                   occlusion={"first": 10, "step": 6, "hidden": 12})
    mixes = [mix] * mix["streams"]
    if hide_one:
        plain = {k: v for k, v in mix.items() if k != "occlusion"}
        mixes = [dict(mix, occlusion={"first": 20, "step": 0, "hidden": 10})] + [plain] * (
            mix["streams"] - 1)
    clips, truth = _clips(config, mixes, 2_147_483_659, dev, mix["phase_step"])
    return clips, truth, config


def _track(clips, truth, config, clocked: bool):
    _, states = _start(clips, truth)
    cfg = TrackerConfig(**config["tracker"])
    if not clocked:
        return track_streams_mega(clips, states, cfg, chunk_size=64)
    with _session():
        return track_streams_mega(clips, states, cfg, chunk_size=64)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "720p"])
def test_clock_leaves_the_records_bit_equal(cuda_device, size):
    clips, truth, config = _on_card(size, cuda_device)
    off_state, off = _track(clips, truth, config, False)
    assert timing.step_clocks() == []
    on_state, on = _track(clips, truth, config, True)
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    for a, b in zip(off_state, on_state):
        assert torch.equal(a, b)
    assert on.used_global.any(axis=0).all()
    n = clips.shape[1]
    recs = timing.step_clocks()
    # n + 1 stamps a chunk, increasing: one positive interval a frame.
    assert [(r.step, r.frame) for r in recs] == [(k, k) for k in range(n)]
    assert all(r.ns > 0 and r.steps == n and r.lanes == clips.shape[0] for r in recs)
    assert [r.global_lanes for r in recs] == on.used_global.sum(axis=1).tolist()


@pytest.mark.cuda
def test_global_interval_lies_where_the_alignment_puts_it(cuda_device):
    """Stream 0 alone loses its target (hidden on frames 20-29, lost from
    frame 23 on) and searches the whole 720p frame until frame 30 finds it:
    the long intervals are those of its global frames, no earlier or later."""
    clips, truth, config = _on_card("720p", cuda_device, hide_one=True)
    _track(clips, truth, config, True)  # warm
    timing.reset_step_clocks()
    _, out = _track(clips, truth, config, True)
    glob = np.flatnonzero(out.used_global.any(axis=1))
    assert glob.tolist() == list(range(23, 31)) and not out.used_global[:, 1:].any()
    ns = np.array([r.ns for r in timing.step_clocks()])
    local = np.median(np.delete(ns, glob))
    assert np.flatnonzero(ns > 1.8 * local).tolist() == glob.tolist()


@pytest.mark.cuda
def test_cell_traced_run_reads_the_clock_and_its_bound_matches(cuda_device):
    """The cell at its own size, traced: correct, the three readers print,
    the global lane's share stays under its roofline, and the bound summed
    from the clock records (local lanes' whole windows, global lanes' whole
    maps) is the harness's bound of the same units to 0.5 %."""
    cell = harness.load_cell(CELL, BENCH)
    lines = []
    r = harness.run_cell(cell, BENCH, 3_000_000_019, 4.0, True, cuda_device,
                         time.perf_counter(), out=lines.append)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert all(m.get(k) is not None for k in READERS), m
    assert 0 < m["global_lane_roofline_pct"] < 100
    traced = next(s for s in lines if s.startswith("pvbench: traced span:")).split()
    n_kernels, harness_ms = int(traced[3]), float(traced[traced.index("bound") + 1])
    # The calls the readers take: those of the traced span, not the warm call.
    recs = harness.load_module("metrics", "local_step_us").steps(
        SimpleNamespace(trace={"kernel_records": n_kernels}))
    assert len({rec.unit for rec in recs}) == n_kernels
    (h, w), (th, tw), (rx, ry) = (720, 1280), (80, 80), (60, 60)
    fma = sum(th * tw * ((rec.lanes - rec.global_lanes) * (2 * rx + 1) * (2 * ry + 1)
                         + rec.global_lanes * (h - th + 1) * (w - tw + 1))
              for rec in recs)
    ours = roofline.bound_ms(fma, 0)[0]  # operations bound both counts
    print(f"bound from the clock records {ours:.6f} ms ({fma} FMA), the harness's "
          f"{harness_ms:.6f} ms, {n_kernels} calls")
    assert abs(ours - harness_ms) <= 0.005 * harness_ms
