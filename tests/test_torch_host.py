"""The port's host engine and the last helpers of the JAX package's surface,
each held to its JAX original or to the port's device path on the CPU:

  pvot_torch.runtime.native  ncc_match, _ncc_numpy, template_stats_host
                             against pvot.runtime.native (bit for bit: the
                             same C++ source and the same numpy code);
  pvot_torch.models.host     track_video_host, track_stream_host and
                             HostTracker against pvot.models.host's, bit for
                             bit, and against the port's track_video (xla
                             engine), re-acquisition included;
  pvot-torch --host          end to end against the default mode, its
                             checkpoint resumed, --batch=N refused;
  mega_chunk_step            two chunks of the plain K1 against the port's
                             track_video (xla engine);
  ncc_map_opencv, ncc_map_batched, to_gray, device_gray_scale,
  device_bgr_to_gray_f32, load/save_cached_video, FpsCounter, StageTimer,
  profile_trace, display_downscale, and the CLI's GUI branch (frame preview,
  selectROI, live window) under a stubbed cv2, each against its JAX
  original.

Tolerances: trajectories under the tracker's equality contract (bbox,
updated and used_global exactly; accepted scores within 1e-5, all within
2e-3); NCC maps within 2e-6 of JAX's float32 oracle; integer and byte
outputs exactly.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot_torch.io.gray import gray_u8_to_f32
from pvot_torch.models.host import HostTracker, track_stream_host, track_video_host
from pvot_torch.tracker.state import StepOutput

SMALL = SyntheticSpec(width=320, height=240, num_frames=24, target_w=32, target_h=32, seed=7)
REENTER = SyntheticSpec(width=320, height=240, num_frames=60, target_w=32, target_h=32, seed=3,
                        exit_and_reenter=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got.bbox, want.bbox)
    np.testing.assert_array_equal(got.updated, want.updated)
    np.testing.assert_array_equal(got.used_global, want.used_global)
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], want.score[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, want.score, atol=2e-3)


def test_native_ncc_matches_jax_copy():
    """ncc_match (the C++ engine), its numpy twin and the template stats
    equal JAX's copies bit for bit, cached stats included."""
    import pvot.runtime.native as jnative
    from pvot_torch.runtime import native

    rng = np.random.default_rng(5)
    for fh, fw, th, tw in [(48, 64, 8, 8), (100, 120, 17, 13)]:
        frame = rng.random((fh, fw), np.float32)
        templ = rng.random((th, tw), np.float32)
        stats = native.template_stats_host(templ)
        assert stats == jnative.template_stats_host(templ)
        np.testing.assert_array_equal(native.ncc_match(frame, templ),
                                      jnative.ncc_match(frame, templ))
        np.testing.assert_array_equal(native.ncc_match(frame, templ, *stats),
                                      jnative.ncc_match(frame, templ, *stats))
        np.testing.assert_array_equal(native._ncc_numpy(frame, templ, *stats),
                                      jnative._ncc_numpy(frame, templ, *stats))
    with pytest.raises(ValueError, match="larger than frame"):
        native.ncc_match(frame[:8, :8], templ)


def _start(spec):
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    return frames, gray_u8_to_f32(frames[0])[y : y + h, x : x + w], (x, y, w, h)


@pytest.mark.parametrize("spec,lost", [(SMALL, 20), (REENTER, 5)], ids=["local", "reacquire"])
def test_host_engine_matches_track_video(spec, lost):
    """track_video_host, track_stream_host and HostTracker against the
    port's track_video on the CPU; the re-acquisition clip goes global."""
    frames, templ, roi = _start(spec)
    cfg = pvot_torch.TrackerConfig(lost_frame_threshold=lost)
    _, want = pvot_torch.track_video(frames[1:], pvot_torch.init_state(templ, roi, device="cpu"),
                                     cfg)
    final, host = track_video_host(frames[1:], templ, roi, cfg)
    _assert_outputs(StepOutput(**host), want)
    assert host["used_global"].any() == (spec is REENTER)
    timings: list = []
    sfinal, stream = track_stream_host(iter(frames[1:]), templ, roi, cfg, timings=timings)
    for k, v in host.items():
        np.testing.assert_array_equal(stream[k], v, err_msg=k)
    assert sfinal["bbox"] == final["bbox"] and len(timings) == len(frames) - 1
    tracker = HostTracker(frames[0], roi, cfg)
    steps = [tracker.update(f) for f in frames[1:]]
    assert [b for b, _ in steps] == [tuple(r) for r in host["bbox"].tolist()]
    assert tracker.bbox == final["bbox"]


def _assert_same_run(got, want):
    """Two (final, out) pairs of the host engine, bit for bit."""
    for k, v in want[1].items():
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    assert got[0].keys() == want[0].keys()
    for k, v in want[0].items():
        np.testing.assert_array_equal(np.asarray(got[0][k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("spec,lost", [(SMALL, 20), (REENTER, 5)], ids=["local", "reacquire"])
def test_host_engine_matches_jax_host(spec, lost):
    """track_video_host, track_stream_host and HostTracker (update, then
    track) against pvot.models.host's on the same clip: boxes, flags,
    scores and the final state bit for bit; the re-acquisition clip goes
    global."""
    from pvot.config import TrackerConfig as JaxConfig
    from pvot.models import host as jhost

    frames, templ, roi = _start(spec)
    cfg = pvot_torch.TrackerConfig(lost_frame_threshold=lost)
    jcfg = JaxConfig(lost_frame_threshold=lost)
    got = track_video_host(frames[1:], templ, roi, cfg)
    _assert_same_run(got, jhost.track_video_host(frames[1:], templ, roi, jcfg))
    assert got[1]["used_global"].any() == (spec is REENTER)
    _assert_same_run(track_stream_host(iter(frames[1:]), templ, roi, cfg),
                     jhost.track_stream_host(iter(frames[1:]), templ, roi, jcfg))
    tracker, jtracker = HostTracker(frames[0], roi, cfg), jhost.HostTracker(frames[0], roi, jcfg)
    half = len(frames) // 2
    assert ([tracker.update(f) for f in frames[1:half]]
            == [jtracker.update(f) for f in frames[1:half]])
    _assert_same_run(tracker.track(frames[half:]), jtracker.track(frames[half:]))
    assert tracker.bbox == jtracker.bbox


def _trajectory(path):
    import json

    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return StepOutput(np.array([r["bbox"] for r in recs], np.int32),
                      np.array([r["score"] for r in recs], np.float32),
                      np.array([r["used_global"] for r in recs]),
                      np.array([r["updated"] for r in recs]))


def test_cli_host_matches_default_mode(tmp_path, monkeypatch, capsys):
    """pvot-torch --host: headless, says which NCC ran, its trajectory and
    final template equal the default (xla) mode's; its checkpoint resumes
    under --host; --batch=N with --host exits 2."""
    from pvot_torch.cli.main import main
    from pvot_torch.convert import state_to_numpy
    from pvot_torch.utils.checkpoint import load_state

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    common = ["--synthetic", "320x240x14", "--first", "--roi", "144,104,32,32", "--device",
              "cpu", "--max-frames", "10"]
    assert main([*common, "--host", "--trajectory-out", "h.jsonl", "--checkpoint-out",
                 "h"]) == 0
    out = capsys.readouterr()
    assert "Tracking mode: host" in out.out and "Host NCC engine: " in out.err
    assert main([*common, "--trajectory-out", "d.jsonl", "--checkpoint-out", "d"]) == 0
    _assert_outputs(_trajectory("h.jsonl"), _trajectory("d.jsonl"))
    host_final = state_to_numpy(load_state("h.npz", device="cpu"))
    dev_final = state_to_numpy(load_state("d.npz", device="cpu"))
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        assert host_final[k] == dev_final[k], k
    np.testing.assert_allclose(host_final["template"], dev_final["template"], atol=1e-6)
    assert main(["--synthetic", "320x240x14", "--resume", "h.npz", "--host", "--device", "cpu",
                 "--max-frames", "3"]) == 0
    assert "Interactive tracking summary: frames=4" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main([*common, "--host", "--batch=2"])
    assert e.value.code == 2 and "no batch mode" in capsys.readouterr().err


def test_mega_chunk_step_matches_track_video():
    """Two chunks of K1's plain version through mega_chunk_step against the
    port's track_video (the xla engine, no K1 code) under the equality
    contract, the chunk-final state starting the next chunk; frames past
    n_valid commit nothing."""
    from pvot_torch.tracker.mega import _rows_to_output, mega_chunk_step

    frames, templ, roi = _start(SMALL)
    cfg = pvot_torch.TrackerConfig(search_radius_x=12, search_radius_y=12)
    state = pvot_torch.init_state(templ, roi, device="cpu")
    want_state, want = pvot_torch.track_video(frames[1:13], state, cfg)
    chunk = torch.from_numpy(frames[1:9])
    rows, mid = mega_chunk_step(chunk[:6], state, 6, cfg)
    rows2, final = mega_chunk_step(torch.from_numpy(frames[7:13]), mid, 6, cfg)
    _assert_outputs(_rows_to_output(torch.cat([rows, rows2]).numpy()), want)
    for field in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        assert int(getattr(final, field)) == int(getattr(want_state, field)), field
    np.testing.assert_allclose(final.template.numpy(), want_state.template.numpy(), atol=1e-6)
    short, part = mega_chunk_step(chunk, state, 6, cfg)
    np.testing.assert_array_equal(short[:6].numpy(), rows.numpy())
    for a, b in zip(part, mid):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ncc_oracles_match_jax():
    """ncc_map_opencv (the --cpu oracle) and ncc_map_batched against JAX's,
    on uint8 and float frames."""
    from pvot.ops import ncc_reference as jref
    from pvot_torch.ops import ncc_reference as tref

    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 40, 52), np.uint8)
    templ = rng.random((9, 7)).astype(np.float32)
    for frame in (frames[0], gray_u8_to_f32(frames[1])):
        np.testing.assert_allclose(
            tref.ncc_map_opencv(torch.from_numpy(frame), torch.from_numpy(templ)).numpy(),
            np.asarray(jref.ncc_map_opencv(jnp.asarray(frame), jnp.asarray(templ))), atol=2e-6)
    got = tref.ncc_map_batched(torch.from_numpy(frames), torch.from_numpy(templ)).numpy()
    want = np.asarray(jref.ncc_map_batched(jnp.asarray(frames), jnp.asarray(templ)))
    assert got.shape == want.shape == (3, 32, 46)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_gray_helpers_match_jax():
    """to_gray exactly; device_gray_scale exactly and device_bgr_to_gray_f32
    within one float32 rounding of JAX's, on the device named (numpy in) or
    the tensor's own."""
    from pvot.io import gray as jgray
    from pvot_torch.io import gray as tgray

    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (30, 41, 3), np.uint8)
    g = rng.integers(0, 256, (30, 41), np.uint8)
    np.testing.assert_array_equal(tgray.to_gray(bgr), jgray.to_gray(bgr))
    scaled = tgray.device_gray_scale(g, device="cpu")
    assert scaled.device.type == "cpu" and scaled.dtype == torch.float32
    np.testing.assert_array_equal(scaled.numpy(), np.asarray(jgray.device_gray_scale(
        jnp.asarray(g))))
    np.testing.assert_array_equal(tgray.device_gray_scale(torch.from_numpy(g)).numpy(),
                                  scaled.numpy())
    np.testing.assert_allclose(tgray.device_bgr_to_gray_f32(bgr, device="cpu").numpy(),
                               np.asarray(jgray.device_bgr_to_gray_f32(jnp.asarray(bgr))),
                               rtol=0, atol=1.2e-7)


def test_video_cache_round_trips_with_jax(tmp_path):
    """A cache written by either package loads in the other, frame for
    frame; gray frames gain a channel axis; a missing or truncated file
    loads as None."""
    from pvot.io import video as jvideo
    from pvot_torch.io import video as tvideo

    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 256, (3, 10, 14, 3), np.uint8)
    gray = rng.integers(0, 256, (2, 10, 14), np.uint8)
    tvideo.save_cached_video(str(tmp_path / "t.bin"), bgr)
    jvideo.save_cached_video(str(tmp_path / "j.bin"), gray)
    assert (tmp_path / "t.bin").read_bytes() == _jax_bytes(jvideo, tmp_path, bgr)
    np.testing.assert_array_equal(jvideo.load_cached_video(str(tmp_path / "t.bin")), bgr)
    np.testing.assert_array_equal(tvideo.load_cached_video(str(tmp_path / "j.bin")),
                                  gray[..., None])
    assert tvideo.load_cached_video(str(tmp_path / "missing.bin")) is None
    (tmp_path / "short.bin").write_bytes(b"\x01\x02")
    assert tvideo.load_cached_video(str(tmp_path / "short.bin")) is None


def _jax_bytes(jvideo, tmp_path, frames) -> bytes:
    jvideo.save_cached_video(str(tmp_path / "jb.bin"), frames)
    return (tmp_path / "jb.bin").read_bytes()


def _fake_clock(monkeypatch, *modules):
    """time.perf_counter in `modules` as a clock that moves 0.25 s a read."""
    ticks = iter(np.arange(1, 1000) * 0.25)

    class Clock:
        @staticmethod
        def perf_counter():
            return float(next(ticks))

    for m in modules:
        monkeypatch.setattr(m, "time", Clock)


def test_timers_match_jax(monkeypatch):
    """FpsCounter and StageTimer print what JAX's print on the same clock
    reads; a stage waits for the tensors it names; CPU tensors pass."""
    import pvot.utils.timing as jtiming
    import pvot_torch.utils.timing as ttiming

    texts = []
    for mod in (ttiming, jtiming):
        _fake_clock(monkeypatch, mod)
        c = mod.FpsCounter()
        rates = [c.tick(), c.tick(3)]
        t = mod.StageTimer()
        for name in ("decode", "track", "decode"):
            with t.stage(name):
                pass
        texts.append((rates, c.total_frames, c.summary("Recorded"), t.report(),
                      dict(t.counts)))
    assert texts[0] == texts[1]
    t = ttiming.StageTimer()
    with t.stage("step", block=(torch.ones(2), [torch.zeros(1)])):
        pass
    assert t.counts["step"] == 1


def test_profile_trace_writes_a_trace(tmp_path):
    from pvot_torch.utils.timing import profile_trace

    with profile_trace(str(tmp_path)):
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_display_downscale_matches_jax():
    from pvot.cli.main import display_downscale as jax_downscale
    from pvot_torch.cli.main import display_downscale

    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, (1080, 1920, 3), np.uint8)
    np.testing.assert_array_equal(display_downscale(big), jax_downscale(big))
    assert display_downscale(big).shape == (720, 1280, 3)
    ok = big[:480, :640]
    assert display_downscale(ok) is ok


class _StubCv2(types.ModuleType):
    """A cv2 module of the GUI calls alone: scripted waitKey keys and
    selectROI box; imshow records what it shows."""

    WINDOW_NORMAL = 0
    FONT_HERSHEY_SIMPLEX = 0

    def __init__(self, keys, roi):
        super().__init__("cv2")
        self.keys, self.roi, self.shown = list(keys), roi, []

    def namedWindow(self, *a, **k):
        pass

    def destroyWindow(self, *a, **k):
        pass

    def rectangle(self, *a, **k):
        pass

    def putText(self, *a, **k):
        pass

    def imshow(self, name, img):
        self.shown.append(img.copy())

    def waitKey(self, ms=0):
        return self.keys.pop(0) if self.keys else -1

    def selectROI(self, name, img, *a, **k):
        return self.roi


def _stub(monkeypatch, keys, roi=(10, 10, 24, 24)) -> _StubCv2:
    from pvot_torch.io import gray

    gray._cv2()  # the port's gray conversion keeps the real OpenCV (or none)
    cv2 = _StubCv2(keys, roi)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    monkeypatch.setenv("DISPLAY", ":0")
    return cv2


def _select(module, monkeypatch, keys, roi, extra):
    cli = __import__(module, fromlist=["_select_roi"])
    cv2 = _stub(monkeypatch, keys, roi)
    args = cli.parse_args(["--synthetic", "160x120x6", *extra])
    try:
        start, box, frame = cli._select_roi(args, cli.FrameSource(args))
        return ("ok", start, box, frame.tobytes(), len(cv2.shown))
    except SystemExit as e:
        return ("exit", e.code, len(cv2.shown))


@pytest.mark.parametrize("keys,roi,extra", [
    ([-1, -1, 13], (10, 10, 24, 24), []),  # ENTER on the third previewed frame
    ([-1, 27], (10, 10, 24, 24), []),  # ESC quits
    ([], (10, 10, 24, 24), []),  # the end of the clip without ENTER
    ([], (0, 0, 0, 0), ["--first"]),  # a cancelled selectROI
], ids=["enter", "esc", "end", "cancel"])
def test_gui_roi_selection_matches_jax(monkeypatch, capsys, keys, roi, extra):
    got = _select("pvot_torch.cli.main", monkeypatch, keys, roi, extra)
    port_io = capsys.readouterr()
    want = _select("pvot.cli.main", monkeypatch, keys, roi, extra)
    assert got == want and port_io == capsys.readouterr()


def test_headless_without_roi_exits_as_jax(tmp_path, monkeypatch, capsys):
    """No --roi and no DISPLAY (or --no-display): exit -1, "DISPLAY not
    set", as the JAX CLI."""
    from pvot_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    for extra in ([], ["--no-display"]):
        with pytest.raises(SystemExit) as e:
            main(["--synthetic", "160x120x4", "--device", "cpu", *extra])
        assert e.value.code == -1
        assert capsys.readouterr().err.startswith("DISPLAY not set")


def test_live_window_shows_every_tracked_frame(tmp_path, monkeypatch, capsys):
    """With a DISPLAY and no --record, every tracked frame plays in the live
    window, as the JAX CLI's tests/test_cli.py:446 counts them (the ENTER
    key is read by the window's waitKey and does not stop it)."""
    from pvot_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    cv2 = _stub(monkeypatch, keys=[13])
    assert main(["--synthetic", "320x240x8", "--roi", "144,104,32,32", "--chunk-size", "4",
                 "--device", "cpu"]) == 0
    assert len(cv2.shown) == 7
    assert "Interactive tracking summary: frames=8" in capsys.readouterr().out
