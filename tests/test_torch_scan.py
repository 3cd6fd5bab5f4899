"""The port's per-frame engine path against the JAX package: track_video on
every engine and strategy, batch mode, the multi-object, multi-stream and
bucketed steps, NccTracker, track_stream and the pvot-torch CLI.

Oracles: pvot.tracker.scan.track_video with the same engine (`xla` and `cpu`
through pvot.ops.backends; `shared` as JAX's shear engine in interpret mode,
tests/jax_shear.py), pvot.tracker.scan.track_video_batched,
pvot.parallel.multi and pvot.models.ncc.NccTracker.  Every run starts from
the same numpy state (the JAX state, converted by state_from_numpy).  Clips,
from seeds with the synthetic generator: 160x120 frames, a 16x16 target on
the path of a 120-frame clip (about 3 px a frame), radius 12, lost threshold
3; "plain" tracks 16 frames, "reacq" 19 frames of a target that leaves the
frame for 4 of every 10 and is found again by global search.

Tolerances, the tracker's equality contract (pvot/tracker/mega.py
_outputs_equal): bbox, updated and used_global exactly; accepted scores
within 1e-5, all scores within 2e-3; final templates and stats within 1e-6.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_frames, target_bbox
from pvot.tracker.scan import track_video as jax_track_video
from pvot.tracker.scan import track_video_batched as jax_track_video_batched
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.convert import state_from_numpy, state_to_numpy
from tests.jax_shear import track_video_shear

KW = dict(search_radius_x=12, search_radius_y=12, lost_frame_threshold=3)
CLIPS = {
    "plain": (17, dict()),
    "reacq": (20, dict(occlusion_period=10, occlusion_len=4, occlusion_phase=3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def clips():
    """name -> (spec, frames (F+1, H, W) u8, JAX initial state)."""
    out = {}
    for name, (n, kw) in CLIPS.items():
        spec = SyntheticSpec(width=160, height=120, num_frames=120, target_w=16, target_h=16,
                             seed=5, **kw)
        frames = np.stack(list(itertools.islice(generate_gray_frames(spec), n)))
        x, y, w, h = target_bbox(spec, 0)
        st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
                            (x, y, w, h))
        out[name] = (spec, frames, st)
    return out


@pytest.fixture(scope="module")
def oracles(clips):
    """(clip, engine, strategy) -> (JAX final state as numpy, JAX out), on
    first use."""
    cache = {}

    def get(clip, engine, strategy):
        key = (clip, engine, strategy)
        if key not in cache:
            _, frames, st = clips[clip]
            if engine == "shared":
                js, jo = track_video_shear(frames[1:], st, JaxConfig(**KW), strategy,
                                           chunk_size=8)
            else:
                js, jo = jax_track_video(frames[1:], st, JaxConfig(**KW), strategy=strategy,
                                         backend=engine, chunk_size=8)
            cache[key] = (_np(js), jo)
        return cache[key]

    return get


def _assert_out(got, want):
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox))
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated))
    np.testing.assert_array_equal(got.used_global, np.asarray(want.used_global))
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3, rtol=0)


def _assert_state(got, want):
    got = state_to_numpy(got)
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("template", "t_mean", "t_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def _start(clips, clip):
    return state_from_numpy(_np(clips[clip][2]), device="cpu")


def test_reacq_clip_searches_globally(oracles):
    _, jo = oracles("reacq", "xla", "fused")
    glob, upd = np.asarray(jo.used_global), np.asarray(jo.updated)
    assert (glob & upd).any() and (glob & ~upd).any()
    assert not np.asarray(oracles("plain", "xla", "fused")[1].used_global).any()


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("strategy", ["fused", "full"])
@pytest.mark.parametrize("engine", ["xla", "shared", "cpu"])
def test_track_video_matches_jax(clips, oracles, clip, strategy, engine):
    want_state, want = oracles(clip, engine, strategy)
    got_state, got = pvot_torch.track_video(clips[clip][1][1:], _start(clips, clip),
                                            pvot_torch.TrackerConfig(**KW), strategy=strategy,
                                            backend=engine, chunk_size=5)
    _assert_out(got, want)
    _assert_state(got_state, want_state)


def test_mega_backend_routes_to_the_chunk_driver(clips, oracles):
    """backend="mega" with the fused strategy is track_video_mega (here its
    plain version); with "full" it runs the CUDA engine's step."""
    from pvot_torch.ops.ncc_mega import mega_track_chunk

    frames, cfg = clips["reacq"][1][1:], pvot_torch.TrackerConfig(**KW)
    _, want = pvot_torch.track_video_mega(frames, _start(clips, "reacq"), cfg, chunk_size=7)
    _, got = pvot_torch.track_video(frames, _start(clips, "reacq"), cfg, backend="mega",
                                    chunk_size=7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _, full = pvot_torch.track_video(frames, _start(clips, "reacq"), cfg, strategy="full",
                                     backend="mega")
    _assert_out(full, oracles("reacq", "shared", "full")[1])
    assert mega_track_chunk.launches == 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_batch_mode_matches_jax(clips, n):
    """19 frames: batches of 2, 4 and 8 leave 1, 3 and 3 leftover frames."""
    _, frames, st = clips["reacq"]
    js, jo = jax_track_video_batched(frames[1:], st, JaxConfig(**KW), batch_size=n,
                                     backend="xla")
    gs, go = pvot_torch.tracker.scan.track_video_batched(
        frames[1:], _start(clips, "reacq"), pvot_torch.TrackerConfig(**KW), batch_size=n,
        chunks_per_dispatch=2)
    assert go.bbox.shape == (19, 4)
    _assert_out(go, jo)
    _assert_state(gs, _np(js))
    assert (go.score[: n - 1] == -1.0).all() and not go.updated[19 - 19 % n :].any()


def test_batch_mode_on_the_cuda_engine_matches_shear(clips):
    from pvot.tracker.scan import make_batch_step

    from tests.jax_shear import shear_step

    _, frames, st = clips["reacq"]
    cfg = JaxConfig(**KW)
    step = make_batch_step(shear_step((120, 160), (16, 16), cfg), 4)
    import jax

    js, jo = jax.lax.scan(step, st, jnp.asarray(frames[1:17].reshape(4, 4, 120, 160)))
    gs, go = pvot_torch.tracker.scan.track_video_batched(
        frames[1:17], _start(clips, "reacq"), pvot_torch.TrackerConfig(**KW), batch_size=4,
        backend="shared")
    want = type(jo)(*(np.asarray(v).reshape(16, *np.shape(v)[2:]) for v in jo))
    _assert_out(go, want)
    _assert_state(gs, _np(js))


# --- Several lanes (pvot.parallel.multi).


def _objects(clips):
    """K = 3 objects on the reacq clip: the target, the target's template
    started outside the frame, and a static textured patch stamped below the
    target's path (a patch of the smooth background would be a window whose
    variance cancels in float32)."""
    spec, frames, _ = clips["reacq"]
    frames = frames.copy()
    frames[:, 96:112, 130:146] = np.random.default_rng(21).integers(0, 256, (16, 16), np.uint8)
    g = gray_u8_to_f32(frames[0])
    x, y, w, h = target_bbox(spec, 0)
    rois = [(x, y, w, h), (-12, 40, 16, 16), (130, 96, 16, 16)]
    templs = [g[y : y + h, x : x + w], g[y : y + h, x : x + w], g[96:112, 130:146]]
    return frames, templs, rois


@pytest.mark.parametrize("engine", ["xla", "shared"])
def test_multi_object_matches_jax(clips, oracles, engine):
    from pvot.parallel.multi import init_multi_state as jax_multi
    from pvot.parallel.multi import track_video_multi as jax_multi_track
    from pvot_torch.parallel.multi import track_video_multi

    frames, templs, rois = _objects(clips)
    start = jax_multi([jnp.asarray(t) for t in templs], rois)
    got_state, got = track_video_multi(frames[1:], state_from_numpy(_np(start), device="cpu"),
                                       pvot_torch.TrackerConfig(**KW), backend=engine,
                                       chunk_size=6)
    assert got.bbox.shape == (19, 3, 4)
    assert got.used_global[:, 1].any()  # the object from outside searched globally
    if engine == "xla":
        _, want = jax_multi_track(frames[1:], start, JaxConfig(**KW), backend="xla",
                                  chunk_size=8)
        wants = [type(want)(*(np.asarray(v)[:, k] for v in want)) for k in range(3)]
    else:  # one lane of the JAX vmapped step is the shear engine on that object
        wants = [track_video_shear(frames[1:], jax_init_state(jnp.asarray(t), r),
                                   JaxConfig(**KW), chunk_size=8)[1]
                 for t, r in zip(templs, rois)]
    for k in range(3):
        _assert_out(type(got)(*(v[:, k] for v in got)), wants[k])


def test_multi_object_bucketed_matches_jax(clips):
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed
    from pvot.parallel.multi import track_video_multi as jax_multi_track
    from pvot_torch.parallel.multi import track_video_multi

    spec, frames, _ = clips["reacq"]
    g = gray_u8_to_f32(frames[0])
    x, y, w, h = target_bbox(spec, 0)
    templs = [g[y : y + h, x : x + w], g[y + 2 : y + 14, x + 2 : x + 14],
              g[y + 2 : y + 14, x : x + w]]
    rois = [(x, y, w, h), (-8, y + 2, 12, 12), (x, y + 2, w, 12)]
    start = jax_bucketed([np.asarray(t) for t in templs], rois)
    js, jo = jax_multi_track(frames[1:], start, JaxConfig(**KW), chunk_size=8)
    gs, go = track_video_multi(frames[1:], state_from_numpy(_np(start), device="cpu"),
                               pvot_torch.TrackerConfig(**KW), chunk_size=6)
    assert go.used_global[:, 1].any()
    for k in range(3):
        _assert_out(type(go)(*(v[:, k] for v in go)),
                    type(jo)(*(np.asarray(v)[:, k] for v in jo)))
    got, want = state_to_numpy(gs), _np(js)
    for key in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["template"], want["template"], atol=1e-6)


@pytest.mark.parametrize("engine", ["xla", "shared"])
def test_multi_stream_masked_chunks_match_jax(clips, oracles, engine):
    """Two streams in lockstep, the second ending after 9 frames: its
    padding frames leave its state as it was."""
    from pvot.parallel.multi import init_multi_state as jax_multi
    from pvot.parallel.multi import make_multi_stream_step as jax_stream_step
    from pvot.parallel.multi import make_stream_masked_scan_fn as jax_masked
    from pvot_torch.parallel.multi import make_multi_stream_step, make_stream_masked_scan_fn

    plain, reacq = clips["plain"], clips["reacq"]
    start = jax_multi([plain[2].template, reacq[2].template],
                      [tuple(int(v) for v in s.bbox) for s in (plain[2], reacq[2])])
    c = 16
    frames = np.stack([plain[1][1 : 1 + c], reacq[1][1 : 1 + c]], axis=1)  # (C, S, H, W)
    valid = np.stack([np.ones(c, bool), np.arange(c) < 9], axis=1)
    cfg = pvot_torch.TrackerConfig(**KW)
    scan = make_stream_masked_scan_fn(make_multi_stream_step((120, 160), (16, 16), cfg,
                                                             backend=engine))
    gs, go = scan(state_from_numpy(_np(start), device="cpu"), torch.from_numpy(frames), valid)
    assert go.bbox.shape == (c, 2, 4)
    if engine == "xla":
        js, jo = jax_masked(jax_stream_step((120, 160), (16, 16), JaxConfig(**KW)))(
            start, jnp.asarray(frames), jnp.asarray(valid))
        wants = [type(jo)(*(np.asarray(v)[:n, s] for v in jo)) for s, n in ((0, c), (1, 9))]
        np.testing.assert_array_equal(state_to_numpy(gs)["bbox_x"], np.asarray(js.bbox_x))
    else:
        wants = [oracles("plain", "shared", "fused")[1],
                 oracles("reacq", "shared", "fused")[1]]
        wants = [type(w)(*(np.asarray(v)[:n] for v in w)) for w, n in zip(wants, (c, 9))]
    for s, n in ((0, c), (1, 9)):
        _assert_out(type(go)(*(v[:n, s] for v in go)), wants[s])
    # Stream 1 holds the state of its last valid frame.
    assert state_to_numpy(gs)["bbox_x"][1] == go.bbox[8, 1, 0]


# --- NccTracker, track_stream and the CLI.


def test_ncc_tracker_matches_jax(clips, tmp_path):
    from pvot.models.ncc import NccTracker as JaxTracker
    from pvot_torch.models.ncc import NccTracker

    spec, frames, _ = clips["reacq"]
    roi = target_bbox(spec, 0)
    jt = JaxTracker(frames[0], roi, JaxConfig(**KW))
    tt = NccTracker(frames[0], roi, pvot_torch.TrackerConfig(**KW), device="cpu")
    assert tt.bbox == jt.bbox
    for f in frames[1:9]:
        (jb, js), (tb, ts) = jt.update(f), tt.update(f)
        assert tb == jb
        assert abs(ts - js) <= 2e-3
    path = tt.save(str(tmp_path / "tracker"))
    resumed = NccTracker.load(path, frames.shape[1:], pvot_torch.TrackerConfig(**KW),
                              device="cpu")
    want = jt.track(frames[9:], chunk_size=8)
    for tracker in (tt, resumed):
        _assert_out(tracker.track(frames[9:], chunk_size=4), want)
    assert pvot_torch.NccTracker is NccTracker


@pytest.mark.parametrize("backend,chunk", [("xla", 4), ("xla", 19), ("shared", 5),
                                           ("mega", 8)])
def test_track_stream_matches_jax(clips, oracles, backend, chunk):
    """Chunk sizes that divide the 19-frame clip and that do not."""
    from pvot_torch.io.pipeline import track_stream

    _, frames, _ = clips["reacq"]
    timings: list = []
    gs, go = track_stream(iter(frames[1:]), _start(clips, "reacq"), frames.shape[1:],
                          pvot_torch.TrackerConfig(**KW), backend=backend, chunk_size=chunk,
                          timings=timings)
    assert sum(n for n, _ in timings) == 19
    want_state, want = oracles("reacq", "xla" if backend == "xla" else "shared", "fused")
    _assert_out(go, want)
    _assert_state(gs, want_state)
    assert pvot_torch.track_stream is track_stream


def test_track_stream_batched_matches_jax(clips):
    from pvot_torch.io.pipeline import track_stream_batched

    _, frames, st = clips["reacq"]
    _, jo = jax_track_video_batched(frames[1:], st, JaxConfig(**KW), batch_size=4,
                                    backend="xla")
    _, go = track_stream_batched(iter(frames[1:]), _start(clips, "reacq"), frames.shape[1:],
                                 pvot_torch.TrackerConfig(**KW), batch_size=4,
                                 chunks_per_dispatch=3)
    _assert_out(go, jo)


CLI_SPEC = SyntheticSpec(width=160, height=120, num_frames=60)


def _cli_frames():
    """The CLI's synthetic clip as it tracks it: BGR frames, gray-converted."""
    from pvot.io.gray import bgr_to_gray_u8
    from pvot.io.synthetic import generate_bgr_frames

    return np.stack([bgr_to_gray_u8(f) for f in itertools.islice(generate_bgr_frames(CLI_SPEC),
                                                                  14)])


@pytest.mark.parametrize("mode,batch", [("--shared", 0), ("--cpu", 0), ("--shared", 4)])
def test_cli_trajectory_matches_jax(tmp_path, capsys, monkeypatch, mode, batch):
    import json

    from pvot_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    x, y, w, h = target_bbox(CLI_SPEC, 0)
    x, y, w, h = x + 32, y + 32, 16, 16  # a 16x16 patch of the 80x80 target
    argv = ["--synthetic", "160x120x60", "--max-frames", "13", "--first", "--roi", f"{x},{y},{w},{h}",
            "--search-radius", "12", "--device", "cpu", "--no-display", mode,
            "--trajectory-out", str(tmp_path / "traj.jsonl")]
    assert main(argv + ([f"--batch={batch}"] if batch else [])) == 0
    assert "tracking summary: frames=14" in capsys.readouterr().out
    recs = [json.loads(line) for line in open(tmp_path / "traj.jsonl")]
    assert [r["frame"] for r in recs] == list(range(1, 14))
    frames = _cli_frames()
    st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
                        (x, y, w, h))
    cfg = JaxConfig(search_radius_x=12, search_radius_y=12)
    if batch:
        _, want = jax_track_video_batched(frames[1:], st, cfg, batch_size=batch, backend="xla")
    else:  # this clip has no global frame, where the xla engine would be the outlier
        _, want = jax_track_video(frames[1:], st, cfg, backend="cpu" if mode == "--cpu" else "xla")
        assert not np.asarray(want.used_global).any()
    got = type(want)(np.array([r["bbox"] for r in recs], np.int32),
                     np.array([r["score"] for r in recs], np.float32),
                     np.array([r["used_global"] for r in recs]),
                     np.array([r["updated"] for r in recs]))
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox))
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated))
    # The trajectory file rounds scores to 6 decimals.
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)


def test_cli_records_video(tmp_path, capsys, monkeypatch):
    """--record writes the annotated clip under output/<base>_<mode><ext>
    (the reference's naming; cv2 imported when the writer opens)."""
    pytest.importorskip("cv2")
    from pvot_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    x, y, _, _ = target_bbox(CLI_SPEC, 0)
    assert main(["--synthetic", "160x120x60", "--max-frames", "5", "--first", "--roi",
                 f"{x + 32},{y + 32},16,16", "--search-radius", "12", "--device", "cpu",
                 "--record", "--shared"]) == 0
    out = capsys.readouterr().out
    assert "Output video: output/synthetic_shared.mp4" in out
    assert "Recorded tracking summary: frames=6" in out
    assert (tmp_path / "output" / "synthetic_shared.mp4").stat().st_size > 0


@pytest.mark.parametrize("flag", ["--fast", "--pallas_fast"])
def test_cli_fast_modes_run(tmp_path, capsys, monkeypatch, flag):
    """The fast engines run through the CLI (their trajectories are held to
    JAX in tests/test_torch_tiers.py)."""
    from pvot_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    x, y, _, _ = target_bbox(CLI_SPEC, 0)
    assert main(["--synthetic", "160x120x6", "--first", "--roi", f"{x + 32},{y + 32},16,16",
                 "--search-radius", "12", "--device", "cpu", "--no-display", flag]) == 0
    out = capsys.readouterr().out
    assert f"Tracking mode: {flag[2:]}" in out
    assert "Interactive tracking summary: frames=6" in out
