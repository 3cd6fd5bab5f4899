"""Multi-stream tracking and serving in the port (pvot_torch.track_streams_mega,
serve_streams, serve_streams_grouped, pvot-torch-serve, checkpoints) and the
host-side copies it runs on, against the JAX package.

Oracle: pvot.tracker.scan.track_video(strategy="fused", backend="xla") per
stream, as tests/test_serving.py uses it; no Pallas interpret call.  Streams
as in tests/test_serving.py: synthetic, 250x94 frames, 16x16 template,
radius 8, unequal lengths.  Tolerance, as the tracker's equality contract
(pvot/tracker/mega.py _outputs_equal): bbox, updated and used_global
exactly; accepted scores within 1e-5, all scores within 2e-3; final states:
ints and flags exactly, template and stats within 1e-6.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.tracker.scan import track_video as jax_track_video
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.convert import state_from_numpy, state_to_numpy
from pvot_torch.io.serving import _StreamFeed, serve_objects, serve_streams, serve_streams_grouped
from pvot_torch.parallel.multi import init_multi_state, stack_states, unstack_state
from pvot_torch.tracker.scan import track_video_batched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(search_radius_x=8, search_radius_y=8)
LENGTHS = [13, 6, 17]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n, seed, h=94, w=250, t=16, kw=KW):
    """(frames (n+1, h, w), start state as numpy, JAX out, JAX final as numpy)."""
    spec = SyntheticSpec(width=w, height=h, num_frames=n + 1, target_w=t, target_h=t,
                         seed=seed, noise_std=1.0)
    frames = generate_gray_video(spec)
    x, y, bw, bh = target_bbox(spec, 0)
    st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + bh, x : x + bw]),
                        (x, y, bw, bh))
    js, jo = jax_track_video(frames[1:], st, JaxConfig(**kw), strategy="fused",
                             backend="xla", chunk_size=4)
    as_np = lambda s: {k: np.asarray(v) for k, v in s._asdict().items()}  # noqa: E731
    return frames, as_np(st), jo, as_np(js)


@pytest.fixture(scope="module")
def streams():
    return [_stream(n, 3 + i) for i, n in enumerate(LENGTHS)]


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got.bbox, want.bbox)
    np.testing.assert_array_equal(got.updated, want.updated)
    np.testing.assert_array_equal(got.used_global, want.used_global)
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)


def _assert_state(got, want):
    got = state_to_numpy(got)
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        assert got[k] == want[k], k
    for k in ("template", "t_mean", "t_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _stacked(streams):
    return stack_states([state_from_numpy(s[1], device="cpu") for s in streams], device="cpu")


def test_track_streams_mega_matches_jax(streams):
    """Equal-length streams (each cut to the shortest): the (F, S) layout,
    stream s of frame i equal to JAX on stream s."""
    n = min(LENGTHS)
    videos = np.stack([s[0][1 : 1 + n] for s in streams])
    final, out = pvot_torch.track_streams_mega(
        videos, _stacked(streams), pvot_torch.TrackerConfig(**KW), chunk_size=4, device="cpu")
    assert out.bbox.shape == (n, 3, 4) and out.score.shape == (n, 3)
    for s, (_, _, jo, _) in enumerate(streams):
        want = type(jo)(*(np.asarray(v)[:n] for v in jo))
        _assert_outputs(type(out)(*(v[:, s] for v in out)), want)
    assert final.template.shape == (3, 16, 16)
    # The look-ahead cadence: each stream's records are the batched scan
    # engine's on that stream alone (held frames and the leftover tail too).
    _, batched = pvot_torch.track_streams_mega(
        videos, _stacked(streams), pvot_torch.TrackerConfig(**KW), chunk_size=4, batch=2,
        device="cpu")
    for s in range(3):
        _, want = track_video_batched(
            videos[s], state_from_numpy(streams[s][1], device="cpu"),
            pvot_torch.TrackerConfig(**KW), batch_size=2)
        _assert_outputs(type(batched)(*(v[:, s] for v in batched)), want)


@pytest.mark.parametrize("depth", [1, 2])
def test_serve_streams_matches_jax(streams, depth):
    timings: list = []
    final, outs = pvot_torch.serve_streams(
        [iter(s[0][1:]) for s in streams], _stacked(streams), (94, 250),
        pvot_torch.TrackerConfig(**KW), chunk_size=4, timings=timings,
        pipeline_depth=depth,
    )
    assert [o.bbox.shape[0] for o in outs] == LENGTHS
    assert sum(n for n, _ in timings) == sum(LENGTHS)
    assert len(timings) == -(-max(LENGTHS) // 4)
    for s, (_, _, jo, js) in enumerate(streams):
        _assert_outputs(outs[s], jo)
        _assert_state(unstack_state(final, s), js)


def test_serve_streams_grouped_mixed_geometries(streams):
    """Streams of two frame sizes and two template sizes: three geometry
    groups, each stream equal to JAX on its own."""
    other = [_stream(9, 11, h=80, w=200, t=12), _stream(7, 12, h=94, w=250, t=20)]
    every = [streams[0], other[0], streams[2], other[1]]
    shapes = [(94, 250), (80, 200), (94, 250), (94, 250)]
    timings: list = []
    finals, outs = serve_streams_grouped(
        [iter(s[0][1:]) for s in every], [state_from_numpy(s[1], device="cpu") for s in every], shapes,
        pvot_torch.TrackerConfig(**KW), chunk_size=4, timings=timings,
    )
    assert sum(n for n, _ in timings) == sum(len(s[0]) - 1 for s in every)
    for s, (_, _, jo, js) in enumerate(every):
        _assert_outputs(outs[s], jo)
        _assert_state(finals[s], js)


def test_serve_streams_decode_error_propagates(streams):
    def broken():
        yield streams[0][0][1]
        yield streams[0][0][2]
        raise IOError("decode failed")

    with pytest.raises(IOError, match="decode failed"):
        serve_streams([broken(), iter(streams[1][0][1:])], _stacked(streams[:2]), (94, 250),
                      pvot_torch.TrackerConfig(**KW), chunk_size=4)


@pytest.mark.parametrize("use_native", [True, False])
def test_stream_feed_holds_after_end(monkeypatch, use_native):
    """The feed fills the caller's buffer: full chunks, the tail padded with
    its last frame, then the held last frame with zero valid."""
    from pvot_torch.runtime import native

    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    frames = np.random.default_rng(0).integers(0, 256, size=(6, 8, 8), dtype=np.uint8)
    feed = _StreamFeed(iter(frames), (8, 8), chunk_size=4)
    out = np.full((4, 8, 8), 7, np.uint8)
    assert feed.next_chunk(out) == 4
    np.testing.assert_array_equal(out, frames[:4])
    assert feed.next_chunk(out) == 2
    np.testing.assert_array_equal(out, frames[[4, 5, 5, 5]])
    out[:] = 0
    assert feed.next_chunk(out) == 0 and feed.done  # exhausted: held last frame
    np.testing.assert_array_equal(out, np.broadcast_to(frames[5], (4, 8, 8)))
    assert feed.next_chunk(out) == 0
    feed.close()
    empty = _StreamFeed(iter([]), (8, 8), chunk_size=4)
    assert empty.next_chunk(out) == 0
    np.testing.assert_array_equal(out, 0)
    empty.close()


@pytest.mark.parametrize("kwargs,item", [
    (dict(highest=False, score_passes=4), "score_passes"), (dict(devices=["cpu", "cpu"]), "A12"),
])
def test_serving_options_not_ported_raise(streams, kwargs, item):
    """A score tier the kernels do not have raises ValueError, as in JAX.
    Several devices (ROADMAP A12) are ported: serve_streams and
    serve_streams_grouped serve over them, and serve_objects, which serves
    one stream, raises ValueError for more than one."""
    if item == "A12":
        one = [iter(streams[0][0][1:4])]
        _, outs = serve_streams(one, _stacked(streams[:1]), (94, 250), chunk_size=2, **kwargs)
        assert outs[0].bbox.shape == (3, 4)
        _, outs = serve_streams_grouped([iter(streams[0][0][1:4])],
                                        [state_from_numpy(streams[0][1], device="cpu")],
                                        [(94, 250)], chunk_size=2, **kwargs)
        assert outs[0].bbox.shape == (3, 4)
        with pytest.raises(ValueError, match="one device"):
            serve_objects(iter(streams[0][0][1:]), _stacked(streams[:1]), (94, 250), **kwargs)
        return
    with pytest.raises(ValueError, match=item):
        serve_streams([iter(streams[0][0][1:])], _stacked(streams[:1]), (94, 250), **kwargs)
    with pytest.raises(ValueError, match=item):
        serve_streams_grouped([iter(streams[0][0][1:])], [state_from_numpy(streams[0][1], device="cpu")],
                              [(94, 250)], **kwargs)


def test_init_multi_state_stacks_init_state(streams):
    frames = streams[0][0]
    rois = [(10, 20, 16, 16), (100, 40, 16, 16)]
    templates = [gray_u8_to_f32(frames[0])[y : y + 16, x : x + 16] for x, y, _, _ in rois]
    st = init_multi_state(templates, rois, device="cpu")
    assert st.template.shape == (2, 16, 16) and st.bbox_x.tolist() == [10, 100]
    for i in range(2):
        one = state_to_numpy(pvot_torch.init_state(templates[i], rois[i], device="cpu"))
        for k, v in state_to_numpy(unstack_state(st, i)).items():
            np.testing.assert_array_equal(v, one[k], err_msg=k)
    with pytest.raises(ValueError, match="one shape"):
        init_multi_state([templates[0], templates[0][:8]], [rois[0], (0, 0, 16, 8)],
                         device="cpu")


def test_checkpoint_resumes_across_packages(streams, tmp_path):
    """A stacked state saved by pvot.utils.checkpoint resumes in the port with
    the JAX trajectory, and a port checkpoint resumes in JAX."""
    from pvot.utils.checkpoint import load_state as jax_load
    from pvot.utils.checkpoint import save_state as jax_save
    from pvot_torch.utils.checkpoint import FORMAT_VERSION, load_state, save_state
    import pvot.utils.checkpoint as jax_ckpt

    assert FORMAT_VERSION == jax_ckpt.FORMAT_VERSION
    frames, start, _, _ = streams[2]
    st = jax_init_state(jnp.asarray(start["template"]),
                        tuple(int(start[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h")))
    cfg = JaxConfig(**KW)
    mid, _ = jax_track_video(frames[1:9], st, cfg, strategy="fused", backend="xla", chunk_size=4)
    _, want = jax_track_video(frames[9:], mid, cfg, strategy="fused", backend="xla", chunk_size=4)
    path = jax_save(str(tmp_path / "jax_ckpt"), mid)
    resumed = load_state(path, device="cpu")
    got_state, got = pvot_torch.track_video_mega(frames[9:], resumed,
                                                 pvot_torch.TrackerConfig(**KW), device="cpu")
    _assert_outputs(got, want)
    # And back: the port's checkpoint resumes in JAX.
    path2 = save_state(str(tmp_path / "torch_ckpt"), got_state)
    back = jax_load(path2)
    for k, v in state_to_numpy(got_state).items():
        assert np.asarray(getattr(back, k)).tobytes() == v.tobytes(), k
    # A stacked state round-trips too.
    stacked = _stacked(streams)
    again = load_state(save_state(str(tmp_path / "stacked.npz"), stacked), device="cpu")
    for k, v in state_to_numpy(stacked).items():
        np.testing.assert_array_equal(state_to_numpy(again)[k], v, err_msg=k)


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "pvot_torch.cli.serve", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_synthetic_streams_write_trajectories(tmp_path):
    out = _cli("--synthetic", "200x120x7", "--streams", "2", "--roi", "60,30,16,16",
               "--search-radius", "8", "--chunk-size", "4", "--device", "cpu",
               "--trajectory-out", str(tmp_path / "traj"),
               "--checkpoint-out", str(tmp_path / "ckpt"), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "Serving summary: streams=2, frames=12" in out.stdout
    for s in range(2):
        lines = (tmp_path / f"traj.s{s}.jsonl").read_text().splitlines()
        assert len(lines) == 6
        rec = json.loads(lines[-1])
        assert rec["stream"] == s and rec["frame"] == 6 and len(rec["bbox"]) == 4
    assert (tmp_path / "ckpt.npz").exists()


@pytest.mark.parametrize("args,item", [
    (("--synthetic", "200x120x3", "--score-passes", "1"), "needs --fast"),
    (("--synthetic", "200x120x3", "--devices", "2"), "A12"),
])
def test_cli_not_ported_modes_exit_2(tmp_path, args, item):
    """--score-passes without --fast exits 2.  --devices (ROADMAP A12) is
    ported: with --device cpu it serves the streams over the CPU twice."""
    out = _cli(*args, "--device", "cpu", cwd=tmp_path)
    if item == "A12":
        assert out.returncode == 0, out.stderr
        assert "2 devices" in out.stdout and "Serving summary: streams=4, frames=8" in out.stdout
        return
    assert out.returncode == 2
    assert item in out.stderr


# --- The host-side copies (pvot_torch never imports pvot) held to their originals.

def test_native_runtime_copy_matches_original():
    import pvot.runtime.native as jnative
    import pvot_torch.runtime.native as tnative

    with open(os.path.join(REPO, "pvot/runtime/libpvot.cpp"), "rb") as a, \
            open(os.path.join(REPO, "pvot_torch/runtime/libpvot.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert tnative.available()
    assert os.path.dirname(tnative._SO) == os.path.join(REPO, "build", "pvot_torch")
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (2, 9, 13, 3), np.uint8)
    np.testing.assert_array_equal(tnative.bgr_to_gray_u8(bgr), jnative.bgr_to_gray_u8(bgr))
    np.testing.assert_array_equal(tnative.bgr_to_gray_u8(bgr[0]), jnative.bgr_to_gray_u8(bgr[0]))
    gray = bgr[..., 0]
    assert tnative.gray_u8_to_f32(gray).tobytes() == jnative.gray_u8_to_f32(gray).tobytes()
    rings = [mod.FrameRing(3, (9, 13)) for mod in (jnative, tnative)]
    pushed = [[r.push(f) for f in gray[np.r_[0, 1, 0, 1]]] for r in rings]
    assert pushed[0] == pushed[1] == [True, True, True, False]
    assert len(rings[0]) == len(rings[1]) == 3
    np.testing.assert_array_equal(rings[0].pop(2), rings[1].pop(2))
    np.testing.assert_array_equal(rings[0].pop(5), rings[1].pop(5))
    for r in rings:
        r.close()


def test_gray_copy_matches_original(monkeypatch):
    import pvot.io.gray as jgray
    import pvot_torch.io.gray as tgray

    bgr = np.random.default_rng(2).integers(0, 256, (7, 11, 3), np.uint8)
    want = jgray.bgr_to_gray_u8(bgr)
    np.testing.assert_array_equal(tgray.bgr_to_gray_u8(bgr), want)
    monkeypatch.setattr(tgray, "_cv2", lambda: None)  # the card's machine: no OpenCV
    np.testing.assert_array_equal(tgray.bgr_to_gray_u8(bgr), want)
    with pytest.raises(ValueError):
        tgray.bgr_to_gray_u8(bgr[..., 0])


@pytest.mark.parametrize("use_native", [True, False])
def test_frame_pipeline_copy_matches_original(use_native):
    from pvot.io.pipeline import FramePipeline as JaxPipeline
    from pvot_torch.io.pipeline import FramePipeline

    rng = np.random.default_rng(3)
    frames = list(rng.integers(0, 256, (9, 6, 10), np.uint8))
    frames[4] = rng.integers(0, 256, (6, 10, 3), np.uint8)  # a BGR frame among gray ones
    got, want = [], []
    for cls, out in ((FramePipeline, got), (JaxPipeline, want)):
        pipe = cls(iter(frames), (6, 10), chunk_size=4, use_native=use_native)
        out.extend((c.copy(), n) for c, n in pipe.chunks())
        pipe.close()
    assert [n for _, n in got] == [n for _, n in want] == [4, 4, 1]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_video_reader_copy_matches_original(tmp_path):
    from pvot.io.video import VideoReader as JaxReader, VideoWriter
    from pvot_torch.io.video import VideoReader

    path = str(tmp_path / "clip.avi")
    rng = np.random.default_rng(4)
    with VideoWriter(path, 25.0, (32, 24)) as w:
        for _ in range(5):
            w.write(rng.integers(0, 256, (24, 32, 3), np.uint8))
    with VideoReader(path) as a, JaxReader(path) as b:
        assert a.size == b.size == (32, 24) and a.fps == b.fps
        fa, fb = list(a), list(b)
    assert len(fa) == len(fb) == 5
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)
    with VideoReader(path) as a, JaxReader(path) as b:
        for x, y in zip(a.gray_frames(), b.gray_frames()):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(IOError):
        VideoReader(str(tmp_path / "missing.avi"))
