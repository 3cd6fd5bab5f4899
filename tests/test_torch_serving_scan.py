"""Serving over the scan engines in the port (pvot_torch.io.serving
serve_streams / serve_objects / serve_streams_grouped with backend != "mega",
and the route out of the mega envelope onto `scan_backend`), and
pvot-torch-serve --scan-backend, against the JAX package.

Oracles: JAX's serve_streams and serve_objects on the `xla` engine (the
scan route runs on the CPU without any Pallas call) and
pvot.tracker.scan.track_video per stream; the port's `shared` engine is held
to JAX's shear engine in tests/test_torch_serving_shear.py.
Streams as in tests/test_serving.py:20-36: synthetic, 250x94 frames, 16x16
template, radius 8, unequal lengths [13, 6, 17].  Tolerance, the tracker's
equality contract (pvot/tracker/mega.py _outputs_equal): bbox, updated and
used_global exactly; accepted scores within 1e-5, all scores within 2e-3;
final states: ints and flags exactly, template and stats within 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.ops.ncc_mega import MegaGeometry as JaxGeometry
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.convert import state_from_numpy, state_to_numpy
from pvot_torch.io import serving
from pvot_torch.ops.ncc_mega import MegaGeometry
from pvot_torch.parallel.multi import init_multi_state, init_multi_state_bucketed, stack_states
from pvot_torch.tracker.state import StepOutput

KW = dict(search_radius_x=8, search_radius_y=8)
LENGTHS = [13, 6, 17]
GEOMETRY = (94, 250)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_np(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _stream(n, seed, h=94, w=250, t=16):
    """(frames (n + 1, h, w), the JAX start state) of tests/test_serving.py's
    kind of stream."""
    spec = SyntheticSpec(width=w, height=h, num_frames=n + 1, target_w=t, target_h=t,
                         seed=seed, noise_std=1.0)
    frames = generate_gray_video(spec)
    x, y, bw, bh = target_bbox(spec, 0)
    return frames, jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + bh, x : x + bw]),
                                  (x, y, bw, bh))


@pytest.fixture(scope="module")
def streams():
    return [_stream(n, 3 + i) for i, n in enumerate(LENGTHS)]


def _jax_stacked(states):
    return type(states[0])(*(jnp.stack(xs) for xs in zip(*states)))


def _torch_stacked(states):
    return stack_states([state_from_numpy(_as_np(s), device="cpu") for s in states], "cpu")


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox))
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated))
    np.testing.assert_array_equal(got.used_global, np.asarray(want.used_global))
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)


def _assert_state(got, want: dict):
    got = state_to_numpy(got)
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("template", "t_mean", "t_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_serve_streams_xla_matches_jax_serving(streams):
    """Three streams of unequal length on the xla engine: every stream's
    records and final state equal JAX's serve_streams(backend="xla"); an
    ended stream's padding frames leave its state as its last frame left it;
    one timing pair a lockstep chunk."""
    from pvot.io.serving import serve_streams as jax_serve

    cfg = JaxConfig(**KW)
    jfinal, jouts = jax_serve([iter(f[1:]) for f, _ in streams],
                              _jax_stacked([s for _, s in streams]), GEOMETRY, cfg,
                              backend="xla", chunk_size=4)
    timings: list = []
    final, outs = serving.serve_streams(
        [iter(f[1:]) for f, _ in streams], _torch_stacked([s for _, s in streams]), GEOMETRY,
        pvot_torch.TrackerConfig(**KW), backend="xla", chunk_size=4, timings=timings)
    assert [o.bbox.shape[0] for o in outs] == LENGTHS
    assert [n for n, _ in timings] == [12, 10, 8, 5, 1]
    for s in range(3):
        _assert_outputs(outs[s], jouts[s])
    _assert_state(final, _as_np(jfinal))


@pytest.fixture(scope="module")
def objects_clip(streams):
    """One stream (stream 2's 18 frames) with two static random patches
    stamped in, as tests/test_torch_objects.py:67-80 builds its clip, and
    the corners of the objects on its first frame: the target, the patches,
    and one from outside the frame (x = -12) that goes global."""
    frames = streams[2][0].copy()
    rng = np.random.default_rng(21)
    for sx, sy in ((10, 10), (200, 60)):
        frames[:, sy : sy + 16, sx : sx + 16] = rng.integers(0, 256, (16, 16), np.uint8)
    st = streams[2][1]
    return frames, [(int(st.bbox_x), int(st.bbox_y)), (10, 10), (200, 60), (-12, 40)]


@pytest.mark.parametrize("sizes", [[(16, 16)] * 4, [(16, 16), (12, 12), (12, 16)]],
                         ids=["uniform", "bucketed"])
def test_serve_objects_scan_matches_jax_serving(objects_clip, sizes):
    """serve_objects on the scan path (xla engine; the bucketed step for
    mixed sizes) equals JAX's serve_objects(backend="xla") per object, (F, K)
    layout, final states included; F = 0 keeps the layout in both.  The
    object from outside the frame takes the target's template."""
    from pvot.io.serving import serve_objects as jax_serve_objects
    from pvot.parallel.multi import init_multi_state as jax_multi
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed

    frames, corners = objects_clip
    g0 = gray_u8_to_f32(frames[0])
    k = len(sizes)
    rois = [(x, y, w, h) for (x, y), (h, w) in zip(corners, sizes)]
    templates = [g0[max(y, 0) : y + h, max(x, 0) : x + w] for x, y, w, h in rois]
    templates[3:] = templates[:1] * (k - 3)
    bucketed = len(set(sizes)) > 1
    jinit = jax_bucketed if bucketed else jax_multi
    tinit = init_multi_state_bucketed if bucketed else init_multi_state
    cfg = JaxConfig(**KW)
    jfinal, want = jax_serve_objects(iter(frames[1:]), jinit([jnp.asarray(t) for t in templates],
                                                             rois), GEOMETRY, cfg,
                                     backend="xla", chunk_size=4)
    timings: list = []
    final, got = serving.serve_objects(iter(frames[1:]), tinit(templates, rois, device="cpu"),
                                       GEOMETRY, pvot_torch.TrackerConfig(**KW), backend="xla",
                                       chunk_size=4, timings=timings)
    assert got.bbox.shape == (17, k, 4) and [n for n, _ in timings] == [4, 4, 4, 4, 1]
    assert got.used_global[:, k - 1].any() == (k == 4)
    for i in range(k):
        _assert_outputs(StepOutput(*(v[:, i] for v in got)),
                        type(want)(*(np.asarray(v)[:, i] for v in want)))
    _assert_state(final, _as_np(jfinal))
    _, jempty = jax_serve_objects(iter([]), jinit([jnp.asarray(t) for t in templates], rois),
                                  GEOMETRY, cfg, backend="xla", chunk_size=4)
    _, empty = serving.serve_objects(iter([]), tinit(templates, rois, device="cpu"), GEOMETRY,
                                     pvot_torch.TrackerConfig(**KW), backend="xla")
    for a, b in zip(empty, jempty):
        assert a.shape == np.shape(b) == (0, k, *np.shape(b)[2:])


def test_serve_streams_grouped_routes_each_group(streams, monkeypatch):
    """Two groups: the 16x16 streams inside the mega envelope (K2's plain
    version), an 80x80 stream outside it (its map, 15 rows, is smaller than
    the 17-row span) on scan_backend="xla"; every stream equal to JAX's
    track_video on it alone, and each group on its own route."""
    from pvot.tracker.scan import track_video as jax_track_video

    routes = []
    for name in ("_serve_mega", "_serve_streams_scan"):
        real = getattr(serving, name)

        def spy(*a, _real=real, _name=name, **k):
            routes.append((_name, len(a[0])))
            return _real(*a, **k)

        monkeypatch.setattr(serving, name, spy)
    big = _stream(9, 21, t=80)
    every = [streams[0], big, streams[1]]
    finals, outs = serving.serve_streams_grouped(
        [iter(f[1:]) for f, _ in every], [state_from_numpy(_as_np(s), device="cpu")
                                          for _, s in every],
        [GEOMETRY] * 3, pvot_torch.TrackerConfig(**KW), scan_backend="xla", chunk_size=4)
    assert sorted(routes) == [("_serve_mega", 2), ("_serve_streams_scan", 1)]
    for s, (frames, st) in enumerate(every):
        jfinal, want = jax_track_video(frames[1:], st, JaxConfig(**KW), strategy="fused",
                                       backend="xla", chunk_size=4)
        _assert_outputs(outs[s], want)
        _assert_state(finals[s], _as_np(jfinal))


def test_mega_geometry_supported_matches_jax():
    """MegaGeometry.supported() is JAX's envelope on a grid of frames,
    templates and radii (JAX's min_templ_shape of a bucket changes nothing:
    the bucket binds)."""
    checked = 0
    for frame in [(94, 250), (240, 320), (720, 1280), (1080, 1920)]:
        for templ in [(16, 16), (80, 80), (160, 160), (256, 256), (257, 40), (40, 257)]:
            for rx, ry in [(8, 8), (60, 60), (255, 255), (256, 40), (40, 256), (300, 300)]:
                cfg = dict(search_radius_x=rx, search_radius_y=ry)
                want = JaxGeometry(frame, templ, JaxConfig(**cfg)).supported()
                assert MegaGeometry(frame, templ, pvot_torch.TrackerConfig(**cfg)).supported() \
                    == want, (frame, templ, rx, ry)
                small = (min(templ[0], 8), min(templ[1], 8))
                assert JaxGeometry(frame, templ, JaxConfig(**cfg),
                                   min_templ_shape=small).supported() == want
                checked += want
    assert 0 < checked < 4 * 6 * 6


def _cli_streams(n_streams, n_frames, w=320, h=240):
    """pvot-torch-serve --synthetic WxHxF's streams: SyntheticSpec(seed=1 +
    s), frame 0 seeds the template at the known target."""
    out = []
    for s in range(n_streams):
        spec = SyntheticSpec(width=w, height=h, num_frames=n_frames, seed=1 + s)
        frames = generate_gray_video(spec)
        x, y, bw, bh = target_bbox(spec, 0)
        out.append((frames, jax_init_state(
            jnp.asarray(gray_u8_to_f32(frames[0])[y : y + bh, x : x + bw]), (x, y, bw, bh))))
    return out


@pytest.fixture(scope="module")
def wide_span():
    """Two 320x240 streams at radius 300 (span 601, outside the mega
    envelope) and JAX's serve_streams(backend="mega", scan_backend="xla")
    over them, which serves on xla."""
    from pvot.io.serving import serve_streams as jax_serve

    clips = _cli_streams(2, 9)
    cfg = JaxConfig(search_radius_x=300, search_radius_y=300)
    assert not JaxGeometry((240, 320), (80, 80), cfg).supported()
    jfinal, jouts = jax_serve([iter(f[1:]) for f, _ in clips],
                              _jax_stacked([s for _, s in clips]), (240, 320), cfg,
                              backend="mega", scan_backend="xla", chunk_size=4)
    return clips, jfinal, jouts


def test_out_of_envelope_routes_to_scan_backend(wide_span, monkeypatch):
    """backend="mega" at span 601 serves on scan_backend by the geometry
    test (K2's plain version is never reached), equal to JAX's."""
    clips, jfinal, jouts = wide_span

    def no_kernel(*a, **k):
        raise AssertionError("the mega kernel served a geometry outside its envelope")

    monkeypatch.setattr(serving, "mega_chunk_step_multi", no_kernel)
    final, outs = serving.serve_streams(
        [iter(f[1:]) for f, _ in clips], _torch_stacked([s for _, s in clips]), (240, 320),
        pvot_torch.TrackerConfig(search_radius_x=300, search_radius_y=300), backend="mega",
        scan_backend="xla", chunk_size=4)
    for s in range(2):
        _assert_outputs(outs[s], jouts[s])
    _assert_state(final, _as_np(jfinal))


def test_cli_scan_backend_writes_jax_trajectories(wide_span, tmp_path, monkeypatch, capsys):
    """pvot-torch-serve --scan-backend xla --search-radius 300: the written
    trajectories are JAX's serving output; an unknown engine exits 2."""
    from pvot_torch.cli.serve import main

    _, _, jouts = wide_span
    monkeypatch.chdir(tmp_path)
    assert main(["--synthetic", "320x240x9", "--streams", "2", "--search-radius", "300",
                 "--scan-backend", "xla", "--chunk-size", "4", "--device", "cpu",
                 "--trajectory-out", str(tmp_path / "traj")]) == 0
    assert "Serving summary: streams=2, frames=16" in capsys.readouterr().out
    for s in range(2):
        recs = [json.loads(line) for line in (tmp_path / f"traj.s{s}.jsonl").read_text().splitlines()]
        got = StepOutput(np.array([r["bbox"] for r in recs], np.int32),
                         np.array([r["score"] for r in recs], np.float32),
                         np.array([r["used_global"] for r in recs]),
                         np.array([r["updated"] for r in recs]))
        _assert_outputs(got, jouts[s])
    with pytest.raises(SystemExit) as e:
        main(["--synthetic", "320x240x3", "--scan-backend", "nope", "--device", "cpu"])
    assert e.value.code == 2 and "invalid choice: 'nope'" in capsys.readouterr().err


@pytest.mark.parametrize("names", [dict(backend="nope"), dict(scan_backend="nope")],
                         ids=["backend", "scan_backend"])
def test_unknown_engine_raises(names):
    """An engine name the registry does not know raises before any frame is
    read, for backend as for scan_backend."""
    from pvot_torch.io.serving import serve_objects, serve_streams

    states = stack_states([pvot_torch.init_state(np.ones((8, 8), np.float32), (4, 4, 8, 8),
                                                 device="cpu")], device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        serve_streams([iter(())], states, (32, 32), **names)
    with pytest.raises(ValueError, match="unknown"):
        serve_objects(iter(()), states, (32, 32), **names)
