"""Multi-object tracking in the port (K3's plain version, track_objects_mega,
serve_objects, init_multi_state_bucketed, template_stats_bucketed and the
objects mode of pvot-torch-serve) against the JAX package, and K3 against
its plain version and against K1 on the card.

Oracle: pvot.tracker.scan.track_video(strategy="fused", backend="xla") per
object at its true extent, as tests/test_mega.py:1215-1244 uses it; no
Pallas interpret call.  Fixtures, from seeds with the synthetic generator:
  uniform   tests/test_mega.py:832-851: 250x94 frames, the moving 16x16
            target plus two static 16x16 patches stamped from
            default_rng(21), radius 8; the "global" set adds a fourth object
            with the target's template that starts with its centre outside
            the frame and finds the target by global search;
  bucketed  tests/test_mega.py:1172-1196: 16x16, 12x12 and 12x16 templates,
            radius 8, lost threshold 2; in the "global" set the 12x12 object
            starts at x = -8 and goes global.
Tolerances, as the tracker's equality contract (pvot/tracker/mega.py
_outputs_equal): bbox, updated and used_global exactly; accepted scores
within 1e-5 (5e-5 for the bucketed sets, whose JAX stats sum a padded
template: pvot/tracker/mega.py:1005), all scores within 2e-3; templates and
their stats within 1e-6.  On this clip's flat background a 12x12 window's
variance E[x^2] - E[x]^2 cancels to about 1.5e-5; the plain version sums
the window moments in float64 (pvot_torch.ops.ncc_reference.ncc_scores), so
its rejected scores land on the float64 evaluation there (0.19302; JAX's
engine 0.19280), inside the 2e-3 bound.
"""

import itertools
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
from pvot.io.synthetic import SyntheticSpec, generate_gray_frames, generate_gray_video, target_bbox
from pvot.tracker.scan import track_video as jax_track_video
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.convert import state_from_numpy, state_to_numpy
from pvot_torch.ops.ncc_mega import (
    O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, MegaGeometry, mega_track_chunk,
    mega_track_chunk_objects, mega_track_chunk_objects_reference,
)
from pvot_torch.parallel.multi import init_multi_state, init_multi_state_bucketed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ["uniform-local", "uniform-global", "bucketed-local", "bucketed-global"]
F = 13  # tracked frames of each clip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform(with_global: bool):
    spec = SyntheticSpec(width=250, height=94, num_frames=120, target_w=16, target_h=16,
                         seed=3, noise_std=1.0)
    frames = np.stack(list(itertools.islice(generate_gray_frames(spec), F + 1)))
    rng = np.random.default_rng(21)
    for sx, sy in ((10, 10), (200, 60)):
        frames[:, sy : sy + 16, sx : sx + 16] = rng.integers(0, 256, (16, 16), np.uint8)
    g = gray_u8_to_f32(frames[0])
    rois = [target_bbox(spec, 0), (10, 10, 16, 16), (200, 60, 16, 16)]
    templs = [g[y : y + h, x : x + w] for x, y, w, h in rois]
    if with_global:  # the target's template, from outside the frame
        rois.append((-12, 40, 16, 16))
        templs.append(templs[0])
    return frames, templs, rois, dict(search_radius_x=8, search_radius_y=8)


def _bucketed(with_global: bool):
    spec = SyntheticSpec(width=250, height=94, num_frames=F + 1, target_w=16, target_h=16,
                         seed=3, noise_std=1.0)
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    g = gray_u8_to_f32(frames[0])
    templs = [g[y : y + h, x : x + w], g[y + 2 : y + 14, x + 2 : x + 14],
              g[y + 2 : y + 14, x : x + w]]
    rois = [(x, y, w, h), (-8 if with_global else x + 2, y + 2, 12, 12), (x, y + 2, w, 12)]
    return frames, templs, rois, dict(search_radius_x=8, search_radius_y=8,
                                      lost_frame_threshold=2)


def _as_np(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def cases():
    """name -> (frames, templates, rois, config kwargs, start state as numpy,
    [(JAX out, JAX final as numpy) per object])."""
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed
    from pvot.parallel.multi import init_multi_state as jax_multi

    out, oracle = {}, {}
    for name in SETS:
        kind, mode = name.split("-")
        frames, templs, rois, kw = (_uniform if kind == "uniform" else _bucketed)(mode == "global")
        per_object = []
        for t, r in zip(templs, rois):
            key = (kind, r)  # the local set's objects recur in the global set
            if key not in oracle:
                js, jo = jax_track_video(frames[1:], jax_init_state(jnp.asarray(t), r),
                                         JaxConfig(**kw), strategy="fused", backend="xla",
                                         chunk_size=4)
                oracle[key] = (jo, _as_np(js))
            per_object.append(oracle[key])
        init = jax_multi if kind == "uniform" else jax_bucketed
        start = _as_np(init([np.asarray(t) for t in templs], rois))
        out[name] = (frames, templs, rois, kw, start, per_object)
    return out


def _assert_object(rows_or_out, want, bucketed: bool):
    """One object's records (F, 10) or StepOutput against the JAX out."""
    if isinstance(rows_or_out, np.ndarray):
        bbox, score = rows_or_out[:, :4].astype(np.int32), rows_or_out[:, O_SCORE]
        updated, used_global = rows_or_out[:, O_UPDATED] != 0, rows_or_out[:, O_GUSED] != 0
    else:
        bbox, score, used_global, updated = rows_or_out
    np.testing.assert_array_equal(bbox, want.bbox)
    np.testing.assert_array_equal(updated, want.updated)
    np.testing.assert_array_equal(used_global, want.used_global)
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(score[acc], np.asarray(want.score)[acc],
                               atol=5e-5 if bucketed else 1e-5)
    np.testing.assert_allclose(score, np.asarray(want.score), atol=2e-3)


def _chunk_args(start, device="cpu"):
    st = state_from_numpy(start, device=device)
    return (torch.stack(list(st.bbox), dim=-1), st.template, st.t_mean, st.t_std,
            st.lost_count, st.use_global)


def _extents(rois):
    return [(h, w) for _, _, w, h in rois]


def test_fixtures_cover_global_search(cases):
    """The object started outside the frame searches globally from its first
    frame and is found again; in the other sets no object starts so."""
    for name in ("uniform-global", "bucketed-global"):
        jo = cases[name][5][1 if name.startswith("bucketed") else 3][0]
        assert jo.used_global[0] and (jo.used_global & jo.updated).any(), name
    for name in ("uniform-local", "bucketed-local"):
        assert not any(jo.used_global[0] for jo, _ in cases[name][5]), name


@pytest.mark.parametrize("shape,n", [((16, 16), 12 * 12), ((12, 20), 12 * 7), ((1, 5), 5)])
def test_template_stats_bucketed_matches_jax(shape, n):
    from pvot.ops.ncc_matmul import template_stats_bucketed as jax_stats
    from pvot_torch.ops.ncc_reference import template_stats_bucketed

    t = np.random.default_rng(n).random(shape, dtype=np.float32)
    want = [np.asarray(v) for v in jax_stats(jnp.asarray(t), jnp.int32(n))]
    got = template_stats_bucketed(torch.from_numpy(t), n)
    np.testing.assert_allclose([float(v) for v in got], want, atol=1e-6)
    stacked = template_stats_bucketed(torch.from_numpy(np.stack([t, t])), torch.tensor([n, n]))
    np.testing.assert_array_equal(stacked[0].numpy(), [got[0].item()] * 2)


def test_init_multi_state_bucketed_matches_jax(cases):
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed

    _, templs, rois, _, start, _ = cases["bucketed-global"]
    got = state_to_numpy(init_multi_state_bucketed(templs, rois, device="cpu"))
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "template", "lost_count", "use_global"):
        np.testing.assert_array_equal(got[k], start[k], err_msg=k)
    for k in ("t_mean", "t_std"):
        np.testing.assert_allclose(got[k], start[k], atol=1e-6, err_msg=k)
    wide = init_multi_state_bucketed(templs, rois, bucket=(20, 24), device="cpu")
    assert wide.template.shape == (3, 20, 24) and not wide.template[:, 16:, :].any()
    for bad in (dict(bucket=(15, 16)), dict(rois=[rois[0], rois[2], rois[1]])):
        kw = dict(dict(rois=rois), **bad)
        with pytest.raises(ValueError) as jax_err:
            jax_bucketed([np.asarray(t) for t in templs], **kw)
        with pytest.raises(ValueError) as torch_err:
            init_multi_state_bucketed(templs, device="cpu", **kw)
        assert str(torch_err.value).split()[0] == str(jax_err.value).split()[0]


def test_geometry_min_template():
    cfg = pvot_torch.TrackerConfig(search_radius_x=8, search_radius_y=8)
    # The bucket alone sizes the plan; each object's map follows its own
    # extent in the kernel.  A 176x176 bucket stages in halves at 3 lanes,
    # so a 64x48 object in it is shorter than one chunk (chip_smoke.py).
    assert MegaGeometry((94, 250), (16, 16), cfg).check(3).stage_rows(3) == 16
    big = MegaGeometry((1080, 1920), (176, 176), pvot_torch.TrackerConfig()).check(3)
    assert big.stage_rows(3) == 88 and big.smem_bytes(3) <= 232_448


def test_objects_wrapper_on_cpu_is_the_plain_version(cases):
    frames, _, rois, kw, start, _ = cases["bucketed-global"]
    cfg = pvot_torch.TrackerConfig(**kw)
    clip = torch.from_numpy(frames[1:])
    before = mega_track_chunk_objects.launches
    got = mega_track_chunk_objects(clip, *_chunk_args(start), F, cfg,
                                   bucket_extents=_extents(rois))
    want = mega_track_chunk_objects_reference(clip, *_chunk_args(start), [F] * 3, cfg,
                                              bucket_extents=_extents(rois))
    assert mega_track_chunk_objects.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="does not fit"):
        mega_track_chunk_objects(clip, *_chunk_args(start), F, cfg,
                                 bucket_extents=[(16, 16), (12, 12), (12, 17)])


@pytest.mark.parametrize("name", SETS)
def test_plain_objects_matches_jax_per_object(cases, name):
    """One chunk over the whole clip; object 0 stops after 7 frames, whose
    records past n_valid hold its state and commit nothing."""
    frames, _, rois, kw, start, per_object = cases[name]
    bucketed = name.startswith("bucketed")
    k = len(rois)
    n_valid = [7] + [F] * (k - 1)
    rows, tpl = mega_track_chunk_objects_reference(
        torch.from_numpy(frames[1:]), *_chunk_args(start), n_valid,
        pvot_torch.TrackerConfig(**kw), bucket_extents=_extents(rois) if bucketed else None)
    assert rows.shape == (k, F, 10) and tpl.shape == start["template"].shape
    rows = rows.numpy()
    for i, ((jo, js), (_, _, w, h)) in enumerate(zip(per_object, rois)):
        if i == 0:
            want = type(jo)(*(np.asarray(v)[:7] for v in jo))
            _assert_object(rows[0, :7], want, bucketed)
            for lane in (0, 1, 2, 3, O_LOST, O_USEG):
                assert (rows[0, 7:, lane] == rows[0, 6, lane]).all()
            assert not rows[0, 7:, O_UPDATED].any() and not rows[0, 7:, O_GUSED].any()
            continue
        _assert_object(rows[i], jo, bucketed)
        np.testing.assert_allclose(tpl[i, :h, :w].numpy(), js["template"], atol=1e-6)
        assert not tpl[i, h:, :].any() and not tpl[i, :, w:].any()


@pytest.mark.parametrize("name,chunk", [("uniform-global", 13), ("uniform-local", 4),
                                        ("bucketed-global", 4), ("bucketed-global", 5),
                                        ("bucketed-local", 13)])
def test_track_objects_mega_matches_jax(cases, name, chunk):
    """Chunks that divide the clip and that do not; the bucketed stats are
    recomputed over each object's true pixels at every chunk boundary."""
    frames, _, rois, kw, start, per_object = cases[name]
    bucketed = name.startswith("bucketed")
    states = state_from_numpy(start, device="cpu")  # the JAX state, converted
    final, out = pvot_torch.track_objects_mega(frames[1:], states, pvot_torch.TrackerConfig(**kw),
                                               chunk_size=chunk)
    assert out.bbox.shape == (F, len(rois), 4) and out.score.shape == (F, len(rois))
    final = state_to_numpy(final)
    for i, ((jo, js), (_, _, w, h)) in enumerate(zip(per_object, rois)):
        _assert_object(type(out)(*(v[:, i] for v in out)), jo, bucketed)
        for key in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
            assert final[key][i] == js[key], key
        np.testing.assert_allclose(final["template"][i, :h, :w], js["template"], atol=1e-6)
        np.testing.assert_allclose([final["t_mean"][i], final["t_std"][i]],
                                   [js["t_mean"], js["t_std"]], atol=1e-6)


@pytest.mark.parametrize("depth", [1, 2])
def test_serve_objects_equals_track_objects_mega(cases, depth):
    frames, _, _, kw, start, _ = cases["bucketed-global"]
    cfg = pvot_torch.TrackerConfig(**kw)
    want_state, want = pvot_torch.track_objects_mega(
        frames[1:], state_from_numpy(start, device="cpu"), cfg, chunk_size=4)
    timings: list = []
    got_state, got = pvot_torch.serve_objects(
        iter(frames[1:]), state_from_numpy(start, device="cpu"), frames.shape[1:], cfg,
        chunk_size=4, timings=timings, pipeline_depth=depth)
    assert [n for n, _ in timings] == [4, 4, 4, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k, v in state_to_numpy(want_state).items():
        np.testing.assert_array_equal(state_to_numpy(got_state)[k], v, err_msg=k)


def test_serve_objects_empty_stream(cases):
    frames, _, _, kw, start, _ = cases["uniform-global"]
    final, out = pvot_torch.serve_objects(iter([]), state_from_numpy(start, device="cpu"),
                                          frames.shape[1:], pvot_torch.TrackerConfig(**kw))
    assert out.bbox.shape == (0, 4, 4) and out.score.shape == (0, 4)
    assert out.used_global.shape == out.updated.shape == (0, 4)
    np.testing.assert_array_equal(final.bbox_x.numpy(), start["bbox_x"])
    # The bf16 tiers serve too (nothing to serve here); a tier the kernels do
    # not have raises.
    _, fast = pvot_torch.serve_objects(iter([]), state_from_numpy(start, device="cpu"),
                                       frames.shape[1:], highest=False, score_passes=1)
    assert fast.bbox.shape == (0, 4, 4)
    with pytest.raises(ValueError, match="score_passes"):
        pvot_torch.serve_objects(iter([]), state_from_numpy(start, device="cpu"),
                                 frames.shape[1:], highest=False, score_passes=4)


# --- pvot-torch-serve objects mode (synthetic stream: SyntheticSpec(320, 200,
# 8 frames, seed=1), its 80x80 target).

CLI_SPEC = SyntheticSpec(width=320, height=200, num_frames=8, seed=1)


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "pvot_torch.cli.serve", "--synthetic",
                           "320x200x8", "--streams", "1", "--search-radius", "8",
                           "--chunk-size", "3", "--device", "cpu", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _cli_rois(mixed: bool):
    x, y, w, h = target_bbox(CLI_SPEC, 0)
    return [(x, y, w, h), (x + 8, y + 8, 48, 40) if mixed else (x + 4, y + 2, w, h)]


def _read_trajectories(prefix, k):
    out = []
    for i in range(k):
        recs = [json.loads(line) for line in open(f"{prefix}.o{i}.jsonl")]
        assert all(r["object"] == i for r in recs)
        out.append(recs)
    return out


@pytest.mark.parametrize("mixed", [False, True])
def test_cli_objects_mode(tmp_path, mixed):
    """Several --roi over one stream: K trackers, the same trajectories as
    track_objects_mega on that stream, and a checkpoint that resumes."""
    rois = _cli_rois(mixed)
    out = _cli(*itertools.chain(*(("--roi", ",".join(map(str, r))) for r in rois)),
               "--trajectory-out", str(tmp_path / "traj"),
               "--checkpoint-out", str(tmp_path / "ckpt"), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "Serving 1 stream x 2 objects at 320x200, template 80x80" in out.stdout
    assert "Serving summary: objects=2, frames=7" in out.stdout
    frames = generate_gray_video(CLI_SPEC)
    g = gray_u8_to_f32(frames[0])
    templs = [g[y : y + h, x : x + w] for x, y, w, h in rois]
    init = init_multi_state_bucketed if mixed else init_multi_state
    _, want = pvot_torch.track_objects_mega(
        frames[1:], init(templs, rois, device="cpu"),
        pvot_torch.TrackerConfig(search_radius_x=8, search_radius_y=8), chunk_size=3)
    for i, recs in enumerate(_read_trajectories(tmp_path / "traj", 2)):
        assert [r["frame"] for r in recs] == list(range(1, 8))
        np.testing.assert_array_equal([r["bbox"] for r in recs], want.bbox[:, i])
        np.testing.assert_array_equal([r["updated"] for r in recs], want.updated[:, i])
    saved = np.load(tmp_path / "ckpt.npz")
    assert saved["template"].shape == (2, 80, 80)
    assert saved["bbox_h"].tolist() == [h for _, _, _, h in rois]


def test_cli_resumes_a_jax_objects_checkpoint(tmp_path):
    """K mixed-size objects saved by pvot.utils.checkpoint resume objects mode
    in the port (frames start at the stream's first frame), each on the JAX
    trajectory of that object alone."""
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed
    from pvot.utils.checkpoint import save_state as jax_save

    rois = _cli_rois(mixed=True)
    frames = generate_gray_video(CLI_SPEC)
    g = gray_u8_to_f32(frames[0])
    templs = [g[y : y + h, x : x + w] for x, y, w, h in rois]
    path = jax_save(str(tmp_path / "jax_objects"), jax_bucketed(templs, rois))
    out = _cli("--resume", path, "--trajectory-out", str(tmp_path / "traj"), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "Serving summary: objects=2, frames=8" in out.stdout
    cfg = JaxConfig(search_radius_x=8, search_radius_y=8)
    for i, recs in enumerate(_read_trajectories(tmp_path / "traj", 2)):
        _, jo = jax_track_video(frames, jax_init_state(jnp.asarray(templs[i]), rois[i]), cfg,
                                strategy="fused", backend="xla", chunk_size=4)
        got = (np.array([r["bbox"] for r in recs], np.int32), np.array([r["score"] for r in recs]),
               np.array([r["used_global"] for r in recs]), np.array([r["updated"] for r in recs]))
        _assert_object(got, jo, bucketed=True)


# --- On the card: K3 against its plain version and against K1.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# The objects cell's shape (1080p, radius 160, all local): 8 objects of 160 x
# 160, or a bucket of odd extents that still runs the resident plan (161 x
# 157 sets the bucket; 157, 64, 27, 31 and 35 columns leave 0, 1, 2, 3 and 4
# groups of 4 taps past the micro-tile loop's groups of 5).
CELL_SETS = {
    "cell-1080p": [(160, 160)] * 8,
    "bucketed-odd-1080p": [(161, 157), (100, 64), (33, 27), (45, 31), (50, 35)],
}


def _cell_case(name: str):
    """(frames, rois, config kwargs, start state as numpy) of a CELL_SETS case:
    a noise scene drifting 1 px a frame, each object cut from frame 0."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, (1080 + F, 1920 + F), np.uint8)
    frames = np.stack([base[f : f + 1080, f : f + 1920] for f in range(F + 1)])
    g = gray_u8_to_f32(frames[0])
    spots = [(200 + 420 * (i % 4), 150 + 560 * (i // 4)) for i in range(8)]
    rois = [(x, y, w, h) for (x, y), (h, w) in zip(spots, CELL_SETS[name])]
    templs = [g[y : y + h, x : x + w] for x, y, w, h in rois]
    bucketed = len(set(CELL_SETS[name])) > 1
    init = init_multi_state_bucketed if bucketed else init_multi_state
    start = _as_np(init(templs, rois, device="cpu"))
    return frames, rois, dict(search_radius_x=160, search_radius_y=160), start


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform-global", "bucketed-global", *CELL_SETS])
def test_cuda_objects_kernel_matches_plain_and_k1(cases, cuda_device, name):
    """Within the tolerance of the plain version, and each lane bit-equal to
    K1 on that object alone at its true extent; the cell's shapes run the
    resident plan."""
    if name in CELL_SETS:
        frames, rois, kw, start = _cell_case(name)
    else:
        frames, _, rois, kw, start, _ = cases[name]
    cfg = pvot_torch.TrackerConfig(**kw)
    clip = torch.from_numpy(frames[1:]).to(cuda_device)
    args = _chunk_args(start, cuda_device)
    ext = _extents(rois) if name.startswith("bucketed") else None
    before = mega_track_chunk_objects.launches_by_plan["resident"]
    n_valid = [7] + [F] * (len(rois) - 1)
    rows, tpl = mega_track_chunk_objects(clip, *args, n_valid, cfg, bucket_extents=ext)
    want_rows, want_tpl = mega_track_chunk_objects_reference(clip, *args, n_valid, cfg,
                                                             bucket_extents=ext)
    for lane in (0, 1, 2, 3, O_UPDATED, O_LOST, O_USEG, O_GUSED):
        np.testing.assert_array_equal(rows[..., lane].cpu().numpy(),
                                      want_rows[..., lane].cpu().numpy())
    np.testing.assert_allclose(rows[..., O_SCORE].cpu().numpy(),
                               want_rows[..., O_SCORE].cpu().numpy(), atol=2e-3)
    np.testing.assert_allclose(tpl.cpu().numpy(), want_tpl.cpu().numpy(), atol=1e-6)
    for i, (_, _, w, h) in enumerate(rois):
        one = [a[i] for a in args]
        one[1] = one[1][:h, :w].contiguous()
        k1 = mega_track_chunk(clip, *one, n_valid[i], cfg)
        assert torch.equal(k1[0], rows[i]) and torch.equal(k1[1], tpl[i, :h, :w])
    if name in CELL_SETS:
        assert mega_track_chunk_objects.launches_by_plan["resident"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_cuda_objects_launch_twice_per_frame(cases, cuda_device, k):
    frames, _, _, kw, start, _ = cases["uniform-local"]
    args = [a[:1].expand(k, *a.shape[1:]).contiguous() for a in _chunk_args(start, cuda_device)]
    before = mega_track_chunk_objects.launches
    mega_track_chunk_objects(torch.from_numpy(frames[1:]).to(cuda_device), *args, F,
                             pvot_torch.TrackerConfig(**kw))
    assert mega_track_chunk_objects.launches == before + 1  # one launch a chunk, whatever K
