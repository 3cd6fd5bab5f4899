"""The multi-stream chunk kernel's plain version and the repaired envelope of
the chunk kernel, against the JAX package.

Oracle: pvot.tracker.scan.track_video(strategy="fused", backend="xla") per
stream, as tests/test_serving.py uses it; on the global frames of the
re-acquiring stream, JAX's shear engine in interpret mode
(tests/jax_shear.py), which scores a global frame the way the chunk kernel
does, where the `xla` engine takes whole-frame float32 integral images
(pvot/ops/ncc_matmul.py:109-131) and lands 1.06e-5 off float64.  Inputs:
the tests/test_serving.py geometry (250x94 frames, 16x16 template, radius 8),
made from seeds with the synthetic generator.  Tolerance, as the tracker's
equality contract (pvot/tracker/mega.py _outputs_equal): bbox, updated and
used_global exactly; accepted scores within 1e-5 and all scores within 2e-3
for templates up to 80x80 px, both scaled by N / 6400 above that (an f32 sum
of N products carries a rounding error that grows with N); templates within
1e-6.
"""

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
from pvot_torch.convert import state_from_numpy
from pvot_torch.ops.ncc_mega import (
    O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, PLANS, SMEM_LIMIT, MegaGeometry,
    mega_track_chunk, mega_track_chunk_multi, mega_track_chunk_multi_reference,
    mega_track_chunk_objects, mega_track_chunk_reference, reset_launches, resident_smem_bytes,
    score_smem_bytes,
)
from pvot_torch.parallel.multi import stack_states
from pvot_torch.tracker.state import init_state

H, W, T = 94, 250, 16
KW = dict(search_radius_x=8, search_radius_y=8, lost_frame_threshold=3)
F = 12
# Stream 1 leaves the frame and is found again by global search; stream 2
# has ended (n_valid 0); stream 0 runs the whole chunk, stream 3 part of it.
N_VALID = [F, F, 0, 7]
SPECS = [dict(seed=3), dict(seed=3, exit_and_reenter=True), dict(seed=5), dict(seed=6)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(frames_after: int, h=H, w=W, t=T, **kw):
    """(frames (n+1, h, w) u8, JAX initial state, its numpy dict)."""
    spec = SyntheticSpec(width=w, height=h, num_frames=frames_after + 1, target_w=t,
                         target_h=t, noise_std=1.0, **kw)
    frames = generate_gray_video(spec)
    x, y, bw, bh = target_bbox(spec, 0)
    st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + bh, x : x + bw]),
                        (x, y, bw, bh))
    return frames, st, {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def streams():
    """Per stream: (frames, start state as numpy, JAX out over its valid
    frames, JAX final state as numpy)."""
    out = []
    cfg = JaxConfig(**KW)
    for kw, nv in zip(SPECS, N_VALID):
        frames, st, start = _clip(F, **kw)
        js, jo = jax_track_video(frames[1 : 1 + nv], st, cfg, strategy="fused",
                                 backend="xla", chunk_size=4)
        out.append((frames, start, jo, {k: np.asarray(v) for k, v in js._asdict().items()}))
    return out


@pytest.fixture(scope="module")
def shear_outs(streams):
    """JAX's shear engine over each stream that has global frames (stream
    index -> StepOutput)."""
    from tests.jax_shear import track_video_shear

    out = {}
    for s, (frames, start, jo, _) in enumerate(streams):
        if np.asarray(jo.used_global).any():
            st = jax_init_state(jnp.asarray(start["template"]), tuple(
                int(start[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h")))
            out[s] = track_video_shear(frames[1 : 1 + N_VALID[s]], st, JaxConfig(**KW),
                                       chunk_size=4)[1]
    return out


def _multi_args(streams):
    states = stack_states([state_from_numpy(s[1], device="cpu") for s in streams], device="cpu")
    frames = torch.from_numpy(np.stack([s[0][1:] for s in streams]))
    return frames, (torch.stack(list(states.bbox), dim=-1), states.template, states.t_mean,
                    states.t_std, states.lost_count, states.use_global)


def _assert_rows(rows, want, n_px=T * T):
    rows = np.asarray(rows)
    scale = max(1.0, n_px / 6400)
    np.testing.assert_array_equal(rows[:, :4].astype(np.int32), want.bbox)
    np.testing.assert_array_equal(rows[:, O_UPDATED] != 0, want.updated)
    np.testing.assert_array_equal(rows[:, O_GUSED] != 0, want.used_global)
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(rows[acc, O_SCORE], np.asarray(want.score)[acc], atol=1e-5 * scale)
    np.testing.assert_allclose(rows[:, O_SCORE], np.asarray(want.score), atol=2e-3 * scale)


def test_fixture_covers_global_search(streams, shear_outs):
    assert sorted(shear_outs) == [0, 1, 3]  # the streams with global frames
    jo = streams[1][2]
    assert jo.used_global.any() and (jo.used_global & jo.updated).any()
    assert (jo.used_global & ~jo.updated).any()


def test_plain_multi_matches_jax_per_stream(streams, shear_outs):
    frames, args = _multi_args(streams)
    rows, tpl = mega_track_chunk_multi_reference(frames, *args, N_VALID,
                                                 pvot_torch.TrackerConfig(**KW))
    assert rows.shape == (4, F, 10) and tpl.shape == (4, T, T)
    for s, (_, start, jo, js) in enumerate(streams):
        nv = N_VALID[s]
        if s in shear_outs:  # global frames scored as the shear engine scores them
            glob = np.asarray(jo.used_global)
            np.testing.assert_array_equal(shear_outs[s].bbox, jo.bbox)
            jo = type(jo)(jo.bbox, np.where(glob, shear_outs[s].score, jo.score),
                          jo.used_global, jo.updated)
        _assert_rows(rows[s, :nv], jo)
        np.testing.assert_allclose(tpl[s].numpy(), js["template"], atol=1e-6)
        # Frames past n_valid commit nothing: the state lanes hold.
        held = rows[s, nv - 1] if nv else torch.tensor(
            [float(start[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h")]
            + [0, 0, 0, float(start["lost_count"]), float(start["use_global"]), 0])
        for t in range(nv, F):
            for lane in (0, 1, 2, 3, O_LOST, O_USEG):
                assert rows[s, t, lane] == held[lane]
            assert rows[s, t, O_UPDATED] == 0 and rows[s, t, O_GUSED] == 0
    np.testing.assert_array_equal(tpl[2].numpy(), streams[2][1]["template"])


def test_multi_wrapper_on_cpu_is_the_plain_version(streams):
    frames, args = _multi_args(streams)
    cfg = pvot_torch.TrackerConfig(**KW)
    before = mega_track_chunk_multi.launches
    got = mega_track_chunk_multi(frames, *args, torch.tensor(N_VALID), cfg)
    want = mega_track_chunk_multi_reference(frames, *args, N_VALID, cfg)
    assert mega_track_chunk_multi.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("templ,radius,ok", [
    ((256, 256), 255, True), ((160, 160), 160, True), ((256, 1), 0, True),
    ((257, 256), 8, False), ((256, 257), 8, False), ((80, 80), 256, False),
])
def test_envelope_is_the_jax_mega_envelope(templ, radius, ok):
    cfg = pvot_torch.TrackerConfig(search_radius_x=radius, search_radius_y=radius)
    g = MegaGeometry((1080, 1920), templ, cfg)
    assert g.span_x == 2 * radius + 1
    if ok:
        g.check()
        assert 1 <= g.stage_rows() <= templ[0] and g.smem_bytes() <= 232_448
    else:
        with pytest.raises(ValueError, match="A4/A10"):
            g.check()


def test_stage_rows_chunk_large_templates():
    """Templates whose rows do not fit beside their input tile stage in
    chunks of their halves; 80x80 stages whole, as before."""
    cfg = pvot_torch.TrackerConfig()
    assert MegaGeometry((720, 1280), (80, 80), cfg).stage_rows() == 80
    assert MegaGeometry((1080, 1920), (160, 160), cfg).stage_rows() == 80
    assert MegaGeometry((720, 1280), (256, 256), cfg).stage_rows() == 64
    # The lane table of a many-stream call takes shared memory too; a
    # one-stream call has none.
    assert MegaGeometry((720, 1280), (143, 143), cfg).stage_rows(1) == 143
    assert MegaGeometry((720, 1280), (143, 143), cfg).stage_rows(256) < 143


@pytest.mark.parametrize("rows,tw,lanes,nbytes", [
    (80, 80, 1, 94_144), (80, 80, 8, 95_200), (80, 80, 200, 120_544), (104, 221, 1, 232_384),
])
def test_smem_plan_mirrors_the_kernel(rows, tw, lanes, nbytes):
    """csrc/mega_body.cuh score_smem_bytes: a 132-byte LaneWork entry a lane
    (none for one lane) before the staged rows and the input tile."""
    assert score_smem_bytes(rows, tw, lanes) == nbytes


# The resident plan's bytes at 160 x 160 (csrc/mega_body.cuh
# resident_smem_bytes): the template (160 x 160 floats), the longer half's
# window rows (80 + 31 rows of 16 + 160 + 4 floats), their row sums and sums
# of squares (111 x 16 each), and 8 shares' partials of a 32 x 16 tile (rows
# 20 floats apart); plus a 132-byte lane entry a lane past the first.
RESIDENT_160 = 4 * (160 * 160 + 111 * 180 + 2 * 111 * 16 + 8 * 32 * 20)


@pytest.mark.parametrize("templ,lanes,passes,plan,nbytes", [
    ((160, 160), 1, 0, "resident", RESIDENT_160),
    ((160, 160), 8, 0, "resident", RESIDENT_160 + 8 * 132),
    # the bf16 tiers keep the chunked plan: 80-row chunks
    ((160, 160), 8, 1, "chunked", 143_072),
    # the template and the smallest half's window work do not fit beside 200
    # lanes' table (26,400 bytes), nor beside none: quarters and halves
    ((176, 256), 200, 0, "chunked", 151_904),
    ((176, 256), 1, 0, "chunked", 224_064),
    ((80, 80), 1, 0, "whole", 94_144),
])
def test_plan_mirrors_the_kernel(templ, lanes, passes, plan, nbytes):
    """MegaGeometry.plan: csrc/mega_body.cuh plan_of and the plan's dynamic
    shared memory; the chunked plan's chunks are stage_rows'."""
    g = MegaGeometry((1080, 1920), templ, pvot_torch.TrackerConfig())
    got = g.plan(lanes, passes)
    assert (got.name, got.smem_bytes, got.stage_rows) == (plan, nbytes, g.stage_rows(lanes))
    assert got.smem_bytes <= SMEM_LIMIT
    if plan == "resident":
        assert got.smem_bytes == resident_smem_bytes(*templ, lanes)


def test_launches_by_plan_start_at_zero():
    """Each chunk wrapper counts its launches by plan beside its tiers, and
    reset_launches zeroes both."""
    wrappers = (mega_track_chunk, mega_track_chunk_multi, mega_track_chunk_objects)
    reset_launches(*wrappers)
    for w in wrappers:
        assert PLANS == ("whole", "resident", "chunked")
        assert w.launches_by_plan == dict.fromkeys(PLANS, 0)
        assert w.launches == 0 and set(w.launches_by_tier.values()) == {0}


def test_stage_rows_keep_room_for_static_shared_memory():
    """The dynamic plan stays 3 KB below the block's 227 KB, for the chunk
    kernel's static shared memory: a 104x221 template, whose whole plan
    takes 232,384 bytes, stages in chunks."""
    assert SMEM_LIMIT == 232_448 - 3072
    g = MegaGeometry((720, 1280), (104, 221), pvot_torch.TrackerConfig())
    assert g.stage_rows() < 104 and g.smem_bytes() <= SMEM_LIMIT


def test_plain_chunk_160_template_matches_jax():
    """The repaired envelope on the plain K1: a 160x160 template, which the
    port raised on before."""
    frames, st, start = _clip(4, h=200, w=260, t=160, seed=9)
    kw = dict(search_radius_x=6, search_radius_y=6)
    js, jo = jax_track_video(frames[1:], st, JaxConfig(**kw), strategy="fused",
                             backend="xla", chunk_size=4)
    s = state_from_numpy(start, device="cpu")
    rows, tpl = mega_track_chunk_reference(
        torch.from_numpy(frames[1:]), torch.stack(list(s.bbox)), s.template, s.t_mean,
        s.t_std, s.lost_count, s.use_global, 4, pvot_torch.TrackerConfig(**kw))
    assert jo.updated.any()
    _assert_rows(rows, jo, n_px=160 * 160)
    np.testing.assert_allclose(tpl.numpy(), np.asarray(js.template), atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_multi_kernel_matches_plain_and_k1(streams, cuda_device):
    frames, args = _multi_args(streams)
    frames = frames.to(cuda_device)
    args = tuple(a.to(cuda_device) for a in args)
    cfg = pvot_torch.TrackerConfig(**KW)
    before = mega_track_chunk_multi.launches
    rows, tpl = mega_track_chunk_multi(frames, *args, N_VALID, cfg)
    assert mega_track_chunk_multi.launches == before + 1  # one launch a chunk
    want_rows, want_tpl = mega_track_chunk_multi_reference(frames, *args, N_VALID, cfg)
    for s in range(4):
        r = rows[s].cpu().numpy()
        w = want_rows[s].cpu().numpy()
        for lane in (0, 1, 2, 3, O_UPDATED, O_LOST, O_USEG, O_GUSED):
            np.testing.assert_array_equal(r[:, lane], w[:, lane])
        np.testing.assert_allclose(r[:, O_SCORE], w[:, O_SCORE], atol=2e-3)
        # Each stream's records are K1's on that stream, bit for bit.
        k1 = mega_track_chunk(frames[s], *(a[s] for a in args), N_VALID[s], cfg)
        assert torch.equal(k1[0], rows[s])
    np.testing.assert_allclose(tpl.cpu().numpy(), want_tpl.cpu().numpy(), atol=1e-6)


@pytest.mark.cuda
def test_cuda_chunked_staging_matches_k1(cuda_device):
    """A 176x256 template stages half by half for one stream and in quarters
    for 200 (their lane table takes the room): each stream's records and
    template are still K1's, bit for bit."""
    from pvot_torch.bench import state_at
    from pvot_torch.io.synthetic import SyntheticSpec as TorchSpec
    from pvot_torch.io.synthetic import generate_gray_video as torch_video

    spec = TorchSpec(width=270, height=200, num_frames=4, target_w=256, target_h=176, seed=9)
    frames = torch_video(spec)
    cfg = pvot_torch.TrackerConfig(search_radius_x=6, search_radius_y=6)
    g = MegaGeometry((200, 270), (176, 256), cfg)
    assert g.stage_rows(1) == 88 and g.stage_rows(200) < 88
    s = state_at(spec, frames, 0, cuda_device)
    one = (torch.stack(list(s.bbox)), s.template, s.t_mean, s.t_std, s.lost_count,
           s.use_global)
    clip = torch.from_numpy(frames[1:]).to(cuda_device)
    k1 = mega_track_chunk(clip, *one, 3, cfg)
    many = tuple(v.expand(200, *v.shape).contiguous() for v in one)
    rows, tpl = mega_track_chunk_multi(clip.expand(200, *clip.shape), *many, [3] * 200, cfg)
    assert torch.equal(rows, k1[0].expand_as(rows)) and torch.equal(tpl, k1[1].expand_as(tpl))
    # Both plans are the chunked one (test_plan_mirrors_the_kernel's bytes).
    assert g.plan(1).name == g.plan(200).name == "chunked"


@pytest.mark.cuda
def test_cuda_resident_plan_matches_k1(cuda_device):
    """The resident plan at 1080p / 160 x 160 / r160, all local: 4 streams in
    one launch, each stream's records and template K1's on it alone, bit for
    bit, both launches counted as resident; and within the plain version's
    contract."""
    rng = np.random.default_rng(31)
    base = rng.integers(0, 256, (1080 + 8, 1920 + 8), np.uint8)
    clip = np.stack([base[f : f + 1080, f : f + 1920] for f in range(7)])
    cfg = pvot_torch.TrackerConfig(search_radius_x=160, search_radius_y=160)
    assert MegaGeometry((1080, 1920), (160, 160), cfg).plan(4).name == "resident"
    states = [init_state(gray_u8_to_f32(clip[0])[y : y + 160, x : x + 160], (x, y, 160, 160),
                         device=cuda_device)
              for x, y in ((300, 200), (900, 200), (1500, 600), (400, 800))]
    st = stack_states(states)
    args = (torch.stack(list(st.bbox), dim=-1), st.template, st.t_mean, st.t_std,
            st.lost_count, st.use_global)
    frames = torch.from_numpy(clip[1:]).to(cuda_device)
    before = (mega_track_chunk_multi.launches_by_plan["resident"],
              mega_track_chunk.launches_by_plan["resident"])
    rows, tpl = mega_track_chunk_multi(frames.expand(4, *frames.shape), *args, [6] * 4, cfg)
    want_rows, want_tpl = mega_track_chunk_multi_reference(frames.expand(4, *frames.shape),
                                                           *args, [6] * 4, cfg)
    for lane in (0, 1, 2, 3, O_UPDATED, O_LOST, O_USEG, O_GUSED):
        np.testing.assert_array_equal(rows[..., lane].cpu().numpy(),
                                      want_rows[..., lane].cpu().numpy())
    np.testing.assert_allclose(rows[..., O_SCORE].cpu().numpy(),
                               want_rows[..., O_SCORE].cpu().numpy(), atol=1e-5 * 4)
    np.testing.assert_allclose(tpl.cpu().numpy(), want_tpl.cpu().numpy(), atol=1e-6)
    for s in range(4):
        k1 = mega_track_chunk(frames, *(a[s] for a in args), 6, cfg)
        assert torch.equal(k1[0], rows[s]) and torch.equal(k1[1], tpl[s])
    assert (mega_track_chunk_multi.launches_by_plan["resident"],
            mega_track_chunk.launches_by_plan["resident"]) == (before[0] + 1, before[1] + 4)
