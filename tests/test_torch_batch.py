"""The chunk kernels' look-ahead batch cadence (pvot/ops/ncc_mega.py:262-311)
against the JAX package on the same numpy inputs.

The plain K1 at batch 4 against JAX's mega kernel in Pallas interpret mode
on a re-acquisition probe clip (a scored frame that rejects, one that
re-acquires, look-ahead rows and frames past n_full); the drivers
(track_video_mega at batch 4 and 3, track_streams_mega at batch 2 per
stream, track_stream_batched on the mega route) against JAX's batched scan
path, pvot.tracker.scan.track_video_batched, as tests/test_mega.py:956-982
holds JAX's own mega batch mode, leftover tails included.  Contract:
bboxes and flags exactly, accepted scores within 1e-5, all within 2e-3,
templates within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.ops.ncc_mega import mega_track_chunk as jax_chunk
from pvot.tracker.mega import _global_probe_clip
from pvot.tracker.scan import track_video_batched as jax_track_video_batched
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.config import TrackerConfig
from pvot_torch.convert import state_from_numpy
from pvot_torch.parallel.multi import stack_states
from pvot_torch.ops.ncc_mega import (
    O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, chunk_launches, mega_track_chunk,
    score_grid,
    mega_track_chunk_reference,
)

KW = dict(search_radius_x=8, search_radius_y=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox))
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated))
    np.testing.assert_array_equal(got.used_global, np.asarray(want.used_global))
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)


def test_chunk_launches():
    """One cooperative launch a chunk (csrc/ncc_mega.cu launch_chunk): its
    blocks walk every scored frame step and write the look-ahead rows too,
    whatever the frames and the cadence."""
    assert chunk_launches(8) == 1
    assert chunk_launches(8, 4) == 1
    assert chunk_launches(7, 4) == 1
    assert chunk_launches(3, 4) == 1
    assert chunk_launches(9, 3) == 1
    assert chunk_launches(512) == 1


@pytest.mark.parametrize("per_sm,n_sms,grid", [(2, 132, 264), (1, 132, 132), (3, 114, 342)])
def test_score_grid_is_every_resident_block(per_sm, n_sms, grid):
    """A chunk launch's grid is the kernel's blocks an SM (from the occupancy
    of its shared-memory plan) times the SMs: the most a cooperative launch
    takes."""
    assert score_grid(per_sm, n_sms) == grid


def test_score_grid_raises_when_no_block_fits():
    with pytest.raises(RuntimeError, match="0 blocks an SM"):
        score_grid(0, 132)


def test_plain_k1_batch_matches_jax_kernel():
    """12 frames, n_valid 11, batch 4 (n_full 8): frame 3 scores globally on
    noise and rejects, frame 7 re-acquires the pasted target, frames 8-11 are
    look-ahead rows past n_full."""
    f, h, w, t = 12, 60, 140, 8
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (f + 1, h, w), np.uint8)
    st = _global_probe_clip(frames, (t, t))
    cfg = dict(search_radius_x=6, search_radius_y=6)
    rows, tpl = jax_chunk(
        jnp.asarray(frames[1:]), jnp.stack([st.bbox_x, st.bbox_y, st.bbox_w, st.bbox_h]),
        st.template, st.t_mean, st.t_std, st.lost_count, st.use_global, jnp.int32(f - 1),
        frame_shape=(h, w), templ_shape=(t, t), config=JaxConfig(**cfg), interpret=True,
        batch=4, inkernel_global=True,
    )
    want = np.asarray(rows)[:, :10]
    s = state_from_numpy(_np_state(st), "cpu")
    got, got_tpl = mega_track_chunk_reference(
        torch.from_numpy(frames[1:]), torch.stack(list(s.bbox)), s.template, s.t_mean,
        s.t_std, s.lost_count, s.use_global, f - 1, TrackerConfig(**cfg), batch=4)
    got = got.numpy()
    scored = np.zeros(f, bool)
    scored[[3, 7]] = True
    assert (want[3, O_GUSED] and not want[3, O_UPDATED]) and want[7, O_UPDATED]
    assert (want[~scored, O_SCORE] == -1.0).all() and not want[~scored, O_UPDATED].any()
    for lane in (0, 1, 2, 3, O_UPDATED, O_LOST, O_USEG, O_GUSED):
        np.testing.assert_array_equal(got[:, lane], want[:, lane], err_msg=str(lane))
    np.testing.assert_allclose(got[:, O_SCORE], want[:, O_SCORE], atol=2e-3)
    np.testing.assert_allclose(got[7, O_SCORE], want[7, O_SCORE], atol=1e-5)
    np.testing.assert_allclose(got_tpl.numpy(), np.asarray(tpl), atol=1e-6)


@pytest.fixture(scope="module")
def clip():
    """23 tracked frames of a 160x120 clip with a 16x16 target (noisy, as
    tests/test_mega.py's batch clip), the start state as numpy."""
    spec = SyntheticSpec(width=160, height=120, num_frames=24, target_w=16, target_h=16,
                         seed=3, noise_std=1.0)
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
                        (x, y, w, h))
    return frames, st


@pytest.mark.parametrize("batch", [4, 3])
def test_track_video_mega_batch_matches_jax_batched(clip, batch):
    """Chunks of 8 frames cut to batch boundaries (8 or 6): batch 4 gives 5
    full batches and 3 leftover frames, batch 3 gives 7 and 2.  JAX sends a
    batch that is not a power of two to track_video_batched; the port runs it
    in the kernel, and must land where that fallback lands."""
    frames, st = clip
    want_state, want = jax_track_video_batched(frames[1:], st, JaxConfig(**KW),
                                               batch_size=batch, backend="xla")
    got_state, got = pvot_torch.track_video_mega(
        frames[1:], state_from_numpy(_np_state(st), "cpu"), TrackerConfig(**KW),
        chunk_size=8, batch=batch)
    assert got.bbox.shape == (23, 4)
    _assert_outputs(got, want)
    assert (got.score[: batch - 1] == -1.0).all()
    assert int(got_state.bbox_x) == int(want_state.bbox_x)
    assert int(got_state.lost_count) == int(want_state.lost_count)
    np.testing.assert_allclose(got_state.template.numpy(), np.asarray(want_state.template),
                               atol=1e-6)


def test_track_streams_mega_batch_matches_jax_per_stream(clip):
    """Three streams cut from the clip at frames 0, 1 and 2, each from the
    target's box there, at batch 2, chunk 5 (cut to 4): each stream's
    records are JAX's batched scan path on it alone."""
    frames, st = clip
    spec = SyntheticSpec(width=160, height=120, num_frames=24, target_w=16, target_h=16,
                         seed=3, noise_std=1.0)
    videos = np.stack([frames[1:22], frames[2:23], frames[3:24]])
    starts = [st]
    for i in (1, 2):
        x, y, w, h = target_bbox(spec, i)
        starts.append(jax_init_state(jnp.asarray(gray_u8_to_f32(frames[i])[y : y + h,
                                                                             x : x + w]),
                                     (x, y, w, h)))
    states = stack_states(
        [state_from_numpy(_np_state(s), "cpu") for s in starts], "cpu")
    _, got = pvot_torch.track_streams_mega(videos, states, TrackerConfig(**KW), chunk_size=5,
                                           batch=2, device="cpu")
    assert got.bbox.shape == (21, 3, 4)
    for s in range(3):
        _, want = jax_track_video_batched(videos[s], starts[s], JaxConfig(**KW), batch_size=2,
                                          backend="xla")
        _assert_outputs(type(got)(*(v[:, s] for v in got)), want)


def test_track_stream_batched_mega_route_matches_jax(clip):
    """--batch=4 --mega through the frame pipeline: chunks of 4 x 2 frames,
    each one track_video_mega(batch=4) call, the last with the leftover."""
    from pvot_torch.io.pipeline import track_stream_batched

    frames, st = clip
    _, want = jax_track_video_batched(frames[1:], st, JaxConfig(**KW), batch_size=4,
                                      backend="xla")
    before = mega_track_chunk.launches
    _, got = track_stream_batched(iter(frames[1:]), state_from_numpy(_np_state(st), "cpu"),
                                  frames.shape[1:], TrackerConfig(**KW), batch_size=4,
                                  backend="mega", chunks_per_dispatch=2)
    assert mega_track_chunk.launches == before  # the plain version on the CPU
    _assert_outputs(got, want)


def test_batch_must_be_a_positive_integer(clip):
    frames, st = clip
    for bad in (0, 2.5):
        with pytest.raises(ValueError, match="batch"):
            pvot_torch.track_video_mega(frames[1:3], state_from_numpy(_np_state(st), "cpu"),
                                        TrackerConfig(**KW), batch=bad)
