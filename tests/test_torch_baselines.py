"""The baselines of the port (pvot_torch.models.flow, pvot_torch.models.csrt)
and `cross_correlate_conv1d`, held to the JAX package's on the same seeded
inputs.  Everything runs on the CPU; the flow tracker's run on the card is
chip_smoke.py's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pvot.models.flow as jflow
from pvot.io.synthetic import SyntheticSpec, generate_bgr_frames, generate_gray_video, target_bbox
from pvot.ops.ncc_matmul import cross_correlate_conv1d as jax_conv1d
import pvot_torch.models.flow as tflow
from pvot_torch.ops.ncc_matmul import cross_correlate, cross_correlate_conv1d

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the tier-1 run's
    workers share the host's cores, and a pool of threads a worker would
    crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _smoothed_noise():
    """tests/test_baselines.py:31's input: noise smoothed by a 5 x 5 box mean,
    and the same image shifted by (dx, dy) = (3, 2)."""
    base = np.random.default_rng(0).random((96, 128)).astype(np.float32)
    base = np.asarray(jflow._box_mean(jnp.asarray(base), 5))
    return base, np.roll(np.roll(base, 2, axis=0), 3, axis=1)


def _flow_cases():
    rng = np.random.default_rng(1)
    prev, curr = _smoothed_noise()
    flow = (rng.random((2, 96, 128)).astype(np.float32) - 0.5) * 20
    coarse = (rng.random((2, 48, 64)).astype(np.float32) - 0.5) * 6
    return {
        "box_mean": ((rng.random((96, 128)).astype(np.float32), 7), {}),
        "downsample2": ((rng.random((96, 128)).astype(np.float32),), {}),
        "upsample2_flow": ((coarse, (95, 127)), {}),
        "warp": ((prev, flow), {}),
        "lk_refine": ((prev, curr, flow * 0.1, 7), {}),
        "dense_flow": ((prev, curr), {}),
    }


# Measured on these inputs: max |port - JAX| 0.0 for every function (the
# port is bit-equal to JAX's eager functions on the CPU at these shapes).
@pytest.mark.parametrize("name", sorted(_flow_cases()))
def test_flow_functions_match_jax(name):
    args, kw = _flow_cases()[name]
    fn = "dense_flow" if name == "dense_flow" else f"_{name}"
    want = np.asarray(getattr(jflow, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                           for a in args], **kw))
    got = getattr(tflow, fn)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args],
                             **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if name == "dense_flow":  # Farneback's convention: the flow is the shift
        np.testing.assert_allclose(np.median(got[:, 20:-20, 20:-20], axis=(1, 2)), [3, 2],
                                   atol=0.75)


def test_masked_upper_median_matches_jax():
    """tests/test_baselines.py:20's cases, exactly: nth_element(size / 2)."""
    vals = np.array([5.0, 1.0, 3.0, 2.0], np.float32)
    for mask in (np.ones(4, bool), np.array([True, False, True, False]), np.zeros(4, bool)):
        want = float(jflow.masked_upper_median(jnp.asarray(vals), jnp.asarray(mask)))
        got = tflow.masked_upper_median(_t(vals), _t(mask))
        assert got.ndim == 0 and float(got) == want
    assert [float(tflow.masked_upper_median(_t(vals), _t(m))) for m in
            (np.ones(4, bool), np.array([True, False, True, False]), np.zeros(4, bool))] == [
                3.0, 5.0, 0.0]


FLOW_CLIPS = {
    # tests/test_baselines.py:45's clip: gentle motion, the box follows it.
    "follows": (dict(width=256, height=192, num_frames=20, target_w=32, target_h=32, seed=3,
                     amplitude=0.08, noise_std=0.0), None),
    # A scrolling background carries the box into the frame's left edge,
    # where it is clamped (and the dynamic slice with it).
    "left_edge": (dict(width=128, height=96, num_frames=16, target_w=24, target_h=24, seed=3,
                       amplitude=0.3, noise_std=0.0, background_scroll=2.0), (6, 8, 24, 24)),
}


@pytest.mark.parametrize("clip", sorted(FLOW_CLIPS))
def test_track_video_flow_matches_jax(clip):
    kw, roi = FLOW_CLIPS[clip]
    spec = SyntheticSpec(**kw)
    video = generate_gray_video(spec)
    roi = roi or target_bbox(spec, 0)
    jstate, want = jflow.track_video_flow(video, roi, chunk_size=8)
    state, got = tflow.track_video_flow(video, roi, chunk_size=8, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(video) - 1, 4)
    np.testing.assert_array_equal(got, want)
    assert {t.device.type for t in state} == {"cpu"}
    assert (int(state.bbox_x), int(state.bbox_y)) == (int(jstate.bbox_x), int(jstate.bbox_y))
    np.testing.assert_array_equal(state.prev_gray.numpy(), np.asarray(jstate.prev_gray))
    if clip == "follows":
        for i, b in enumerate(got):
            gx, gy, _, _ = target_bbox(spec, i + 1)
            assert abs(int(b[0]) - gx) <= 8 and abs(int(b[1]) - gy) <= 8
    else:
        assert (got[:, 0] == 0).sum() >= 10, "the box never met the frame's edge"


def test_track_video_flow_defaults_to_the_card():
    """Without a device the flow tracker runs on the CUDA device, and raises
    on a machine without one; it never picks the CPU on its own."""
    video = np.zeros((3, 32, 32), np.uint8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tflow.track_video_flow(video, (4, 4, 8, 8))


def test_cross_correlate_conv1d_matches():
    """pvot/ops/ncc_matmul.py:78 against JAX's and against the port's im2col
    formulation, as tests/test_ncc_matmul.py:122 holds JAX's two."""
    rng = np.random.default_rng(0)
    img = rng.random((64, 96), dtype=np.float32)
    templ = rng.random((16, 16), dtype=np.float32) - 0.5
    got = cross_correlate_conv1d(_t(img), _t(templ)).numpy()
    want = np.asarray(jax_conv1d(jnp.asarray(img), jnp.asarray(templ)))
    assert got.shape == (49, 81)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, cross_correlate(_t(img), _t(templ)).numpy(), rtol=0,
                               atol=1e-5)


def test_csrt_baseline_tracks_like_jax():
    """tests/test_baselines.py:64's frames through both packages.  This
    OpenCV has no CSRT, so both take TrackerMIL, whose boxes differ from run
    to run even within one package (seeding OpenCV does not fix them): each
    is held to the ground truth within test_baselines.py:79's 8 px."""
    from pvot.models.csrt import track_video_csrt as jax_csrt
    from pvot_torch.models.csrt import track_video_csrt

    spec = SyntheticSpec(width=256, height=192, num_frames=12, target_w=32, target_h=32,
                         seed=3, amplitude=0.2)
    frames = np.stack(list(generate_bgr_frames(spec)))
    roi = target_bbox(spec, 0)
    gx, gy, _, _ = target_bbox(spec, 11)
    for run in (jax_csrt, track_video_csrt):
        boxes, timer = run(frames.copy(), roi)
        assert boxes.shape == (11, 4) and boxes.dtype == np.int32
        assert abs(int(boxes[-1][0]) - gx) <= 8 and abs(int(boxes[-1][1]) - gy) <= 8
        assert timer.totals["track"] > 0


def test_load_or_decode_reads_the_cache(tmp_path):
    from pvot.models.csrt import load_or_decode as jax_load
    from pvot_torch.io.video import save_cached_video
    from pvot_torch.models.csrt import load_or_decode

    frames = np.random.default_rng(2).integers(0, 256, (3, 8, 10, 3), np.uint8)
    cache = str(tmp_path / "clip.raw")
    save_cached_video(cache, frames)
    got = load_or_decode(str(tmp_path / "absent.mp4"), cache)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(got, jax_load(str(tmp_path / "absent.mp4"), cache))
