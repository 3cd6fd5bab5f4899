"""The whole slice against the JAX semantic oracle.

pvot_torch.track_video_mega (on the CPU, so through the chunk kernel's plain
version) and pvot_torch.track_video (the per-frame oracle) against JAX
pvot.tracker.scan.track_video(backend="xla"), from bit-identical start states
(pvot_torch.convert), on the conftest clips.  Equality contract as
pvot/tracker/mega.py _outputs_equal: bbox, updated and used_global exactly;
accepted scores within 1e-5, all scores within 2e-3.  Final states: ints and
flags exactly, template and its stats within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import target_bbox
from pvot.tracker.scan import track_video as jax_track_video
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.convert import state_from_numpy, state_to_numpy

# The re-entry clip's target is away for 20 frames; a threshold of 5 sends
# the tracker into global search and back.
CONFIGS = {"small": {}, "reenter": {"lost_frame_threshold": 5}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(small_spec, small_video, reenter_spec, reenter_video):
    """name -> (frames, start state as numpy, config kwargs, JAX state, JAX out)."""
    out = {}
    for name, spec, frames in (("small", small_spec, small_video),
                               ("reenter", reenter_spec, reenter_video)):
        x, y, w, h = target_bbox(spec, 0)
        st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
                            (x, y, w, h))
        kw = CONFIGS[name]
        js, jo = jax_track_video(frames[1:], st, JaxConfig(**kw), backend="xla",
                                 chunk_size=16)
        start = {k: np.asarray(v) for k, v in st._asdict().items()}
        out[name] = (frames, start, kw, {k: np.asarray(v) for k, v in js._asdict().items()}, jo)
    return out


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


def test_reenter_case_exercises_global_search(cases):
    jo = cases["reenter"][4]
    assert jo.used_global.any() and (jo.used_global & jo.updated).any()
    assert cases["small"][4].updated.all()


# 39 and 59 tracked frames: chunks that divide them (13, 59) and that do
# not (16).
@pytest.mark.parametrize("name,chunk", [("small", 13), ("small", 16),
                                        ("reenter", 59), ("reenter", 16)])
def test_track_video_mega_matches_jax(cases, name, chunk):
    frames, start, kw, want_state, want = cases[name]
    state = state_from_numpy(start)
    got_state, got = pvot_torch.track_video_mega(
        frames[1:], state, pvot_torch.TrackerConfig(**kw), chunk_size=chunk, device="cpu"
    )
    assert got.bbox.shape == (len(frames) - 1, 4)
    _assert_outputs(got, want)
    _assert_state(got_state, want_state)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_track_video_matches_jax(cases, name):
    frames, start, kw, want_state, want = cases[name]
    got_state, got = pvot_torch.track_video(
        frames[1:], state_from_numpy(start), pvot_torch.TrackerConfig(**kw), device="cpu"
    )
    _assert_outputs(got, want)
    _assert_state(got_state, want_state)


def test_init_state_matches_jax(cases):
    frames, start, _, _, _ = cases["small"]
    roi = tuple(int(start[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h"))
    x, y, w, h = roi
    st = pvot_torch.init_state(gray_u8_to_f32(frames[0])[y : y + h, x : x + w], roi)
    got = state_to_numpy(st)
    np.testing.assert_array_equal(got["template"], start["template"])
    np.testing.assert_allclose([got["t_mean"], got["t_std"]],
                               [start["t_mean"], start["t_std"]], atol=1e-6)
    with pytest.raises(ValueError, match="template shape"):
        pvot_torch.init_state(np.zeros((3, 4), np.float32), (0, 0, 3, 4))


def test_state_numpy_round_trip(cases):
    _, start, _, _, _ = cases["reenter"]
    d = dict(start, use_global=np.bool_(True), lost_count=np.int32(7))
    st = state_from_numpy(d)
    assert st.template.dtype == torch.float32 and st.bbox_x.dtype == torch.int32
    assert st.use_global.dtype == torch.bool
    back = state_to_numpy(st)
    assert back.keys() == d.keys()
    for k, v in d.items():
        assert np.asarray(back[k]).tobytes() == np.asarray(v).tobytes(), k
        assert back[k].dtype == np.asarray(v).dtype, k


def test_empty_clip(cases):
    frames, start, _, _, _ = cases["small"]
    st, out = pvot_torch.track_video_mega(frames[:0], state_from_numpy(start), device="cpu")
    assert out.bbox.shape == (0, 4) and out.score.shape == (0,)
    assert int(st.bbox_x) == int(start["bbox_x"])
