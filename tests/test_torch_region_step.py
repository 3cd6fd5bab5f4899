"""The region-step ladder (pvot_torch/tools/region_step_breakdown.py, the
port of tools/region_step_breakdown.py) on the CPU at a tiny size: every
rung runs over every frame, and the full rung's records equal track_video's
on the plain engine."""

import numpy as np
import pytest

from pvot_torch.config import TrackerConfig
from pvot_torch.tools import region_step_breakdown as rsb
from pvot_torch.tracker.scan import track_video

CONFIG = TrackerConfig(search_radius_x=6, search_radius_y=6)
F = 12


@pytest.fixture(scope="module")
def clip():
    return rsb.make_clip(width=160, height=120, templ=16, num_frames=F)


@pytest.mark.parametrize("backend", rsb.BACKENDS)
def test_every_rung_runs_and_full_is_track_video(clip, backend):
    spec, frames = clip
    state = rsb.start_state(spec, frames, "cpu")
    lad = rsb.Ladder(frames, state, CONFIG, backend, chunk=5, device="cpu")
    outs = {rung: lad.run(rung) for rung in rsb.RUNGS}
    assert all(len(out.bbox) == F for out in outs.values())
    want = track_video(frames[1:], state, CONFIG, backend=backend)[1]
    for got, w in zip(outs["full"], want):
        np.testing.assert_array_equal(got, w)
    # The EMA rungs accept every frame at the current box; empty moves nothing.
    assert outs["ema_only"].updated.all() and (outs["ema_only"].bbox == state_box(state)).all()
    assert (outs["empty"].bbox == state_box(state)).all()


def state_box(state):
    return np.array([int(v) for v in state.bbox], np.int32)


def test_ladder_summary_on_the_cpu(clip, capsys):
    res = rsb.ladder("shared", F, 4, "cpu", clip, CONFIG)
    assert list(res["rungs"]) == list(rsb.RUNGS)
    assert res["full_equals_track_video"] and res["diffs"] == {}
    assert res["no_counterpart"] == {"build_only": None, "no_build": None}
    assert "us_per_frame" not in capsys.readouterr().out


def test_the_ladder_takes_only_the_cuda_engines(clip):
    spec, frames = clip
    with pytest.raises(ValueError, match="CUDA engine"):
        rsb.Ladder(frames, rsb.start_state(spec, frames, "cpu"), CONFIG, "xla", 4, "cpu")
