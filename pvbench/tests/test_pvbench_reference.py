"""The plain reference against the port's own CPU path at a small size (the
test may import both; the reference itself imports nothing of the port)."""

import numpy as np
import pytest
import torch

from pvbench.reference import tracker as ref
from pvbench.traffic import scene
from pvbench.tests.conftest import small_cell


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10 - 2**-12, 3.0])
    y = ref.tf32_round(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2**-9, -1.0 - 2**-10, 3.0]
    r = torch.rand(1000) * 4 - 2
    assert ((ref.tf32_round(r) - r).abs() <= r.abs() * 2**-11).all()


def test_correlate_matches_conv2d():
    g = torch.Generator().manual_seed(3)
    region = torch.rand((2, 30, 41), generator=g)
    tc = torch.rand((2, 9, 13), generator=g) - 0.5
    want = torch.stack([torch.nn.functional.conv2d(region[i][None, None].double(),
                                                   tc[i][None, None].double())[0, 0]
                        for i in range(2)])
    got = ref.correlate(region, tc)
    assert got.shape == (2, 22, 29)
    assert (got.double() - want).abs().max() < 1e-5
    old = ref._BLOCK_ELEMS
    try:  # the same in blocks of rows
        ref._BLOCK_ELEMS = 2 * 29 * 13 * 12
        assert torch.equal(ref.correlate(region, tc), got)
    finally:
        ref._BLOCK_ELEMS = old


@pytest.mark.parametrize("lost", [False, True])
def test_reference_tracks_as_the_port_cpu_path(lost):
    """Three streams of the small streams cell through the port's
    track_streams_mega on the CPU and through the reference: the same boxes,
    flags and templates, scores within float32 rounding.  With `lost`, one
    tracker starts far from its target and goes through the lost count
    into the global search."""
    from pvot_torch.config import TrackerConfig
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.tracker.mega import track_streams_mega
    from pvot_torch.tracker.state import init_state

    cell = small_cell("streams16-720p-ondevice")
    cfg = dict(cell.config["tracker"])
    if lost:
        cfg.update(lost_frame_threshold=3)
    p = ref.Params.from_config(dict(cell.config, tracker=cfg))
    cpu = torch.device("cpu")
    per, n = cell.mix["period"], 24
    clips, truth = zip(*(scene.make_clip(cell.config, cell.mix, 5, s, 10 * s, cpu)
                         for s in range(3)))
    clips = torch.stack(clips)
    lanes = [ref.initial_lane(clips[s, per - 1], truth[s][per - 1, 0]) for s in range(3)]
    if lost:  # tracker 2 starts on its template, at the wrong place
        lanes[2].bbox = [0, 0, p.tw, p.th]
    states = stack_states([init_state(ln.template, tuple(ln.bbox), device=cpu) for ln in lanes],
                          cpu)
    final, out = track_streams_mega(clips[:, :n], states, TrackerConfig(**cfg), chunk_size=8)
    recs = ref.track(lambda t: clips[:, t], n, lanes, p)
    assert np.array_equal(out.bbox, np.rint(recs[..., :4]).astype(np.int32))
    assert np.array_equal(out.updated, recs[..., 5] != 0)
    assert np.array_equal(out.used_global, recs[..., 6] != 0)
    assert np.abs(out.score - recs[..., 4]).max() < 1e-5
    assert out.used_global.any() == lost
    for s in range(3):
        assert torch.equal(final.template[s], lanes[s].template)
        assert int(final.lost_count[s]) == lanes[s].lost
        assert bool(final.use_global[s]) == lanes[s].use_global
