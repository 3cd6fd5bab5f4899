"""The traffic generator: seeded, seamless loops, distinct clips and
targets, paths inside the area of whole search windows."""

import numpy as np
import pytest
import torch

from pvbench import harness
from pvbench.traffic import scene
from pvbench.tests.conftest import BENCH, CELLS, small_cell


@pytest.mark.parametrize("cell", CELLS)
def test_paths_loop_without_a_seam(cell):
    c = harness.load_cell(cell, BENCH)
    per = c.mix["period"]
    b = scene.boxes(c.config, c.mix)
    # Frame `period` (frame 0 of the next lap) is frame 0, and a path started
    # k frames along is the same path rolled by k.
    assert np.array_equal(scene.boxes(c.config, c.mix, phase=per), b)
    assert np.array_equal(scene.boxes(c.config, c.mix, phase=40), np.roll(b, -40, axis=0))
    step = np.abs(np.diff(np.concatenate([b, b[:1]]), axis=0))[..., :2]
    assert step.max() <= 3  # px a frame, the seam included


@pytest.mark.parametrize("cell", CELLS)
def test_every_search_window_stays_whole(cell):
    c = harness.load_cell(cell, BENCH)
    (h, w), (th, tw) = c.config["frame"], c.config["template"]
    rx, ry = (c.config["tracker"][k] for k in ("search_radius_x", "search_radius_y"))
    b = scene.boxes(c.config, c.mix)
    cx, cy = b[..., 0] + tw // 2, b[..., 1] + th // 2
    assert (cx - rx - tw // 2 >= 0).all() and (cx + rx - tw // 2 <= w - tw).all()
    assert (cy - ry - th // 2 >= 0).all() and (cy + ry - th // 2 <= h - th).all()
    # Targets of one frame never overlap.
    k = b.shape[1]
    for i in range(k):
        for j in range(i + 1, k):
            apart = ((np.abs(b[:, i, 0] - b[:, j, 0]) >= tw)
                     | (np.abs(b[:, i, 1] - b[:, j, 1]) >= th))
            assert apart.all()


def test_clips_are_seeded_and_distinct():
    c = small_cell("objects8-1080p-serve")
    cpu = torch.device("cpu")
    a, truth = scene.make_clip(c.config, c.mix, 12345678901, 0, 0, cpu)
    b, _ = scene.make_clip(c.config, c.mix, 12345678901, 0, 0, cpu)
    other, _ = scene.make_clip(c.config, c.mix, 12345678901, 1, 0, cpu)
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert a.shape == (c.mix["period"], *c.config["frame"]) and a.dtype == torch.uint8
    th, tw = c.config["template"]
    x0, y0 = truth[0, 0, :2]
    x1, y1 = truth[0, 1, :2]
    t0 = a[0, y0 : y0 + th, x0 : x0 + tw].float()
    t1 = a[0, y1 : y1 + th, x1 : x1 + tw].float()
    assert (t0 - t1).abs().mean() > 40  # two textures, not one
    # The target moves with its box: frame 5's patch is frame 0's, noise aside.
    x5, y5 = truth[5, 0, :2]
    assert (a[5, y5 : y5 + th, x5 : x5 + tw].float() - t0).abs().mean() < 4
