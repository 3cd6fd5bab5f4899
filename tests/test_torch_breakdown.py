"""K1's rung ladder (pvot_torch.tools.mega_breakdown) against the JAX ladder
and K1's plain version; the CUDA rungs against their plain versions on the
card.

The JAX ladder is tools/mega_breakdown.py `build_rung`, loaded by path and
run in Pallas interpret mode (pallas_call wrapped with interpret=True) at
tests/test_mega.py's geometry: 250x94 frames, a 16x16 template, radius 8, 6
frames of a clip that tracks locally.  Its `full` and `argmax` rungs at
`highest` and `2pass` (four interpret-mode calls, the slow part of this file)
record the bbox x and the best score a frame: the port's plain rungs must
give the same x exactly, the score within 1e-5 and the template within 1e-6.
"""

import functools
import importlib.util
import json
import os

import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from pvot.config import TrackerConfig as JaxConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.ops.ncc_mega import MegaGeometry as JaxGeometry
from pvot.ops.ncc_pallas import _box_operator
from pvot_torch.config import TrackerConfig
from pvot_torch.ops.ncc_mega import O_BX, O_SCORE, mega_track_chunk_reference
from pvot_torch.tools import mega_breakdown as bd
from pvot_torch.tracker.state import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, T, RADIUS = 6, 16, 8
# A slow target (amplitude 0.3 of a 40-frame path): every frame of the first
# F + 1 is found on its local window.
SPEC = SyntheticSpec(width=250, height=94, num_frames=40, target_w=T, target_h=T, seed=3,
                     amplitude=0.3, noise_std=1.0)
CONFIG = TrackerConfig(search_radius_x=RADIUS, search_radius_y=RADIUS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_mega_breakdown", os.path.join(REPO, "tools", "mega_breakdown.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def clip():
    """(frames (F + 1, H, W) u8, the start bbox, its float32 template)."""
    frames = generate_gray_video(SPEC)[: F + 1]
    x, y, w, h = target_bbox(SPEC, 0)
    return frames, (x, y, w, h), gray_u8_to_f32(frames[0])[y : y + h, x : x + w]


def _state(clip, device="cpu"):
    _, roi, template = clip
    return init_state(template, roi, device=device)


@pytest.fixture(scope="module")
def jax_rungs(clip):
    """{(rung, tier): (records (F, 128), template (T, T))} of the JAX ladder
    in interpret mode, its inputs built as its main() builds them."""
    frames, (x, y, w, h), template = clip
    tool = _jax_tool()
    cfg = JaxConfig(search_radius_x=RADIUS, search_radius_y=RADIUS)
    g = JaxGeometry((SPEC.height, SPEC.width), (T, T), cfg)
    framesp = np.pad(frames[1:], ((0, 0), (0, g.pad_h - g.frame_h), (0, g.pad_w - g.frame_w)))
    tpl0 = np.pad(template, ((0, g.rows8 - g.th), (0, g.m_lanes - g.tw)))
    t_mean = float(np.mean(template))
    sf0 = np.asarray([t_mean, float(np.std(template)) + 1e-6,
                      float(np.sum(template - t_mean)), 0, 0, 0, 0, 0], np.float32)
    si0 = np.asarray([x, y, w, h, 0, 0, F, 0], np.int32)
    box = _box_operator(g.tile_lanes, g.tw)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))
        for tier in ("highest", "2pass"):
            for rung in ("argmax", "full"):
                rows, tpl = tool.build_rung(rung, g, cfg, F, tier)(framesp, tpl0, box, sf0, si0)
                out[rung, tier] = (np.asarray(rows).reshape(F, 8, -1)[:, 0],
                                   np.asarray(tpl)[:T, :T])
    return out


def test_the_clip_tracks_locally(clip):
    """Every frame of the clip is accepted on its local window under K1's
    plain version: the JAX ladder, which has no global branch, sees the
    same frames as K1."""
    frames, _, _ = clip
    rows, _ = mega_track_chunk_reference(torch.from_numpy(frames[1:]), *bd._state_args(
        _state(clip), F), CONFIG)
    assert (rows[:, 5] == 1).all() and (rows[:, 9] == 0).all()


@pytest.mark.parametrize("tier", ["highest", "2pass"])
@pytest.mark.parametrize("rung", ["argmax", "full"])
def test_plain_rung_matches_the_jax_ladder(clip, jax_rungs, rung, tier):
    frames, _, template = clip
    rows, tpl = bd.mega_breakdown_reference(rung, torch.from_numpy(frames[1:]), _state(clip),
                                            bd.local_config(CONFIG), tier)
    want_rows, want_tpl = jax_rungs[rung, tier]
    np.testing.assert_array_equal(rows[:, O_BX].numpy(), want_rows[:, 0])
    np.testing.assert_allclose(rows[:, O_SCORE].numpy(), want_rows[:, 4], atol=1e-5)
    if rung == "argmax":  # no EMA: the template is the start's (the JAX rung
        # returns before it writes its template output)
        np.testing.assert_array_equal(tpl.numpy(), template)
    else:
        np.testing.assert_allclose(tpl.numpy(), want_tpl, atol=1e-6)
        assert not np.array_equal(tpl.numpy(), template)


@pytest.mark.parametrize("tier", ["highest", "1pass", "3pass"])
def test_plain_full_rung_is_k1_on_a_local_clip(clip, tier):
    frames, _, _ = clip
    x = torch.from_numpy(frames[1:])
    got = bd.mega_breakdown_reference("full", x, _state(clip), CONFIG, tier)
    want = mega_track_chunk_reference(x, *bd._state_args(_state(clip), F), CONFIG,
                                      **bd.tier_kw(tier))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_walk_rungs_move_the_window_and_write_one_value(clip):
    """A rung before argmax writes records of zeros with its checksum in
    field 4, leaves the template as it was, and its window walks (bx + 1,
    by + (t & 1)): the empty checksum, the sum of the tile origins, grows."""
    frames, _, template = clip
    x = torch.from_numpy(frames[1:])
    for rung in ("empty", "dma", "convert", "score_box", "score"):
        rows, tpl = bd.mega_breakdown_reference(rung, x, _state(clip), CONFIG)
        assert torch.equal(rows[:, [0, 1, 2, 3, 5, 6, 7, 8, 9]], torch.zeros(F, 9)), rung
        assert (rows[:, 4] > 0).all(), rung
        assert np.array_equal(tpl.numpy(), template)
    empty = bd.mega_breakdown_reference("empty", x, _state(clip), CONFIG)[0][:, 4]
    assert (empty[1:] > empty[:-1]).all()


def test_integer_checksums_follow_the_launch_plan():
    """On a constant frame of value v, away from the frame's edges, the
    integer checksums count what each item loads (csrc/mega_body.cuh): a
    17 x 17 window (radius 8) of a 16 x 16 template is 3 x 2 tiles of 8 x 16,
    two items each (one half of the template rows: 8 + 7 input rows of
    16 + 16 columns)."""
    v = 7
    frames = torch.full((2, 94, 250), v, dtype=torch.uint8)
    state = init_state(np.full((T, T), v / 255.0, np.float32), (100, 40, T, T), device="cpu")
    n_loaded = 12 * 15 * 32
    dma = bd.mega_breakdown_reference("dma", frames, state, CONFIG)[0][:, 4]
    assert dma.tolist() == [float(n_loaded * v)] * 2
    bits = int(torch.tensor([v * np.float32(1 / 255)], dtype=torch.float32).view(torch.int32))
    convert = bd.mega_breakdown_reference("convert", frames, state, CONFIG)[0][:, 4]
    assert convert.tolist() == [float((n_loaded * bits) & (2**24 - 1))] * 2
    # Tile origins: window rows 40 + 8 - 8 - 8 = 32 .. 48, columns 92 .. 108
    # at frame 0; the walk moves x by 1 (and y by t & 1 after frame 1).
    origins = sum(2 * (32 + 8 * i + 92 + 16 * j) for i in range(3) for j in range(2))
    empty = bd.mega_breakdown_reference("empty", frames, state, CONFIG)[0][:, 4]
    assert empty.tolist() == [float(origins), float(origins + 12)]


def test_checksums_agree_holds_the_tolerances():
    a = torch.zeros(3, 10)
    a[:, 4] = torch.tensor([1.0, 2.0, 3.0])
    b = a.clone()
    assert bd.checksums_agree("dma", a, b) == 0.0
    b[1, 4] = 2.0 * (1 + 5e-5)
    assert bd.checksums_agree("score", a, b) <= bd.CHECKSUM_RTOL
    with pytest.raises(AssertionError):
        bd.checksums_agree("dma", a, b)
    b[1, 4] = 2.0 * (1 + 5e-4)
    with pytest.raises(AssertionError):
        bd.checksums_agree("score_box", a, b)


def test_wrapper_on_cpu_runs_the_plain_version_and_launches_nothing(clip):
    frames, _, _ = clip
    x = torch.from_numpy(frames[1:])
    before = bd.mega_breakdown_chunk.launches
    got = bd.mega_breakdown_chunk("score", x, _state(clip), CONFIG, "2pass")
    want = bd.mega_breakdown_reference("score", x, _state(clip), CONFIG, "2pass")
    assert torch.equal(got[0], want[0]) and bd.mega_breakdown_chunk.launches == before
    with pytest.raises(ValueError):
        bd.mega_breakdown_chunk("roll", x, _state(clip), CONFIG)


def test_entry_point_on_cpu_prints_checksums_and_no_time(capsys):
    assert bd.main(["--device", "cpu", "--chunk", "1", "--tier", "1pass"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [next(iter(json.loads(ln))) for ln in lines[:7]] == list(bd.RUNGS)
    assert '"deltas": null' in lines[7] and "us_per_frame" not in "".join(lines)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py phase A covers the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(bd.TIERS))
def test_cuda_rungs_match_their_plain_versions(clip, cuda_device, tier):
    from pvot_torch.ops.ncc_mega import mega_track_chunk

    frames, _, _ = clip
    x = torch.from_numpy(frames[1:]).to(cuda_device)
    state = _state(clip, cuda_device)
    for rung in bd.RUNGS:
        got = bd.mega_breakdown_chunk(rung, x, state, CONFIG, tier)
        want = bd.mega_breakdown_reference(rung, x, state, CONFIG, tier)
        if rung in ("argmax", "full"):
            np.testing.assert_array_equal(got[0][:, :4].cpu(), want[0][:, :4])
            np.testing.assert_allclose(got[0][:, 4].cpu(), want[0][:, 4], atol=1e-5)
        else:
            bd.checksums_agree(rung, got[0], want[0])
    full = bd.mega_breakdown_chunk("full", x, state, CONFIG, tier)
    k1 = mega_track_chunk(x, *bd._state_args(state, F), CONFIG, **bd.tier_kw(tier))
    assert torch.equal(full[0], k1[0]) and torch.equal(full[1], k1[1])
