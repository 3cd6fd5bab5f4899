"""The port's bf16 score tiers against the JAX package on the same numpy inputs.

The chunk kernels' plain versions (pvot_torch.ops.ncc_mega) at score_passes
1, 2 and 3 against JAX's mega kernels with highest=False in Pallas interpret
mode, K1 on a re-acquisition probe clip built as tests/test_torch_mega.py
builds its own, at a smaller geometry (140x60, 8x8, r6; each tier is one
JAX compile): global frames that reject, one that re-acquires, then local
tracking, and a frame past n_valid; K2 on two streams and K3 on a bucketed
set; the plain K4/K5 at 3 passes against JAX's operator kernels at
highest=False; the `xla_fast` region scores; the engine path on `pallas_fast`
and `fast` against JAX's `pallas_fast` engine built in interpret mode; the
CLI and serving surfaces.  The contract (pvot/tracker/mega.py
_outputs_equal): bbox, updated, used_global, lost and use_global exactly;
accepted scores within 1e-5, all scores within 2e-3; templates within 1e-6.
The kernels themselves run on the card (chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pvot.config import TrackerConfig as JaxConfig
from pvot.ops.ncc_mega import mega_track_chunk as jax_chunk
from pvot.ops.ncc_mega import mega_track_chunk_multi as jax_chunk_multi
from pvot.ops.ncc_mega import mega_track_chunk_objects as jax_chunk_objects
from pvot.ops.ncc_pallas import ncc_map_pallas as jax_map
from pvot.ops.ncc_pallas import ncc_region_argmax_pallas as jax_argmax
from pvot.ops.search import WindowBounds as JaxBounds
from pvot.tracker.mega import _global_probe_clip
from pvot.tracker.state import init_state as jax_init_state
from pvot_torch.config import TrackerConfig
from pvot_torch.convert import state_from_numpy
from pvot_torch.io.gray import gray_u8_to_f32
from pvot_torch.ops import ncc_pallas as tp
from pvot_torch.ops.ncc_matmul import make_region_fn
from pvot_torch.ops.ncc_mega import (
    O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, mega_track_chunk,
    mega_track_chunk_multi_reference, mega_track_chunk_objects_reference,
    mega_track_chunk_reference,
)
from pvot_torch.ops.ncc_reference import split_bf16, template_stats, tiered_corr
from pvot_torch.ops.search import WindowBounds

F, H, W, T = 8, 60, 140, 8
N_VALID = F - 1
RADIUS = dict(search_radius_x=6, search_radius_y=6)
EXACT = {"bbox": slice(0, 4), "updated": O_UPDATED, "lost": O_LOST,
         "use_global": O_USEG, "used_global": O_GUSED}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bbox(st):
    return jnp.stack([st.bbox_x, st.bbox_y, st.bbox_w, st.bbox_h]).astype(jnp.int32)


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def probe():
    """(frames (F+1, H, W) u8, start state as numpy, {passes: (JAX rows, JAX
    template)}) on the re-acquisition probe clip."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (F + 1, H, W), np.uint8)
    st = _global_probe_clip(frames, (T, T))
    want = {}
    for p in (1, 2, 3):
        rows, tpl = jax_chunk(
            jnp.asarray(frames[1:]), _bbox(st), st.template, st.t_mean, st.t_std,
            st.lost_count, st.use_global, jnp.int32(N_VALID), frame_shape=(H, W),
            templ_shape=(T, T), config=JaxConfig(**RADIUS), interpret=True, highest=False,
            score_passes=p, inkernel_global=True,
        )
        want[p] = (np.asarray(rows)[:, :10], np.asarray(tpl))
    return frames, _np_state(st), want


def _args(frames_u8, s):
    t = state_from_numpy(s, "cpu")
    return (torch.as_tensor(frames_u8), torch.stack(list(t.bbox)), t.template, t.t_mean,
            t.t_std, t.lost_count, t.use_global)


def _assert_contract(got_rows, got_tpl, want_rows, want_tpl, acc_atol=1e-5):
    for name, lane in EXACT.items():
        np.testing.assert_array_equal(got_rows[:, lane], want_rows[:, lane], err_msg=name)
    acc = want_rows[:, O_UPDATED] != 0
    np.testing.assert_allclose(got_rows[acc, O_SCORE], want_rows[acc, O_SCORE], atol=acc_atol)
    np.testing.assert_allclose(got_rows[:, O_SCORE], want_rows[:, O_SCORE], atol=2e-3)
    np.testing.assert_allclose(got_tpl, want_tpl, atol=1e-6)


def test_probe_covers_the_state_machine(probe):
    for rows, _ in probe[2].values():
        gused = rows[:N_VALID, O_GUSED] != 0
        upd = rows[:N_VALID, O_UPDATED] != 0
        assert (gused & ~upd).any(), "global frames that reject"
        assert (gused & upd).any(), "a global frame that re-acquires"
        assert (~gused & upd).any(), "local tracking after re-acquisition"


def test_split_is_round_to_nearest_even():
    """hi = bf16_rn(x), lo = bf16_rn(x - hi), as JAX's astype does; hi + lo
    holds x to 16 bits."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split_bf16(torch.from_numpy(x))
    jhi = jnp.asarray(x).astype(jnp.bfloat16)
    jlo = (jnp.asarray(x) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo.astype(jnp.float32)))
    assert float(np.abs(hi.numpy() + lo.numpy() - x).max()) <= 2.0**-16 * float(np.abs(x).max())


def test_tiers_order_by_precision():
    """Each pass moves the correlation closer to float32: 1 pass about 1e-3
    of the largest term off, 3 passes within 1e-5 of it (the dropped lo * lo
    term is about 2^-18 of a product)."""
    rng = np.random.default_rng(1)
    region = torch.from_numpy(rng.integers(0, 256, (40, 40), np.uint8) / np.float32(255.0))
    tc = torch.from_numpy(rng.random((12, 12), dtype=np.float32) - 0.5)
    exact = tiered_corr(region.double(), tc.double())
    scale = float(exact.abs().max())
    errs = [float((tiered_corr(region, tc, p).double() - exact).abs().max()) / scale
            for p in (1, 2, 3)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-5 < 1e-4 < errs[0]


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_plain_k1_tier_matches_jax(probe, passes):
    frames, state, want = probe
    rows, tpl = mega_track_chunk_reference(*_args(frames[1:], state), N_VALID,
                                           TrackerConfig(**RADIUS), highest=False,
                                           score_passes=passes)
    _assert_contract(rows.numpy(), tpl.numpy(), *want[passes])


def test_wrapper_on_cpu_runs_the_plain_tier(probe):
    frames, state, want = probe
    before = dict(mega_track_chunk.launches_by_tier)
    rows, tpl = mega_track_chunk(*_args(frames[1:], state), N_VALID, TrackerConfig(**RADIUS),
                                 highest=False, score_passes=1)
    assert mega_track_chunk.launches_by_tier == before
    _assert_contract(rows.numpy(), tpl.numpy(), *want[1])


def test_score_passes_outside_1_to_3_raise(probe):
    frames, state, _ = probe
    for highest in (True, False):  # checked whatever the tier, as in JAX
        with pytest.raises(ValueError, match="score_passes"):
            mega_track_chunk(*_args(frames[1:3], state), 2, TrackerConfig(**RADIUS),
                             highest=highest, score_passes=4)


def _second_clip():
    """A clip with a local target: random frames, the template cut at the
    centre, the start box 2 px off it."""
    frames = np.random.default_rng(12).integers(0, 256, (7, H, W), np.uint8)
    x, y = (W - T) // 2, (H - T) // 2
    return frames, jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + T, x : x + T]),
                                  (x + 2, y - 1, T, T))


def test_plain_k2_tier_matches_jax_multi(probe):
    """Two streams, one re-acquiring and one local, at 2 passes."""
    frames, state, _ = probe
    other, ost = _second_clip()
    jst = jax_init_state(jnp.asarray(state["template"]),
                         tuple(int(state[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h")))
    jst = jst._replace(use_global=jnp.asarray(state["use_global"]))
    sts = [jst, ost]
    videos = np.stack([frames[1:7], other[1:]])
    n_valid = np.array([6, 5], np.int32)
    rows, tpl = jax_chunk_multi(
        jnp.asarray(videos), jnp.stack([_bbox(s) for s in sts]),
        jnp.stack([s.template for s in sts]), jnp.stack([s.t_mean for s in sts]),
        jnp.stack([s.t_std for s in sts]), jnp.stack([s.lost_count for s in sts]),
        jnp.stack([s.use_global for s in sts]), jnp.asarray(n_valid), frame_shape=(H, W),
        templ_shape=(T, T), config=JaxConfig(**RADIUS), interpret=True, highest=False,
        score_passes=2, inkernel_global=True,
    )
    args = [_args(videos[s], _np_state(st))[1:] for s, st in enumerate(sts)]
    got_rows, got_tpl = mega_track_chunk_multi_reference(
        torch.from_numpy(videos), *(torch.stack(a) for a in zip(*args)), n_valid.tolist(),
        TrackerConfig(**RADIUS), highest=False, score_passes=2)
    rows = np.asarray(rows)
    assert (rows[0, :, O_GUSED] != 0).any()
    for s in range(2):
        _assert_contract(got_rows[s].numpy(), got_tpl[s].numpy(), rows[s, :, :10],
                         np.asarray(tpl)[s])


def test_plain_k3_bucketed_tier_matches_jax_objects():
    """Three objects of 8x8, 6x5 and 4x4 in an 8x8 bucket over one clip, one
    started outside the frame, at 1 pass."""
    from pvot.parallel.multi import init_multi_state_bucketed as jax_bucketed

    frames = np.random.default_rng(13).integers(0, 256, (7, H, W), np.uint8)
    ext = [(8, 8), (6, 5), (4, 4)]
    cut = [(30, 20), (80, 30), (110, 10)]
    start = [(30, 20), (79, 31), (-10, 25)]
    g0 = gray_u8_to_f32(frames[0])
    st = jax_bucketed([g0[y : y + eh, x : x + ew] for (x, y), (eh, ew) in zip(cut, ext)],
                      [(x, y, ew, eh) for (x, y), (eh, ew) in zip(start, ext)])
    rows, tpl = jax_chunk_objects(
        jnp.asarray(frames[1:]), jnp.stack([st.bbox_x, st.bbox_y, st.bbox_w, st.bbox_h], -1),
        st.template, st.t_mean, st.t_std, st.lost_count, st.use_global,
        jnp.full((3,), 6, jnp.int32), frame_shape=(H, W), templ_shape=(8, 8),
        config=JaxConfig(**RADIUS), interpret=True, highest=False, score_passes=1,
        inkernel_global=True, bucket_extents=tuple(ext),
    )
    t = state_from_numpy(_np_state(st), "cpu")
    got_rows, got_tpl = mega_track_chunk_objects_reference(
        torch.from_numpy(frames[1:]), torch.stack(list(t.bbox), dim=-1), t.template, t.t_mean,
        t.t_std, t.lost_count, t.use_global, 6, TrackerConfig(**RADIUS), bucket_extents=ext,
        highest=False, score_passes=1)
    rows = np.asarray(rows)
    assert (rows[2, :, O_GUSED] != 0).any()
    for k in range(3):  # bucketed: JAX's masked box sums, 5e-5 (pvot/tracker/mega.py:1005)
        _assert_contract(got_rows[k].numpy(), got_tpl[k].numpy(), rows[k, :, :10],
                         np.asarray(tpl)[k], acc_atol=5e-5)


# --- K4 / K5 at 3 passes (`_dot_hl3`) against JAX's operator kernels.


def _k45_inputs():
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (60, 90), np.uint8)
    img[10:30, 20:50] = 128  # flat windows: the variance floor
    templ = (rng.integers(0, 256, (11, 13), np.uint8) / 255.0).astype(np.float32)
    return img, templ


# Maps within 1e-4 (the JAX probe's bound for a map, pvot/ops/ncc_pallas.py
# :650-654): on the flat patch's windows the variance floor divides the
# covariance by about 1e-3 * t_std * N, which turns float32 sums in another
# order into up to 8e-5 of a score at 3 passes; the argmax within 2e-5.
MAP_ATOL = 1e-4


def test_plain_k4_fast_matches_jax():
    img, templ = _k45_inputs()
    want = np.asarray(jax_map(jnp.asarray(img), jnp.asarray(templ), interpret=True,
                              highest=False, shear=False))
    got = tp.ncc_map_pallas(torch.from_numpy(img), torch.from_numpy(templ), highest=False)
    np.testing.assert_allclose(got.numpy(), want, atol=MAP_ATOL, rtol=0)
    # Not the float32 map: the tier is live.
    assert not np.array_equal(got.numpy(), tp.ncc_map_pallas(torch.from_numpy(img),
                                                             torch.from_numpy(templ)).numpy())


@pytest.mark.parametrize("window", [(0, 47, 0, 29), (5, 30, 3, 17)])
def test_plain_k5_fast_matches_jax(window):
    """A whole and a partly masked window over a 48 x 30 region."""
    img, templ = _k45_inputs()
    x0, y0 = 21, 9
    region = img[y0 : y0 + 30 + 10, x0 : x0 + 48 + 12]
    rx0, rx1, ry0, ry1 = window
    jb = JaxBounds(x0 + rx0, x0 + rx1, y0 + ry0, y0 + ry1)
    want = [float(v) for v in jax_argmax(jnp.asarray(region), jnp.asarray(templ), jb, x0, y0,
                                         interpret=True, highest=False, shear=False)]
    got = tp.ncc_region_argmax_pallas(torch.from_numpy(region), torch.from_numpy(templ),
                                      WindowBounds(*jb), x0, y0, highest=False)
    assert [float(got[1]), float(got[2])] == want[1:]
    assert abs(float(got[0]) - want[0]) <= 2e-5


def test_plain_k5_fast_tie_goes_to_the_first_position():
    """A constant region scores every position alike: the window's first
    position wins, as in JAX."""
    templ = _k45_inputs()[1]
    region = np.full((40, 60), 0.5, np.float32)
    jb = JaxBounds(3 + 4, 3 + 30, 2 + 5, 2 + 20)
    want = [float(v) for v in jax_argmax(jnp.asarray(region), jnp.asarray(templ), jb, 3, 2,
                                         interpret=True, highest=False, shear=False)]
    got = tp.ncc_region_argmax_pallas(torch.from_numpy(region), torch.from_numpy(templ),
                                      WindowBounds(*jb), 3, 2, highest=False)
    assert [float(got[1]), float(got[2])] == want[1:] == [7.0, 7.0]


def test_xla_fast_region_scores_match_the_explicit_split():
    """On the CPU JAX ignores Precision.HIGH (lax.dot at HIGH equals HIGHEST
    bit for bit there, 1.5e-4 off `_dot_hl3` on a 64x256 @ 256x64 product),
    so JAX's own xla_fast engine is no oracle of the 3-pass tier here: the
    port's xla_fast region scores are held to JAX's pallas_fast region
    kernel, which splits explicitly."""
    img, templ = _k45_inputs()
    t_mean, t_std = template_stats(torch.from_numpy(templ))
    region_fn = make_region_fn(span_x=31, span_y=21, passes=3)
    got = region_fn(torch.from_numpy(img), torch.from_numpy(templ), t_mean, t_std, 17, 6)
    region = img[6 : 6 + 21 + 10, 17 : 17 + 31 + 12]
    want = np.asarray(jax_map(jnp.asarray(region), jnp.asarray(templ), t_mean=jnp.asarray(
        t_mean.numpy()), t_std=jnp.asarray(t_std.numpy()), interpret=True, highest=False,
        shear=False))
    np.testing.assert_allclose(got.numpy(), want, atol=MAP_ATOL, rtol=0)
    # ... and JAX's HIGH really is float32 here: the oracle had to be the split.
    a = jnp.asarray(np.random.default_rng(2).random((64, 256), np.float32))
    b = jnp.asarray(np.random.default_rng(3).random((256, 64), np.float32))
    assert np.array_equal(np.asarray(lax.dot(a, b, precision=lax.Precision.HIGH)),
                          np.asarray(lax.dot(a, b, precision=lax.Precision.HIGHEST)))


# --- The engine path on the fast engines against JAX's pallas_fast engine.


def _fast_engine(span_x, span_y):
    """JAX's pallas_fast engine in interpret mode (pvot/ops/backends.py:
    198-223): float32 full maps, 3-pass region scores and fused argmax."""

    def full_fn(frame, templ, t_mean, t_std):
        return jax_map(frame, templ, t_mean, t_std, interpret=True)

    def region(frame, templ, x0, y0):
        th, tw = templ.shape
        return lax.dynamic_slice(frame, (y0, x0), (span_y + th - 1, span_x + tw - 1))

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        return jax_map(region(frame, templ, x0, y0), templ, t_mean, t_std, interpret=True,
                       highest=False)

    def argmax_fn(frame, templ, t_mean, t_std, x0, y0, bounds):
        return jax_argmax(region(frame, templ, x0, y0), templ, bounds, x0, y0, t_mean, t_std,
                          interpret=True, highest=False)

    return full_fn, region_fn, argmax_fn


@pytest.fixture(scope="module")
def fast_clip():
    """12 frames of a 160x120 synthetic clip that leaves and re-enters the
    frame, its 16x16 target, radius 12 (K5's span gate holds), and JAX's
    pallas_fast engine over it."""
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot.tracker.scan import track_video as jax_track_video
    from pvot.tracker.step import make_step

    spec = SyntheticSpec(width=160, height=120, num_frames=13, target_w=16, target_h=16,
                         seed=4, exit_and_reenter=True)
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    kw = dict(search_radius_x=12, search_radius_y=12, lost_frame_threshold=2)
    st = jax_init_state(jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
                        (x, y, w, h))
    full_fn, region_fn, argmax_fn = _fast_engine(25, 25)
    step = make_step((120, 160), (16, 16), JaxConfig(**kw), ncc_full_fn=full_fn,
                     ncc_region_fn=region_fn, ncc_region_argmax_fn=argmax_fn)
    _, want = jax_track_video(frames[1:], st, JaxConfig(**kw), step=step, chunk_size=12)
    return frames, _np_state(st), kw, want


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox))
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated))
    np.testing.assert_array_equal(got.used_global, np.asarray(want.used_global))
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)


@pytest.mark.parametrize("backend", ["pallas_fast", "fast"])
def test_engine_path_fast_matches_jax_pallas_fast(fast_clip, backend):
    """track_video on both fast engines: pallas_fast is K5 at 3 passes with
    float32 global maps, fast the torch-ops engine at 3 passes; both land on
    JAX's pallas_fast engine, whose global frames score float32."""
    import pvot_torch

    frames, state, kw, want = fast_clip
    assert np.asarray(want.used_global).any() and np.asarray(want.updated).any()
    _, got = pvot_torch.track_video(frames[1:], state_from_numpy(state, "cpu"),
                                    TrackerConfig(**kw), backend=backend)
    _assert_outputs(got, want)


# --- Surfaces.


def _serve(*args):
    return subprocess.run([sys.executable, "-m", "pvot_torch.cli.serve", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})


def test_serve_cli_fast_one_pass_serves():
    out = _serve("--synthetic", "200x120x4", "--streams", "2", "--search-radius", "8",
                 "--fast", "--score-passes", "1", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "tier fast_1pass_bf16" in out.stdout
    assert "Serving summary: streams=2, frames=6" in out.stdout


def test_serve_cli_score_passes_needs_fast():
    out = _serve("--synthetic", "200x120x4", "--score-passes", "2", "--device", "cpu")
    assert out.returncode == 2
    assert "needs --fast" in out.stderr


def test_bench_score_passes_needs_fast():
    from pvot_torch.bench import main

    with pytest.raises(SystemExit) as e:
        main(["--score-passes", "1"])
    assert e.value.code == 2


@pytest.mark.parametrize("fast, passes, name", [
    (False, None, "highest"), (True, None, "fast_3pass_bf16_hilo"),
    (True, 2, "fast_2pass_bf16_hilo"), (True, 1, "fast_1pass_bf16")])
def test_cli_tier_names(fast, passes, name):
    """--fast / --score-passes to the tier keywords, named as bench.py names
    them (bench.py:233-238)."""
    from pvot_torch.ops.ncc_reference import cli_tier, tier_name

    tier = cli_tier(fast, passes)
    assert tier["highest"] is not fast
    assert tier_name(**tier) == name


def test_bound_counts_the_windows_read():
    """The bench's bound reads each local frame's window (200 x 200 at
    720p/80/r60), the whole frame on a global one, and lanes that share a
    frame read the union of their windows once."""
    from pvot_torch.bench import scored_positions, scored_windows, union_pixels

    box = np.array([[600, 320, 80, 80]] * 2)
    wins = scored_windows(box[0], box, np.array([False, True]), (720, 1280), (80, 80),
                          TrackerConfig())
    assert wins == [(540, 260, 200, 200), (0, 0, 1280, 720)]
    assert scored_positions(box[0], box, np.array([False, True]), (720, 1280), (80, 80),
                            TrackerConfig()) == 121 * 121 + 641 * 1201
    assert union_pixels([(0, 0, 10, 10), (5, 5, 10, 10)]) == 175
    assert union_pixels([(540, 260, 200, 200)] * 8) == 40000
