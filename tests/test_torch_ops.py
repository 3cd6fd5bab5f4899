"""pvot_torch.io.gray, ops.ncc_reference and ops.search against the JAX
package on the same numpy inputs.

Tolerances: u8 -> f32 conversions and the search rules are exact; NCC maps
and template stats agree within 1e-5 (float32 sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot.io.gray as jgray
import pvot.ops.ncc_reference as jref
import pvot.ops.search as jsearch
import pvot_torch.io.gray as tgray
import pvot_torch.ops.ncc_reference as tref
import pvot_torch.ops.search as tsearch
from pvot_torch.config import TrackerConfig
from pvot_torch.ops import _build
from pvot_torch.ops.ncc_mega import (
    MegaGeometry,
    mega_track_chunk,
    mega_track_chunk_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_u8_to_f32_both_paths_bit_equal(rng):
    img = np.concatenate(
        [np.arange(256, dtype=np.uint8), rng.integers(0, 256, 704, np.uint8)]
    ).reshape(16, 60)
    host = tgray.gray_u8_to_f32(img)
    assert host.dtype == np.float32
    assert host.tobytes() == jgray.gray_u8_to_f32(img).tobytes()
    dev = tgray.ensure_gray_f32(torch.from_numpy(img)).numpy()
    assert dev.tobytes() == np.asarray(jgray.ensure_gray_f32(jnp.asarray(img))).tobytes()
    # The two roundings are different functions: parity needs both.
    assert not np.array_equal(host, dev)
    f = rng.random((4, 5), np.float32)
    assert tgray.ensure_gray_f32(torch.from_numpy(f)).numpy().tobytes() == f.tobytes()


@pytest.mark.parametrize("shape", [(16, 16), (7, 13), (32, 24)])
def test_template_stats_matches_jax(rng, shape):
    t = rng.random(shape, np.float32)
    want = [float(v) for v in jref.template_stats(jnp.asarray(t))]
    got = [float(v) for v in tref.template_stats(torch.from_numpy(t))]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mean64, std64 = tref.template_stats(torch.from_numpy(t.astype(np.float64)))
    np.testing.assert_allclose(float(mean64), t.astype(np.float64).mean(), rtol=1e-12)
    np.testing.assert_allclose(float(std64), t.astype(np.float64).std() + 1e-6, rtol=1e-12)


@pytest.mark.parametrize("as_u8", [True, False])
def test_ncc_map_reference_matches_jax(rng, as_u8):
    frame_u8 = rng.integers(0, 256, (40, 52), np.uint8)
    frame = frame_u8 if as_u8 else tgray.gray_u8_to_f32(frame_u8)
    templ = tgray.gray_u8_to_f32(frame_u8[9:21, 14:30])
    want = np.asarray(jref.ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    got = tref.ncc_map_reference(torch.from_numpy(frame), torch.from_numpy(templ)).numpy()
    assert got.shape == want.shape == (29, 37)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The template's own placement is the (first) maximum.
    assert np.unravel_index(np.argmax(got), got.shape) == (9, 14)
    got64 = tref.ncc_map_reference(
        torch.from_numpy(tgray.gray_u8_to_f32(frame_u8).astype(np.float64)),
        torch.from_numpy(templ.astype(np.float64)),
    )
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, atol=1e-5, rtol=0)


def test_window_moments_matches_jax(rng):
    frame = rng.random((30, 41), np.float32)
    want = jref.window_moments(jnp.asarray(frame), (8, 11))
    got = tref.window_moments(torch.from_numpy(frame), (8, 11))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# Centers inside, at and beyond every edge: windows clamp on one side, on
# both, and collapse (valid False) when the center is far outside.
CENTERS = [(40, 30), (0, 0), (-5, 70), (95, -3), (200, 30), (40, 400), (-90, -90)]


@pytest.mark.parametrize("cx,cy", CENTERS)
def test_local_window_bounds_exact(cx, cy):
    args = (16, 12, 85, 59, 10, 7)
    want = jsearch.local_window_bounds(cx, cy, *args)
    got = tsearch.local_window_bounds(cx, cy, *args)
    assert tuple(got) == tuple(int(v) for v in want)
    assert got.valid == bool(want.valid)
    if got.valid:
        want_o = jsearch.region_origin(want, 85, 59, 21, 15)
        assert tsearch.region_origin(got, 85, 59, 21, 15) == tuple(int(v) for v in want_o)


def _tied_map(rng):
    m = np.round(rng.random((23, 31)).astype(np.float32) * 4) / 4  # many ties
    m[5, 20] = m[5, 3] = m[17, 1] = 2.0  # forced tie of the maximum
    return m


def _same(got, want):
    assert float(got[0]) == float(want[0])
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))


def test_argmax2d_first_occurrence(rng):
    m = _tied_map(rng)
    got = tsearch.argmax2d(torch.from_numpy(m))
    _same(got, jsearch.argmax2d(jnp.asarray(m)))
    assert (got[1], got[2]) == (3, 5)  # row-major first of the tied maxima


@pytest.mark.parametrize("cx,cy", CENTERS[:4])
def test_masked_argmaxes_match_jax(rng, cx, cy):
    m = _tied_map(rng)
    bounds_j = jsearch.local_window_bounds(cx, cy, 6, 4, 31, 23, 5, 4)
    bounds_t = tsearch.local_window_bounds(cx, cy, 6, 4, 31, 23, 5, 4)
    _same(tsearch.masked_window_best(torch.from_numpy(m), bounds_t).tolist(),
          jsearch.masked_window_argmax(jnp.asarray(m), bounds_j))
    x0, y0 = tsearch.region_origin(bounds_t, 31, 23, 11, 9)
    region = np.ascontiguousarray(m[y0 : y0 + 9, x0 : x0 + 11])
    _same(tsearch.masked_region_best(torch.from_numpy(region), x0, y0, bounds_t).tolist(),
          jsearch.masked_region_argmax(jnp.asarray(region), x0, y0, bounds_j))


def test_collapsed_window_masks_everything(rng):
    m = torch.from_numpy(_tied_map(rng))
    bounds = tsearch.local_window_bounds(-90, -90, 6, 4, 31, 23, 5, 4)
    assert not bounds.valid
    val, x, y = tsearch.masked_window_best(m, bounds).tolist()
    assert float(val) == float("-inf") and (x, y) == (0, 0)


def _chunk_inputs(rng):
    frames = torch.from_numpy(rng.integers(0, 256, (3, 40, 60), np.uint8))
    tpl = tgray.ensure_gray_f32(frames[0, 10:22, 20:36]).clone()
    t_mean, t_std = tref.template_stats(tpl)
    i32 = torch.int32
    return (frames, torch.tensor([20, 10, 16, 12], dtype=i32), tpl, t_mean, t_std,
            torch.tensor(0, dtype=i32), torch.tensor(False))


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    args = _chunk_inputs(rng)
    config = TrackerConfig(search_radius_x=4, search_radius_y=4)
    before = mega_track_chunk.launches
    rows, tpl = mega_track_chunk(*args, 3, config)
    want_rows, want_tpl = mega_track_chunk_reference(*args, 3, config)
    assert torch.equal(rows, want_rows) and torch.equal(tpl, want_tpl)
    assert mega_track_chunk.launches == before  # the plain version launches nothing
    assert rows[0, :4].tolist() == [20, 10, 16, 12] and rows[0, 5] == 1.0
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        mega_track_chunk(*meta, 3, config)


def test_envelope_raises_outside_shared_memory():
    config = TrackerConfig()
    assert MegaGeometry((720, 1280), (80, 80), config).check().smem_bytes() < 232_448
    # A 200x200 template no longer fits beside its tile: it stages in chunks.
    big = MegaGeometry((720, 1280), (200, 200), config).check()
    assert big.stage_rows() < 200 and big.smem_bytes() <= 232_448
    with pytest.raises(ValueError, match="envelope"):
        MegaGeometry((720, 1280), (257, 200), config).check()
    with pytest.raises(ValueError, match="shared memory"):
        MegaGeometry((720, 1280), (200, 200), config).check(table_lanes=5000)
    with pytest.raises(ValueError, match="larger than frame"):
        MegaGeometry((40, 40), (41, 8), config).check()


def test_build_is_keyed_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libpvot_torch_")
    assert path == _build.library_path()  # stable for unchanged sources
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
