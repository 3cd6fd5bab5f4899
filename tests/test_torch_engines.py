"""The port's per-frame NCC engines against the JAX package on the same numpy
inputs: the plain versions of K4 and K5 (pvot_torch.ops.ncc_pallas) against
the Pallas kernels in interpret mode, the torch-ops engines
(pvot_torch.ops.ncc_matmul) against pvot.ops.ncc_matmul, and the backend
registry against pvot.ops.backends.  The kernels themselves run only on the
card (`cuda`-marked tests here, and chip_smoke.py).

Tolerances: maps within 2e-5 of the JAX kernel (float32 sums in another
order; the port's window moments are summed in float64, JAX's in float32,
which moves a score by up to about 1e-5 on these windows); the fused argmax's
value within 2e-5 and (x, y) exactly; the torch-ops engines within 1e-5 of
their JAX twins (the same formulation, float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvot.ops.backends as jbackends
import pvot.ops.ncc_matmul as jmm
import pvot_torch.ops.ncc_matmul as tmm
from pvot.ops.ncc_pallas import (
    ncc_map_pallas as jax_map,
    ncc_map_pallas_batched as jax_map_batched,
    ncc_region_argmax_pallas as jax_argmax,
)
from pvot.ops.search import WindowBounds as JaxBounds
from pvot_torch.config import TrackerConfig
from pvot_torch.ops import backends as tbackends
from pvot_torch.ops import ncc_pallas as tp
from pvot_torch.ops.ncc_reference import full_f32, template_stats
from pvot_torch.ops.search import WindowBounds

MAP_ATOL = 2e-5
MM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(rng, shape, u8: bool):
    img = rng.integers(0, 256, shape, np.uint8)
    return img if u8 else (img / 255.0).astype(np.float32)


def _flat_patch(rng, shape):
    """u8 noise with a flat square patch: windows inside it have zero
    variance (clamped at 1e-6), windows across its edge nearly so."""
    img = rng.integers(0, 256, shape, np.uint8)
    img[8:40, 10:50] = 128
    return img


IMAGES = {
    "odd-f32": lambda rng: (_image(rng, (57, 133), False), (9, 11)),
    "odd-u8": lambda rng: (_image(rng, (61, 70), True), (16, 12)),
    "flat-u8": lambda rng: (_flat_patch(rng, (48, 64)), (8, 8)),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_plain_k4_matches_jax_kernel(name):
    rng = np.random.default_rng(len(name))
    img, (th, tw) = IMAGES[name](rng)
    templ = rng.random((th, tw), dtype=np.float32)
    want = np.asarray(jax_map(jnp.asarray(img), jnp.asarray(templ), interpret=True, shear=True))
    before = tp.ncc_map_pallas.launches
    got = tp.ncc_map_pallas(torch.from_numpy(img), torch.from_numpy(templ)).numpy()
    assert tp.ncc_map_pallas.launches == before  # the CPU runs the plain version
    assert got.shape == want.shape == (img.shape[0] - th + 1, img.shape[1] - tw + 1)
    np.testing.assert_allclose(got, want, atol=MAP_ATOL, rtol=0)
    ref = tp.ncc_map_pallas_reference(torch.from_numpy(img), torch.from_numpy(templ)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_plain_k4_batched_matches_jax():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 40, 52), np.uint8)
    templ = (frames[0, 5:17, 9:25] / 255.0).astype(np.float32)
    want = np.asarray(jax_map_batched(jnp.asarray(frames), jnp.asarray(templ), interpret=True))
    got = tp.ncc_map_pallas_batched(torch.from_numpy(frames), torch.from_numpy(templ))
    np.testing.assert_allclose(got.numpy(), want, atol=MAP_ATOL, rtol=0)
    for i in range(3):  # the batched form is N single calls
        assert torch.equal(got[i], tp.ncc_map_pallas(torch.from_numpy(frames[i]),
                                                     torch.from_numpy(templ)))


# (span, template side, window relative to the region: (rx0, rx1, ry0, ry1))
ARGMAX_CASES = {
    "whole": (21, 8, (0, 20, 0, 20)),
    "clamped": (21, 8, (5, 14, 3, 18)),
    "one-position": (21, 8, (10, 10, 10, 10)),
    "fully-masked": (21, 8, (12, 11, 0, 20)),
    "span-121": (121, 16, (5, 114, 11, 118)),
}


@pytest.mark.parametrize("name", sorted(ARGMAX_CASES))
@pytest.mark.parametrize("u8", [False, True])
def test_plain_k5_matches_jax_kernel(name, u8):
    span, t, (rx0, rx1, ry0, ry1) = ARGMAX_CASES[name]
    rng = np.random.default_rng(span + t)
    region = _image(rng, (span + t - 1, span + t - 1), u8)
    templ = rng.random((t, t), dtype=np.float32)
    x0, y0 = 37, 11
    jb = JaxBounds(jnp.int32(x0 + rx0), jnp.int32(x0 + rx1), jnp.int32(y0 + ry0),
                   jnp.int32(y0 + ry1))
    wv, wx, wy = jax_argmax(jnp.asarray(region), jnp.asarray(templ), jb, jnp.int32(x0),
                            jnp.int32(y0), interpret=True, shear=True)
    bounds = WindowBounds(x0 + rx0, x0 + rx1, y0 + ry0, y0 + ry1)
    before = tp.ncc_region_argmax_pallas.launches
    gv, gx, gy = tp.ncc_region_argmax_pallas(torch.from_numpy(region), torch.from_numpy(templ),
                                             bounds, x0, y0)
    assert tp.ncc_region_argmax_pallas.launches == before
    assert (int(gx), int(gy)) == (int(wx), int(wy))
    if name == "fully-masked":  # -inf at the region origin, which the step discards
        assert float(gv) == float(wv) == float("-inf") and (int(gx), int(gy)) == (x0, y0)
    else:
        np.testing.assert_allclose(float(gv), float(wv), atol=MAP_ATOL)


def test_plain_k5_tie_break():
    """A constant region scores every position the same: the argmax is the
    window's first position in row-major order (tests/test_ncc_pallas.py:186)."""
    span, t = 121, 16
    region = np.full((span + t - 1, span + t - 1), 0.5, np.float32)
    templ = np.random.default_rng(0).random((t, t), dtype=np.float32)
    b = JaxBounds(jnp.int32(7), jnp.int32(60), jnp.int32(13), jnp.int32(50))
    _, wx, wy = jax_argmax(jnp.asarray(region), jnp.asarray(templ), b, jnp.int32(0),
                           jnp.int32(0), interpret=True, shear=True)
    _, gx, gy = tp.ncc_region_argmax_pallas(torch.from_numpy(region), torch.from_numpy(templ),
                                            WindowBounds(7, 60, 13, 50), 0, 0)
    assert (int(gx), int(gy)) == (int(wx), int(wy)) == (7, 13)


def test_lanes_read_regions_in_place():
    """K lanes on one frame, each from its own origin, equal the single-lane
    calls on each lane's sliced region; a lane axis of 1 broadcasts."""
    rng = np.random.default_rng(5)
    frame = torch.from_numpy(rng.integers(0, 256, (60, 90), np.uint8))
    templs = torch.from_numpy(rng.random((3, 10, 12), dtype=np.float32))
    t_mean, t_std = templs.mean(dim=(1, 2)), templs.std(dim=(1, 2), unbiased=False) + 1e-6
    origins = [(0, 0), (20, 7), (55, 30)]
    maps = tp.ncc_map_lanes(frame, templs, t_mean, t_std, origins, (21, 21))
    lanes = [(x, y, 2, 18, 0, 20) for x, y in origins]
    best = tp.region_argmax_lanes(frame[None], templs, t_mean, t_std, lanes, (21, 21))
    for k, (x, y) in enumerate(origins):
        one = tp.ncc_map_pallas(frame[y : y + 30, x : x + 32], templs[k], t_mean[k], t_std[k])
        assert torch.equal(maps[k], one)
        v, bx, by = tp.ncc_region_argmax_pallas(frame[y : y + 30, x : x + 32], templs[k],
                                                WindowBounds(x + 2, x + 18, y, y + 20), x, y,
                                                t_mean[k], t_std[k])
        assert best[k].tolist() == [float(v), float(bx), float(by)]


def test_wrappers_check_device_and_tier():
    img, templ = torch.zeros((20, 20), dtype=torch.uint8), torch.rand(4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.ncc_map_lanes(img.to("meta"), templ.to("meta"), torch.zeros(1, device="meta"),
                         torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="negative region origin"):
        tp.ncc_map_lanes(img, templ, torch.zeros(1), torch.ones(1), [(-1, 0)], (5, 5))
    with pytest.raises(ValueError, match="negative region origin"):
        tp.region_argmax_lanes(img, templ, torch.zeros(1), torch.ones(1), [(0, -2, 0, 4, 0, 4)],
                               (5, 5))
    # highest=False is the 3-pass tier (`_dot_hl3`), the plain version at 3
    # passes on the CPU; K4/K5 have no other bf16 tier.
    img = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (20, 20), np.uint8))
    t_mean, t_std = template_stats(templ)
    fast = tp.ncc_map_pallas(img, templ, highest=False)
    assert torch.equal(fast, tp.ncc_map_lanes_reference(img, templ, t_mean, t_std, passes=3)[0])
    assert not torch.equal(fast, tp.ncc_map_pallas(img, templ))
    bounds = WindowBounds(1, 4, 2, 5)
    row = tp.pallas_region_argmax_fn((20, 20), (4, 4), (5, 5), highest=False)(
        img, templ, t_mean, t_std, 0, 1, bounds)
    assert torch.equal(row, tp.region_argmax_lanes_reference(
        img, templ, t_mean, t_std, [(0, 1, 1, 4, 1, 4)], (5, 5), passes=3)[0])
    with pytest.raises(ValueError, match="passes"):
        tp.ncc_map_lanes(img, templ, t_mean, t_std, passes=2)


# --- The torch-ops engines against pvot.ops.ncc_matmul.


def _pair(rng, shape=(50, 71), t=(12, 9), u8=True):
    frame = _image(rng, shape, u8)
    templ = (rng.integers(0, 256, t, np.uint8) / 255.0).astype(np.float32)
    return frame, templ


@pytest.mark.parametrize("shape", [(120, 160), (37, 300), (720, 1280)])
def test_cumsum_is_xla_order(shape):
    """The integral images' prefix sums are XLA's, bit for bit: a two-level
    scan in blocks of 16."""
    x = np.random.default_rng(shape[0]).random(shape, dtype=np.float32)
    for axis in (0, 1):
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(tmm.cumsum(torch.from_numpy(x), axis).numpy(), want)


@pytest.mark.parametrize("strip_rows", [0, 7])
def test_ncc_map_matmul_matches_jax(strip_rows):
    frame, templ = _pair(np.random.default_rng(strip_rows))
    want = np.asarray(jmm.ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ),
                                         strip_rows=strip_rows))
    got = tmm.ncc_map_matmul(torch.from_numpy(frame), torch.from_numpy(templ),
                             strip_rows=strip_rows).numpy()
    np.testing.assert_allclose(got, want, atol=MM_ATOL, rtol=0)


def test_opencv_engine_matches_jax():
    frame, templ = _pair(np.random.default_rng(9), u8=False)
    want = np.asarray(jmm.ncc_map_opencv_matmul(jnp.asarray(frame), jnp.asarray(templ), 16))
    got = tmm.ncc_map_opencv_matmul(torch.from_numpy(frame), torch.from_numpy(templ), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=MM_ATOL, rtol=0)
    fn_j = jmm.make_opencv_region_fn(11, 7)
    fn_t = tmm.make_opencv_region_fn(11, 7)
    want = fn_j(jnp.asarray(frame), jnp.asarray(templ), None, None, jnp.int32(20), jnp.int32(9))
    got = fn_t(torch.from_numpy(frame), torch.from_numpy(templ), None, None, 20, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_ATOL, rtol=0)


def test_region_engine_matches_jax():
    frame, templ = _pair(np.random.default_rng(4))
    t_mean, t_std = [float(v) for v in (templ.mean(), templ.std() + 1e-6)]
    want = jmm.make_region_fn(13, 9)(jnp.asarray(frame), jnp.asarray(templ), jnp.float32(t_mean),
                                     jnp.float32(t_std), jnp.int32(31), jnp.int32(17))
    got = tmm.make_region_fn(13, 9)(torch.from_numpy(frame), torch.from_numpy(templ),
                                    torch.tensor(t_mean), torch.tensor(t_std), 31, 17)
    assert got.shape == (9, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_ATOL, rtol=0)


@pytest.mark.parametrize("extent", [(12, 9), (7, 12), (12, 12)])
def test_bucketed_engines_match_jax(extent):
    rng = np.random.default_rng(sum(extent))
    frame = rng.integers(0, 256, (40, 60), np.uint8)
    th, tw = extent
    padded = np.zeros((12, 12), np.float32)
    padded[:th, :tw] = rng.random((th, tw), dtype=np.float32)
    t_mean, t_std = [np.float32(v) for v in jmm.template_stats_bucketed(
        jnp.asarray(padded), jnp.int32(th * tw))]
    args_j = (jnp.asarray(padded), jnp.float32(t_mean), jnp.float32(t_std), jnp.int32(th),
              jnp.int32(tw))
    args_t = (torch.from_numpy(padded), torch.tensor(t_mean), torch.tensor(t_std), th, tw)
    fp = np.pad(frame, ((0, 11), (0, 11)))
    want = jmm.make_bucketed_region_fn(9, 7, (12, 12))(jnp.asarray(fp), *args_j, jnp.int32(14),
                                                      jnp.int32(6))
    got = tmm.make_bucketed_region_fn(9, 7, (12, 12))(torch.from_numpy(fp), *args_t, 14, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_ATOL, rtol=0)
    want = np.asarray(jmm.make_bucketed_full_fn((40, 60), (12, 12))(jnp.asarray(frame), *args_j))
    got = tmm.make_bucketed_full_fn((40, 60), (12, 12))(torch.from_numpy(frame), *args_t).numpy()
    valid = (slice(0, 40 - th + 1), slice(0, 60 - tw + 1))  # the rest is garbage by contract
    np.testing.assert_allclose(got[valid], want[valid], atol=MM_ATOL, rtol=0)


# --- The backend registry.


def test_every_jax_mode_name_resolves():
    """The port knows every mode name of pvot/ops/backends.py:46-103: the
    Pallas family is the CUDA engine (K4 maps, K5 fused argmax within JAX's
    span gate; pallas_fast its 3-pass tier), fast and xla_fast the torch-ops
    engine with 3-pass region scores, unknown names raise."""
    assert set(tbackends.MODE_TO_BACKEND) == set(jbackends.MODE_TO_BACKEND)
    cfg = TrackerConfig(search_radius_x=12, search_radius_y=12)
    for name, jname in jbackends.MODE_TO_BACKEND.items():
        full_fn, region_fn, argmax_fn = tbackends.get_backend(name, (120, 160), (16, 16), cfg)
        cuda = jname in ("pallas", "pallas_shear", "auto", "pallas_fast")
        assert (tbackends.cuda_region_passes(name) is not None) == cuda, name
        assert (argmax_fn is not None) == cuda, name
        module = full_fn.__module__
        if cuda:
            assert module == "pvot_torch.ops.ncc_pallas", name
        elif jname == "ref_conv":
            assert module == "pvot_torch.ops.ncc_reference", name
        else:
            assert module == "pvot_torch.ops.ncc_matmul", name
    with pytest.raises(ValueError, match="unknown"):
        tbackends.get_backend("nope", (120, 160), (16, 16), cfg)


@pytest.mark.parametrize("radius,fused", [(60, True), (63, True), (64, False), (160, False)])
def test_fused_argmax_keeps_jax_span_gate(radius, fused):
    cfg = TrackerConfig(search_radius_x=radius, search_radius_y=radius)
    _, _, argmax_fn = tbackends.get_backend("shared", (1080, 1920), (80, 80), cfg)
    assert (argmax_fn is not None) == fused
    want = jbackends._maybe_fused_argmax((1080, 1920), (80, 80), 2 * radius + 1, 2 * radius + 1)
    assert (want is not None) == fused


def test_full_f32_holds_and_restores_the_flags():
    """Inside full_f32 on a CUDA device the float32 convolution and product
    flags say full precision, whatever the caller set; after it the caller's
    flags are back.  Off the card nothing changes."""
    from pvot_torch.ops.ncc_reference import _precision_knobs

    knobs = _precision_knobs()
    saved = [getattr(obj, name) for obj, name, _ in knobs]
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        before = [getattr(obj, name) for obj, name, _ in knobs]
        with full_f32(torch.device("cpu")):
            assert [getattr(obj, name) for obj, name, _ in knobs] == before
        with full_f32(torch.device("cuda", 0)):
            assert [getattr(obj, name) for obj, name, _ in knobs] == [v for _, _, v in knobs]
        assert [getattr(obj, name) for obj, name, _ in knobs] == before
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        for (obj, name, _), v in zip(knobs, saved):
            setattr(obj, name, v)


# --- On the card.


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(1)
    frame = torch.from_numpy(rng.integers(0, 256, (200, 260), np.uint8)).to(cuda_device)
    templ = frame[40:120, 50:130].float() / 255.0
    before = tp.ncc_map_pallas.launches
    got = tp.ncc_map_pallas(frame, templ)
    assert tp.ncc_map_pallas.launches == before + 1
    want = tp.ncc_map_pallas_reference(frame, templ)
    assert float((got - want).abs().max()) <= 1e-4
    b = WindowBounds(40, 90, 20, 100)
    gv, gx, gy = tp.ncc_region_argmax_pallas(frame, templ, b, 0, 0)
    wv, wx, wy = tp.ncc_region_argmax_pallas_reference(frame, templ, b, 0, 0)
    assert (int(gx), int(gy)) == (int(wx), int(wy)) == (50, 40)
    assert abs(float(gv) - float(wv)) <= 1e-5


@pytest.mark.cuda
def test_cuda_xla_engine_ignores_tf32_flags(cuda_device):
    """With the TF32 flags at their defaults (cuDNN's on), the
    torch-ops engine on the card still scores in full float32."""
    torch.backends.cudnn.allow_tf32 = True
    rng = np.random.default_rng(2)
    frame = torch.from_numpy(rng.integers(0, 256, (200, 260), np.uint8)).to(cuda_device)
    templ = frame[40:120, 50:130].float() / 255.0
    got = tmm.ncc_map_matmul(frame, templ).cpu().double()
    want = tp.ncc_map_pallas_reference(frame.cpu(), templ.cpu()).double()
    assert float((got - want).abs().max()) <= 1e-4
