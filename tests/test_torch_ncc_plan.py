"""K4/K5's launch plan (pvot_torch/ops/ncc_pallas.py `ncc_plan`, the mirror
of csrc/ncc_pallas.cu's geometry): the redesigned tile body keeps the
parent's chunk rows, which fix the order of every output's sums, and fits
two blocks an SM; and K5's scratch, kept per device, stream and shape,
gives the rows of fresh scratch (on the card)."""

import numpy as np
import pytest
import torch

from pvot_torch.ops.ncc_pallas import NccPlan, chunk_rows, ncc_plan

# Every template extent the engines and the bucketed sets take (the mega
# envelope, 256 x 256), in full along th and at the widths that cross the
# plan's edges (multiples of 4 and not, the 16-row tile's limit, chunking).
WIDTHS = (1, 2, 3, 4, 5, 7, 8, 11, 13, 16, 17, 31, 32, 33, 45, 48, 63, 64, 78, 80, 81, 96,
          100, 127, 128, 129, 143, 160, 176, 200, 221, 255, 256)
TWO_BLOCKS_AN_SM = 232_448  # shared memory of an SM that two blocks can take
STATIC_BYTES = 256  # the kernel's static shared memory, rounded up


def parent_chunk_rows(th: int, tw: int) -> int:
    """The parent tree's chunk_rows (csrc/ncc_pallas.cu before the redesign),
    restated: the most template rows, up to th, whose 8 x 16 tile plan fits
    110 KB."""
    def in_stride(tw4):
        return 16 + tw4 + ((16 - (16 + tw4) % 32) + 32) % 32

    def smem_bytes(rows, tw_):
        tw4 = (tw_ + 3) & ~3
        return 4 * (rows * tw4 + (rows + 7) * in_stride(tw4) + 2 * (rows + 7) * 16 + 8 * 128)

    for rows in range(th, 0, -1):
        if smem_bytes(rows, tw) <= 110 * 1024:
            return rows
    return -1


@pytest.mark.parametrize("tw", WIDTHS)
def test_chunk_rows_are_the_parents(tw):
    for th in range(1, 257):
        want = parent_chunk_rows(th, tw)
        assert chunk_rows(th, tw) == want, (th, tw)
        for argmax in (False, True):
            for passes in (0, 3):
                assert ncc_plan(th, tw, argmax, passes).chunk_rows == want, (th, tw, argmax)


@pytest.mark.parametrize("tw", WIDTHS)
def test_plan_fits_two_blocks_an_sm(tw):
    for th in range(1, 257):
        for argmax in (False, True):
            for passes in (0, 3):
                plan = ncc_plan(th, tw, argmax, passes)
                assert plan.tile_h in (8, 16)
                assert 2 * (plan.smem_bytes + STATIC_BYTES) <= TWO_BLOCKS_AN_SM, (th, tw, plan)


def test_plan_tiles():
    """K5 takes 8-row tiles (K5's 121 x 121 local frame: 128 tiles, a block
    each); K4 16-row tiles where they fit, 8-row ones for a template in row
    chunks; an 8-row plan is the parent's shared memory."""
    assert ncc_plan(80, 80, True) == NccPlan(8, 80, 79_808)
    assert ncc_plan(80, 80, False) == NccPlan(16, 80, 83_952)
    assert ncc_plan(80, 80, False, 3).tile_h == 16
    assert ncc_plan(160, 160, False) == NccPlan(8, 69, 111_488)
    assert ncc_plan(176, 176, False).chunk_rows == 61
    assert ncc_plan(256, 256, True).chunk_rows == 44


def test_plan_refuses_a_template_no_row_of_which_fits():
    assert chunk_rows(4, 20_000) == -1
    with pytest.raises(ValueError, match="not one row"):
        ncc_plan(4, 20_000, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py phases 8 and 20 cover the "
                    "card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_plan_is_the_kernels(cuda_device):
    import ctypes

    from pvot_torch.ops import _build

    lib = _build.load_library()
    for th, tw in ((80, 80), (160, 160), (176, 176), (256, 256), (9, 11), (80, 256)):
        for argmax in (0, 1):
            for passes in (0, 3):
                smem = ctypes.c_int(0)
                tile_h = lib.pvot_ncc_plan(th, tw, argmax, passes, ctypes.byref(smem))
                plan = ncc_plan(th, tw, bool(argmax), passes)
                assert (tile_h, smem.value) == (plan.tile_h, plan.smem_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", [1, 8])
def test_cuda_cached_scratch_gives_the_rows_of_fresh_scratch(cuda_device, n_lanes):
    """Back-to-back K5 calls on one stream share their scratch (the kernel
    leaves its counters at zero); each call's rows equal those of a call on
    scratch made fresh."""
    from pvot_torch.ops import ncc_pallas
    from pvot_torch.ops.ncc_reference import template_stats

    rng = np.random.default_rng(17)
    frames = torch.from_numpy(rng.integers(0, 256, (n_lanes, 400, 500), np.uint8)).to(cuda_device)
    templ = torch.from_numpy(rng.random((80, 80), dtype=np.float32)).to(cuda_device)
    tm, ts = template_stats(templ)
    calls = [[(int(rng.integers(0, 250)), int(rng.integers(0, 150)), 0, 120, 3, 117)
              for _ in range(n_lanes)] for _ in range(6)]
    cached = [ncc_pallas.region_argmax_lanes(frames, templ, tm, ts, lanes, (121, 121))
              for lanes in calls]
    for lanes, got in zip(calls, cached):
        ncc_pallas._SCRATCH.clear()
        fresh = ncc_pallas.region_argmax_lanes(frames, templ, tm, ts, lanes, (121, 121))
        assert torch.equal(got, fresh)
