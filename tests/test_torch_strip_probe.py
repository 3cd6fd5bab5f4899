"""The global-strip probes (pvot_torch.tools.global_strip_probe) against the
JAX probes and the numpy oracle; the CUDA kernels against their plain
versions on the card.

The JAX probes are tools/global_strip_probe.py, loaded by path and run in
Pallas interpret mode: pallas_call is wrapped with interpret=True, and the
wrapper keeps each kernel's output, (16, 128) float32 with frame t's result
in row 8t.  The probes check themselves against `_oracle_best` as they run.
"""

import importlib.util
import os

import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from pvot_torch.tools import global_strip_probe as gsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_global_strip_probe", os.path.join(REPO, "tools", "global_strip_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_probe():
    return _jax_tool()


@pytest.fixture(scope="module")
def jax_outputs(jax_probe):
    """{probe name: (2, 128) float32}: row 0 of each frame's output tile."""
    orig = jpl.pallas_call
    out = {}

    def capturing(name):
        def pallas_call(*args, **kwargs):
            call = orig(*args, interpret=True, **kwargs)

            def run(*inputs):
                result = call(*inputs)
                out[name] = np.asarray(result).reshape(2, 8, -1)[:, 0]
                return result

            return run

        return pallas_call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("when_fori_dma", "dyn_fori_dma", "when_refetch"):
            mp.setattr(jpl, "pallas_call", capturing(name))
            getattr(jax_probe, f"probe_{name}")()
    return out


@pytest.mark.parametrize("name", ["when_fori_dma", "dyn_fori_dma"])
def test_strip_best_plain_matches_the_jax_probe(jax_outputs, name):
    got = gsp.strip_best_reference(torch.from_numpy(gsp.probe_frames(7))).numpy()
    gsp.check_strips(name, got.astype(np.float64), jax_outputs[name][:, :3].astype(np.float64))


def test_slab_refetch_plain_matches_the_jax_probe(jax_outputs):
    got = gsp.slab_refetch_reference(torch.from_numpy(gsp.probe_frames(8))).numpy()
    np.testing.assert_array_equal(got, jax_outputs["when_refetch"][:, :2])


def test_slab_refetch_takes_both_branches_on_the_border_clip():
    """Byte (0, 0) odd (frame 0): s1 is the slab at (64, 256); even (frame
    1): s1 is s0."""
    frames = gsp.border_clip()
    got = gsp.slab_refetch_reference(torch.from_numpy(frames)).numpy()
    gsp.check_refetch("border clip", got.astype(np.float64), gsp._oracle_refetch(frames))
    assert got[0, 0] != got[0, 1] and got[1, 0] == got[1, 1]
    assert got[0, 1] == frames[0, 64:128, 256:512].astype(np.int64).sum()


def test_oracle_copy_equals_the_original(jax_probe):
    inputs = [gsp.probe_frames(7), gsp.probe_frames(8), gsp.border_clip()]
    for frames in inputs:
        for fr in frames:
            for strips in ([(0, 0)], [(2, 1)], gsp.strips_of(1)):
                assert gsp._oracle_best(fr, strips) == jax_probe._oracle_best(fr, strips)
            np.testing.assert_array_equal(gsp._scores_np(fr, 1, 1), jax_probe._scores_np(fr, 1, 1))
    assert (gsp.TX, gsp.SLAB_H, gsp.SLAB_W, gsp.PAD_H, gsp.PAD_W, gsp.NY, gsp.NX,
            gsp.DY_MAX) == (jax_probe.TX, jax_probe.SLAB_H, jax_probe.SLAB_W, jax_probe.PAD_H,
                            jax_probe.PAD_W, jax_probe.NY, jax_probe.NX, jax_probe.DY_MAX)


@pytest.mark.parametrize("name,seed", [("strips", 7), ("refetch", 8), ("strips", 8)])
def test_plain_versions_match_the_oracle(name, seed):
    frames = gsp.probe_frames(seed)
    x = torch.from_numpy(frames)
    if name == "refetch":
        gsp.check_refetch(name, gsp.slab_refetch_reference(x).numpy().astype(np.float64),
                          gsp._oracle_refetch(frames))
    else:
        got = gsp.strip_best_reference(x).numpy().astype(np.float64)
        gsp.check_strips(name, got, gsp._oracle_strips(frames))
        gsp.check_strips(name, got, gsp._oracle_strips(frames, exact=True))


def test_border_clip_puts_the_best_on_strip_borders():
    """Frame 0's best is the corner of the one strip it scores; frame 1's
    brightest 8 x 8 box lies across row 64, and the two strips that score
    its lower part tie exactly, the fold taking the smaller (y, x)."""
    frames = gsp.border_clip()
    box = np.lib.stride_tricks.sliding_window_view(frames[1].astype(np.int64), (8, 8)).sum(
        axis=(2, 3))
    top, left = np.unravel_index(np.argmax(box), box.shape)
    assert top < 64 <= top + 7 and (box == box.max()).sum() == 1
    got = gsp.strip_best_reference(torch.from_numpy(frames)).numpy()
    want = gsp._oracle_strips(frames, exact=True)
    gsp.check_strips("border clip", got.astype(np.float64), want)
    assert got[:, 1:].tolist() == [[47.0, 127.0], [65.0, 20.0]]
    # The tie: strips (1, 0) and (1, 1) score equal boxes; inside strip
    # (1, 1) two equal boxes, the first of them in row-major order wins.
    for strips, pos in (([(1, 0)], (65, 20)), ([(1, 1)], (65, 276))):
        v, y, x = gsp._oracle_best_exact(frames[1], strips)
        assert (y, x) == pos and v == want[1, 0]


def test_wrappers_on_cpu_run_the_plain_versions():
    x = torch.from_numpy(gsp.border_clip())
    n = (gsp.strip_best.launches, gsp.slab_refetch.launches)
    assert torch.equal(gsp.strip_best(x), gsp.strip_best_reference(x))
    assert torch.equal(gsp.slab_refetch(x), gsp.slab_refetch_reference(x))
    assert (gsp.strip_best.launches, gsp.slab_refetch.launches) == n
    with pytest.raises(ValueError):
        gsp.strip_best(x[:, :128])


def test_entry_point_on_cpu_passes_every_probe(capsys):
    assert gsp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith(("PASS", "FAIL"))] == [
        f"PASS {name}" for name, _ in gsp.PROBES]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py phase B covers the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(cuda_device):
    for name, frames in gsp.probe_inputs():
        gsp.run_probe(name, frames, cuda_device)
