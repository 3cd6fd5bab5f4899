"""The Pallas NCC probe ladder (pvot_torch.tools.pallas_probe) against the
JAX probes; the CUDA kernels against their plain versions on the card.

The JAX probes are tools/pallas_probe.py, loaded by path and run in Pallas
interpret mode (tests/jax_probes.py keeps each pallas_call's operands and
outputs); they check themselves as they run.  small_ncc and headline_ncc
(K4) are held to the JAX probes' own oracle, the matmul engine, with no
interpreter.
"""

import jax
import numpy as np
import pytest
import torch

from pvot_torch.tools import fused_argmax_probe as fap
from pvot_torch.tools import pallas_probe as pp
from tests.jax_probes import capture, load_tool, tensors

OWN = [name for name, _ in pp.PROBES if name not in pp.K4_PROBES]
CASES = dict(pp.PROBES)
# The plain version against the JAX kernel's interpret-mode output: exactly,
# except the products, held to the probe's own bound (assert_allclose's
# rtol, or new_ncc_mini's 1e-4): on the CPU the interpreter computes the
# 1-pass and HIGH products in float32.
RTOL = {"matmul": 3e-3, "big_matmul": 1e-4, "dot_highest": 1e-5, "dot_high": 1e-4,
        "scratch_copy_dot": 1e-4, "unrolled_dots": 1e-4, "selector_dot": 1e-6}
NCC_MINI_ATOL = 1e-4  # tools/pallas_probe.py:576


@pytest.fixture(scope="module")
def jax_tool():
    return load_tool("pallas_probe")


@pytest.fixture(scope="module")
def jax_calls(jax_tool):
    return capture(jax_tool.PROBES, OWN)


def test_probe_names_and_order_are_the_jax_tools(jax_tool):
    assert [name for name, _ in pp.PROBES] == list(jax_tool.PROBES)


@pytest.mark.parametrize("name", OWN)
def test_operands_equal_the_jax_probes(jax_calls, name):
    case = CASES[name]()
    operands, _ = jax_calls[name]
    assert len(case.operands) == len(operands)
    for i, (mine, theirs) in enumerate(zip(case.operands, operands)):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        if name == "new_ncc_mini" and i in (1, 3):
            # toep and scal carry the template's stats, which the port's
            # template_stats sums in another order than JAX's: the mean and
            # std within 1e-6, each centered value within 2.5e-7 and their
            # sum (scal[0, 2]) within n times that.
            n = case.operands[3][0, 3]
            atol = 2.5e-7 if i == 1 else np.array([[1e-6, 1e-6, n * 2.5e-7, 0.0]])
            assert (np.abs(mine - theirs) <= atol).all(), np.abs(mine - theirs).max()
        else:
            np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("name", OWN)
def test_plain_version_matches_the_jax_kernel(jax_calls, name):
    case = CASES[name]()
    operands, outputs = jax_calls[name]
    (got,), (want,) = fap._numpy(case.plain(*tensors(case, operands))), outputs
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in RTOL:
        np.testing.assert_allclose(got, want, rtol=RTOL[name])
    elif name == "new_ncc_mini":
        assert np.abs(got - want).max() < NCC_MINI_ATOL
    else:
        np.testing.assert_array_equal(got, want)
    case.check((got,))  # and the probe's own assertion, restated


@pytest.mark.parametrize("name", pp.K4_PROBES)
def test_k4_probes_match_the_jax_oracle(name):
    """The port's map on the CPU (the plain K4) within 1e-3 of the JAX
    matmul engine, as the probes assert (tools/pallas_probe.py:340, :356)."""
    import jax.numpy as jnp
    from pvot.ops.ncc_matmul import ncc_map_matmul

    case = CASES[name]()
    img, templ = case.operands
    got = case.plain(*case.args("cpu")).numpy()
    want = np.asarray(jax.jit(ncc_map_matmul)(jnp.asarray(img), jnp.asarray(templ)))
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-3


def test_copied_constants(jax_calls):
    assert pp.TX == fap.TX == 128
    img_pad, toep, box, scal = jax_calls["new_ncc_mini"][0]
    th, tw, length, h, w = (pp.NCC_MINI[k] for k in ("TH", "TW", "L", "H", "W"))
    assert box.shape == (length, pp.TX) and toep.shape == (th // 8 * length, 8 * pp.TX)
    assert scal[0, 3] == th * tw and np.count_nonzero(img_pad) == h * w
    sel = jax_calls["selector_dot"][0][1]
    assert np.argwhere(sel).tolist() == [[r, r + pp.SELECTOR_SHIFT] for r in range(8)]


def test_wrappers_on_cpu_run_the_plain_versions():
    before = [w.launches for w in pp.WRAPPERS]
    for name in OWN:
        case = CASES[name]()
        args = case.args("cpu")
        assert torch.equal(case.call(*args), case.plain(*args)), name
    assert [w.launches for w in pp.WRAPPERS] == before
    img_pad, toep, box, scal, _, _, gh, gw = pp.new_ncc_mini_operands()
    args = [torch.from_numpy(a) for a in (img_pad, toep, box, scal)]
    with pytest.raises(ValueError):
        pp.toeplitz_ncc(args[0][:40], *args[1:], gh, gw)
    with pytest.raises(ValueError):
        pp.toeplitz_ncc(*args[:2], args[2][:, :64], args[3], gh, gw)


@pytest.mark.parametrize("name, flops", [
    # the operators' nonzeros: a 16 x 16 template and two 16-wide box sums
    # at each of the (56, 256) outputs; the selector's 8 ones over 128 lanes.
    ("new_ncc_mini", 2.0 * 56 * 256 * (16 * 16 + 2 * 16)),
    ("selector_dot", 2.0 * 8 * 128),
])
def test_bound_counts_the_work_the_function_needs(name, flops):
    assert CASES[name]().flops == flops


def test_entry_point_on_cpu_passes_every_probe(capsys):
    assert pp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith(("PASS", "FAIL"))] == [
        f"PASS {name}" for name, _ in pp.PROBES]
    assert pp.main(["--device", "cpu", "matmul", "new_ncc_mini"]) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py covers the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(cuda_device):
    for name, make in pp.PROBES:
        fap.run_case(name, make(), cuda_device)
    # The product kernels' edge shapes: one launch a call, two calls bit-equal.
    for name, make in fap.GEMM_EDGE_PROBES:
        case = make()
        args = case.args(cuda_device)
        fap.run_case(name, case, cuda_device)
        before = fap.gemm.launches
        assert torch.equal(case.call(*args), case.call(*args)), name
        assert fap.gemm.launches == before + 2, name
