"""The fused-argmax probe catalogue (pvot_torch.tools.fused_argmax_probe)
against the JAX probes; the CUDA kernels against their plain versions on the
card.

The JAX probes are tools/fused_argmax_probe.py, loaded by path and run in
Pallas interpret mode: pallas_call is wrapped with interpret=True, and the
wrapper keeps each call's operands and outputs.  The probes check themselves
as they run.  The K5 probes are held to the JAX probes' own oracle (the
matmul engine and masked_region_argmax, no interpreter).
"""

import jax
import numpy as np
import pytest
import torch

from pvot_torch.tools import fused_argmax_probe as fap
from tests.jax_probes import capture, load_tool, tensors

OWN = [name for name, _ in fap.PROBES if name not in fap.K5_PROBES]
CASES = dict(fap.PROBES)
# The plain version against the JAX kernel's interpret-mode output: exactly,
# except the products, held within the probe's own bound (the interpreter
# sums float32 products in its own order; dot_high_emul's operands are
# already bf16, so only the order differs).
BOUNDS = {
    "dot_high_emul": ("of the largest", 1e-6),
    "dot_rhs_lane": ("absolute", 1e-4),
    "when_heavy": ("absolute", 1e-4),
    "shear_dot": ("of the largest", 1e-5),
    "shear_dot_val": ("of the largest", 1e-5),
}


def hold(name, got, want):
    """got against the JAX output under BOUNDS (exactly by default)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, got.shape, want.dtype)
    kind, bound = BOUNDS.get(name, ("exact", 0.0))
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    limit = bound * np.abs(want).max() if kind == "of the largest" else bound
    assert d <= limit, f"{name}: {d} > {limit}"


@pytest.fixture(scope="module")
def jax_tool():
    return load_tool("fused_argmax_probe")


@pytest.fixture(scope="module")
def jax_calls(jax_tool):
    return capture(dict(jax_tool.PROBES), OWN)


@pytest.mark.parametrize("name", OWN)
def test_operands_equal_the_jax_probes(jax_calls, name):
    case = CASES[name]()
    operands, _ = jax_calls[name]
    assert len(case.operands) == len(operands)
    for mine, theirs in zip(case.operands, operands):
        if theirs.dtype.name == "bfloat16":
            theirs = theirs.astype(np.float32)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("name", OWN)
def test_plain_version_matches_the_jax_kernel(jax_calls, name):
    case = CASES[name]()
    operands, outputs = jax_calls[name]
    got = fap._numpy(case.plain(*tensors(case, operands)))
    assert len(got) == len(outputs)
    for g, w in zip(got, outputs):
        hold(name, g, w)
    case.check(got)  # and the probe's own assertion, restated


@pytest.mark.parametrize("name", fap.K5_PROBES)
def test_k5_probes_match_the_jax_oracle(name):
    """The port's path on the CPU (the plain K5) against the JAX probes'
    oracle, the matmul engine and masked_region_argmax
    (tools/fused_argmax_probe.py:176; each region's map made once, under
    jax.jit): the value within 2e-5, (x, y) exactly."""
    import jax.numpy as jnp
    from pvot.ops.ncc_matmul import ncc_map_matmul
    from pvot.ops.search import WindowBounds, masked_region_argmax

    case = CASES[name]()
    rows = case.plain(*case.args("cpu")).numpy()
    if name == "vmap_fused":
        regions, templs = case.operands
        span = regions.shape[1] - templs.shape[1] + 1
        lanes = [(s, (3 * s + 1, 3 * s + span - 2, 5 * s + 2, 5 * s + span - 4), 3 * s, 5 * s)
                 for s in range(4)]
    else:
        region, templ = case.operands
        regions, templs = region[None], templ[None]
        span = region.shape[0] - templ.shape[0] + 1
        rng = np.random.default_rng({"fused_region": 10, "fused_multitile": 11}[name])
        rng.random(region.shape, np.float32), rng.random(templ.shape, np.float32)
        x0, y0 = int(rng.integers(0, 500)), int(rng.integers(0, 300))
        lanes = [(0, (x0 + a, x0 + b, y0 + c, y0 + d), x0, y0)
                 for a, b, c, d in [(0, span - 1, 0, span - 1), (5, span - 7, 11, span - 3),
                                    (span // 2,) * 4]]
    assert len(rows) == len(lanes)
    maps = {}
    for row, (s, box, x0, y0) in zip(rows, lanes):
        if s not in maps:
            maps[s] = jax.jit(ncc_map_matmul)(jnp.asarray(regions[s]), jnp.asarray(templs[s]))
        v, x, y = masked_region_argmax(maps[s], jnp.int32(x0), jnp.int32(y0), WindowBounds(*box))
        assert abs(row[0] - float(v)) < 2e-5 and [int(row[1]), int(row[2])] == [int(x), int(y)]


@pytest.mark.parametrize("name, flops", [
    # K5: 2 th tw operations a position inside each window, 80 x 80 templates.
    ("fused_region", 2.0 * 6400 * (121 * 121 + 110 * 108 + 1)),
    ("fused_multitile", 2.0 * 6400 * (321 * 321 + 310 * 308 + 1)),
    ("vmap_fused", 4 * 2.0 * 6400 * 119 * 116),
    ("when_heavy", 2.0 * 128**3),  # one product, written twice
])
def test_bound_counts_the_work_the_function_needs(name, flops):
    assert CASES[name]().flops == flops


def test_copied_constants(jax_tool, jax_calls):
    assert fap.TX == jax_tool.TX == 128
    assert fap.U8_SCALE == np.float32(1 / 255)
    assert jax_calls["scalar_align"][1][0][0, :4].tolist() == list(fap.SCALAR_ALIGN_WANT)
    assert fap.dyn_hbm_dma_offsets() == [0, 16, 48, 112]


def test_dot_rhs_lane_keeps_float32():
    """The TPU miscompiled dot_rhs_lane to one bf16 pass (5.4e-2 abs); the
    port's product is float32: within 1e-4 of the exact one, and 1e-5 of
    it relative to the largest value, where one bf16 pass is off by 1e-3."""
    case = CASES["dot_rhs_lane"]()
    a, b = case.args("cpu")
    want = fap._prod(*case.operands[:1], case.operands[1].T)
    got = fap.gemm(a, b, transpose_b=True).numpy()
    assert fap._max_abs(got, want) < 1e-4
    one_pass = fap.gemm(a, b.t().contiguous(), 1).numpy()
    assert fap._max_abs(one_pass, want) > 100 * fap._max_abs(got, want) + 1e-3


def test_wrappers_on_cpu_run_the_plain_versions():
    before = [w.launches for w in fap.WRAPPERS]
    for name in OWN:
        case = CASES[name]()
        args = case.args("cpu")
        for g, r in zip(fap._tuple(case.call(*args)), fap._tuple(case.plain(*args))):
            assert torch.equal(g, r), name
    assert [w.launches for w in fap.WRAPPERS] == before
    x = torch.zeros((8, 128))
    for bad in (lambda: fap.tile_reduce(x.to(torch.int32)),
                lambda: fap.elementwise("u8", x),
                lambda: fap.gemm(x, torch.zeros((64, 8))),
                lambda: fap.gemm(x, torch.zeros((128, 8)), 2),
                lambda: fap.window(x, torch.zeros(3, dtype=torch.int32)),
                lambda: fap.carry_sum(x, 3),
                lambda: fap.gated_gemm(x, x, 2),
                lambda: fap.gated_copy(x[None], 4, 0, 8, 8),
                lambda: fap.roll(x, torch.zeros(3, dtype=torch.int32)),
                lambda: fap.shear_corr(x, torch.zeros((8, 64)), 4, 4)):
        with pytest.raises(ValueError):
            bad()


def test_entry_point_on_cpu_passes_every_probe(capsys):
    # Every probe but the two larger K5 ones, whose plain K5 (a float64
    # convolution over 400 x 400 and 4 x 200 x 200 regions) runs once, in
    # test_k5_probes_match_the_jax_oracle; fused_region stands for them here.
    names = [name for name, _ in fap.PROBES if name not in ("fused_multitile", "vmap_fused")]
    assert fap.main(["--device", "cpu", *names]) == 0
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith(("PASS", "FAIL"))] == [
        f"PASS {name}" for name in names]
    assert fap.main(["--device", "cpu", "no_such_probe"]) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py covers the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(cuda_device):
    for name, make in fap.PROBES:
        fap.run_case(name, make(), cuda_device)
    # The product kernels' edge shapes: one launch a call, two calls bit-equal.
    for name, make in fap.GEMM_EDGE_PROBES:
        case = make()
        args = case.args(cuda_device)
        fap.run_case(name, case, cuda_device)
        before = fap.gemm.launches
        assert torch.equal(case.call(*args), case.call(*args)), name
        assert fap.gemm.launches == before + 2, name
