"""The product kernels' plan (pvot_torch.tools.fused_argmax_probe.gemm_plan)
and their summation order, on the CPU.

The plan cuts C into tiles and k into splits, one block a tile and split
(csrc/argmax_probe.cu, P3).  Its invariants are held at every product
probe's shape and at the edge shapes (fused_argmax_probe.GEMM_EDGES).  A
float32 numpy model of the kernels' order of sums (chunks of FMAs or of
mma steps, then the block's groups, then the splits, each in order) is held
to the plain version within the probes' own tolerances: 1e-6 (float32) and
1e-5 (bf16 passes) of the plain version's largest value.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pvot_torch.ops.ncc_reference import split_bf16
from pvot_torch.tools import fused_argmax_probe as fap
from pvot_torch.tools import pallas_probe as pp

CASES = dict(fap.PROBES + pp.PROBES)
# Each product probe's (m, k, n, passes), and where its A and B are among
# the case's operands: ("kn" | "nk" | "planes", index of A, index of B,
# lda of band rows or None).
PROBES = {
    "matmul": ((8, 256, 128, 1), ("kn", 0, 1, None)),
    "big_matmul": ((8, 20480, 128, 1), ("kn", 0, 1, None)),
    "dot_highest": ((8, 2048, 128, 0), ("kn", 0, 1, None)),
    "dot_high": ((8, 2048, 128, 3), ("kn", 0, 1, None)),
    "scratch_copy_dot": ((16, 2048, 128, 0), ("kn", 0, 1, 256)),
    "unrolled_dots": ((16, 2048, 128, 0), ("kn", 0, 1, 256)),
    "selector_dot": ((8, 16, 128, 0), ("kn", 1, 0, None)),  # gemm(sel, x)
    "dot_high_emul": ((128, 256, 128, 3), ("planes", 0, 1, None)),
    "dot_rhs_lane": ((136, 256, 1024, 0), ("nk", 0, 1, None)),
}
SHAPES = {**{n: s for n, (s, _) in PROBES.items()},
          **{n: e[:4] for n, e in fap.GEMM_EDGES.items()}}
# The kernels' order, from the plan's tilings (the launch refuses a tiling
# the kernels do not have): the FMA groups each take one chunk of
# GEMM_K_STEP terms a stage; the mma warps each take stage_k / groups k of a
# stage in steps of GEMM_K_STEP, a fragment joining the warp's total every
# GEMM_MMA_CHUNK steps.
CHUNK = fap.GEMM_K_STEP
MMA = fap.GEMM_MMA
MMA_WARP_K = MMA.stage_k // MMA.groups
SOURCES = Path(fap.__file__).resolve().parents[1] / "csrc"


def operands(name):
    """(A (m, k) float32, B (k, n) float32, or with planes (hi, lo) as
    float32 values) of a probe or an edge shape."""
    if name in PROBES:
        (m, k, n, _), (form, ia, ib, lda) = PROBES[name]
        ops = CASES[name]().operands
        a = ops[ia]
        b = ops[ib] if form != "planes" else (ops[1], ops[2])
    else:
        m, k, n, _, form, lda = fap.GEMM_EDGES[name]
        ops = fap.gemm_edge_operands(name)
        a = ops[0]
        b = ops[1] if form != "planes" else (ops[1], ops[2])
    A = np.lib.stride_tricks.as_strided(a.reshape(-1), (m, k), (4 * a.shape[1], 4)).copy()
    if form == "nk":
        b = np.ascontiguousarray(b.T)
    return A, b, form


def plain(A, B, passes, form):
    """The plain version (gemm_reference) on (A, B)."""
    if form == "planes":
        hi, lo = (torch.from_numpy(v).to(torch.bfloat16) for v in B)
        return fap.gemm_reference(torch.from_numpy(A), hi, passes, b_lo=lo).numpy()
    return fap.gemm_reference(torch.from_numpy(A), torch.from_numpy(B), passes).numpy()


def fma_order(A, B, plan):
    """C as the FMA kernel sums it: a chunk of kChunk terms in FMAs (each
    rounded once to float32), joined to its group's total; the block's
    groups in order; the splits in order."""
    groups, stage_k = plan.tiling.groups, plan.tiling.stage_k
    assert stage_k == groups * CHUNK
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    total = np.zeros((A.shape[0], B.shape[1]), np.float32)
    for lo, hi in plan.k_ranges(A.shape[1]):
        acc = np.zeros((groups,) + total.shape, np.float32)
        for k0 in range(lo, hi, CHUNK):
            g = (k0 - lo) % stage_k // CHUNK
            part = np.zeros(total.shape, np.float32)
            for kk in range(k0, min(hi, k0 + CHUNK)):
                part = (part + np.outer(A64[:, kk], B64[kk])).astype(np.float32)
            acc[g] = acc[g] + part
        block = np.zeros(total.shape, np.float32)
        for g in range(groups):
            block = block + acc[g]
        total = total + block
    return total


def mma_order(A, B, plan, passes):
    """C as the mma kernel sums it: a step's 16 k of the tier's bf16
    products (exact) summed into float32, a fragment's kMmaChunk steps in
    float32, joined to the warp's total; the warps in order; the splits in
    order."""
    ah, al = (v.numpy().astype(np.float64) for v in split_bf16(torch.from_numpy(A)))
    if isinstance(B, tuple):
        bh, bl = (v.astype(np.float64) for v in B)
    else:
        bh, bl = (v.numpy().astype(np.float64) for v in split_bf16(torch.from_numpy(B)))
    total = np.zeros((A.shape[0], bh.shape[1]), np.float32)
    for lo, hi in plan.k_ranges(A.shape[1]):
        acc = np.zeros((MMA.groups,) + total.shape, np.float32)
        frag = np.zeros_like(acc)
        steps = np.zeros(MMA.groups, int)
        for k0 in range(lo, hi, 16):
            w = (k0 - lo) % MMA.stage_k // MMA_WARP_K
            s = slice(k0, min(hi, k0 + 16))
            prod = ah[:, s] @ bh[s]
            if passes == 3:
                prod = prod + ah[:, s] @ bl[s] + al[:, s] @ bh[s]
            frag[w] = frag[w] + prod.astype(np.float32)
            steps[w] += 1
            if steps[w] == fap.GEMM_MMA_CHUNK:
                acc[w], frag[w], steps[w] = acc[w] + frag[w], 0.0, 0
        acc = acc + frag
        block = np.zeros(total.shape, np.float32)
        for w in range(MMA.groups):
            block = block + acc[w]
        total = total + block
    return total


def test_probe_shapes_are_the_cases():
    for name, ((m, k, n, passes), (form, ia, ib, lda)) in PROBES.items():
        case = CASES[name]()
        A, B, _ = operands(name)
        assert A.shape == (m, k) and case.passes == passes, name
        out = case.plain(*case.args("cpu"))
        assert tuple(out.shape) == (m, n), name
        want = plain(A, B, passes, form)
        np.testing.assert_array_equal(out.numpy(), want, err_msg=name)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_covers_k_once_within_32_bits(name):
    m, k, n, passes = SHAPES[name]
    plan = fap.gemm_plan(m, n, k, passes)
    t = plan.tiling
    assert t == fap.GEMM_MMA if passes else t in (fap.GEMM_FMA, fap.GEMM_FMA_WIDE)
    assert plan.tiles == -(-m // t.tile_m) * -(-n // t.tile_n)
    assert plan.k_split % fap.GEMM_K_STEP == 0
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if plan.splits > 1:
        assert plan.blocks <= 2 * fap.GEMM_SMS
        assert plan.ws_floats == plan.blocks * t.tile_m * t.tile_n
    else:
        assert plan.ws_floats == 0
    lda = fap.GEMM_EDGES[name][5] if name in fap.GEMM_EDGES else PROBES[name][1][3]
    lda = k if lda is None else lda
    for index in ((m - 1) * lda + k, k * n, m * n, plan.ws_floats, plan.blocks):
        assert index < 2**31  # the kernels' indices are 32-bit


def test_plan_fills_the_card_and_spares_small_products():
    for name in ("big_matmul", "dot_highest", "dot_high", "scratch_copy_dot"):
        plan = fap.gemm_plan(*(SHAPES[name][i] for i in (0, 2, 1, 3)))
        assert plan.blocks >= 132 and plan.splits > 1, (name, plan)
    for name in ("matmul", "selector_dot", "dot_high_emul", "dot_rhs_lane"):
        plan = fap.gemm_plan(*(SHAPES[name][i] for i in (0, 2, 1, 3)))
        assert plan.splits == 1 and plan.ws_floats == 0, (name, plan)
    assert fap.gemm_plan(136, 1024, 256, 0).tiling == fap.GEMM_FMA_WIDE  # dot_rhs_lane
    assert fap.gemm_plan(8, 128, 16, 0).k_split == 16


@pytest.mark.parametrize("name", list(SHAPES))
def test_summation_order_within_the_probes_tolerance(name):
    m, k, n, passes = SHAPES[name]
    A, B, form = operands(name)
    plan = fap.gemm_plan(m, n, k, passes)
    got = mma_order(A, B, plan, passes) if passes else fma_order(A, B, plan)
    want = plain(A, B, passes, form)
    tol = 1e-5 if passes else 1e-6
    d = np.abs(got.astype(np.float64) - want).max()
    assert d <= tol * np.abs(want).max(), (name, d, plan)


def test_order_constants_are_the_kernels():
    """The constants of the order of sums that the launch does not pass (a
    step's and a chunk's k, the steps of an mma fragment) and the mma
    tiling, as the CUDA source states them."""
    cu = (SOURCES / "argmax_probe.cu").read_text()
    cuh = (SOURCES / "probe_gemm.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"\b{name} = (\d+)\b", src).group(1))

    assert const(cu, "kGemmStep") == fap.GEMM_K_STEP == const(cuh, "kChunk")
    assert const(cu, "kMmaChunk") == fap.GEMM_MMA_CHUNK
    assert (const(cu, "kMmaTm"), const(cu, "kMmaTn")) == (MMA.tile_m, MMA.tile_n)
    assert const(cu, "kThreads") // 32 == MMA.groups and MMA_WARP_K == 2 * CHUNK
    assert re.search(r"kMmaStageK = kWarps \* 32\b", cu)


@pytest.mark.parametrize("name", ["dot_high_emul", "planes", "planes_odd", "dot_highest"])
def test_bound_reads_each_operand_at_its_dtype(name):
    """A product's bound moves A in float32, B as the call takes it (bf16
    planes at 2 bytes an element, though the case keeps them as float32)
    and C in float32, each once."""
    from pvot_torch.bench import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S

    case = CASES[name]() if name in CASES else fap.case_gemm_edge(name)
    m, k, n = fap.gemm_shape(*case.product(*case.args("cpu")))
    b_bytes = 2 * 2 * k * n if case.dtypes else 4 * k * n
    t_bytes = (4 * m * k + b_bytes + 4 * m * n) / HBM_BYTES_PER_S
    t_ops = case.flops * case.passes / BF16_FLOPS if case.passes else case.flops / FP32_FLOPS
    ms, by = fap.case_bound(case, torch.empty((m, n), dtype=torch.float32))
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes > t_ops else "operations")
    if name == "dot_high_emul":  # A 131,072 + planes 2 x 65,536 + C 65,536 bytes
        assert 4 * m * k + b_bytes + 4 * m * n == 327_680 and by == "bytes"
