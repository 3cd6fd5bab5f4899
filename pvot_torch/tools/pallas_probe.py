"""The Pallas NCC probe ladder on the card: the port of tools/pallas_probe.py
(T5).

On the TPU the ladder ran from a trivial kernel to the full NCC kernel, one
tiny pallas_call a rung (14 of them), to find the construct the relay's
Mosaic build rejected.  Here each pallas_call's function is a CUDA kernel,
behind a wrapper with a plain PyTorch version beside it:

  elementwise   trivial, grid, smem                 (csrc/argmax_probe.cu, P2)
  gemm          matmul, big_matmul (one bf16 pass), dot_highest (float32),
                dot_high (3 bf16 passes), scratch_copy_dot and unrolled_dots
                (the band products), selector_dot    (argmax_probe.cu, P3)
  window        dyn_sublane, concat_lanes, aligned_dyn16, slice16_add
                                                     (argmax_probe.cu, P4)
  toeplitz_ncc  new_ncc_mini                         (csrc/pallas_probe.cu, P8)

The shared kernels are T4's (pvot_torch/tools/fused_argmax_probe.py, whose
wrappers count their launches); small_ncc and headline_ncc run the port's
K4 (pvot_torch/ops/ncc_pallas.py `ncc_map_pallas`).  Each probe builds its
inputs as the JAX probe does, holds the kernel to the probe's own bound
(restated against float64 products) and to the plain version, and prints
PASS or FAIL:

    python -m pvot_torch.tools.pallas_probe [--device cpu] [names...]

On the card it also prints each kernel's device microseconds a call;
`--device cpu` runs the plain versions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pvot_torch.tools.fused_argmax_probe import (
    K5_KERNEL, Case, _allclose, _at_most, _launch, _max_abs, _need, _prod, elementwise,
    elementwise_reference, gemm, gemm_case, run_catalogue, window, window_reference,
)

TX = 128  # tools/pallas_probe.py:494
K4_TOL = 1e-4  # K4 against its plain version (chip_smoke.py K4_ATOL)
NCC_MINI = dict(TH=16, TW=16, L=256, H=64, W=200)  # tools/pallas_probe.py:492-493, :537
NCC_PLAIN_TOL = 1e-5  # new_ncc_mini's kernel against its plain version, absolute (scores)


# ---- P8: the aligned-window NCC ----------------------------------------------


def _toeplitz_args(img, toep, box, scal, gh, gw):
    for name, t in (("img", img), ("toep", toep), ("box", box), ("scal", scal)):
        _need(t, name, torch.float32, None if name == "scal" else 2, img.device)
    length, tx = box.shape
    n_k = toep.shape[0] // length
    if (toep.shape != (n_k * length, 8 * tx) or scal.numel() != 4 or min(gh, gw) < 1
            or img.shape[0] < 8 * gh + 8 * n_k or img.shape[1] < (gw - 1) * tx + length):
        raise ValueError(f"img {tuple(img.shape)}, toep {tuple(toep.shape)}, box "
                         f"{tuple(box.shape)} for a {gh} x {gw} grid")
    return n_k, length, tx


def toeplitz_ncc_reference(img, toep, box, scal, gh: int, gw: int) -> torch.Tensor:
    """Plain version of `toeplitz_ncc`: the correlation and the box sums'
    products in float64, each rounded once to float32, the window sums and
    the epilogue in float32 in the kernel's order."""
    n_k, length, tx = _toeplitz_args(img, toep, box, scal, gh, gw)
    dev = img.device
    i = torch.arange(gh, device=dev)[:, None, None, None]
    r = torch.arange(8, device=dev)[None, :, None, None]
    j = torch.arange(gw, device=dev)[None, None, :, None]
    l = torch.arange(length, device=dev)[None, None, None, :]
    acc = torch.zeros((gh, 8, gw, tx), dtype=torch.float64, device=dev)
    bsum = torch.zeros((gh, 8, gw, length), dtype=torch.float32, device=dev)
    bsq = torch.zeros_like(bsum)
    for k in range(n_k):
        for p in range(8):
            w = img[8 * (i + k) + p + r, tx * j + l]  # (gh, 8, gw, L)
            acc = acc + w.double() @ toep[k * length : (k + 1) * length,
                                          p * tx : (p + 1) * tx].double()
            bsum = bsum + w
            bsq = bsq + w * w
    wsum = (bsum.double() @ box.double()).to(torch.float32)
    wssq = (bsq.double() @ box.double()).to(torch.float32)
    t_std, sum_tc, n = scal.reshape(-1)[1], scal.reshape(-1)[2], scal.reshape(-1)[3]
    mean = wsum / n
    var = wssq / n - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    cov = acc.to(torch.float32) - mean * sum_tc
    out = cov / ((std + 1e-6) * (t_std + 1e-6) * n)
    return out.reshape(gh * 8, gw * tx)


def toeplitz_ncc(img: torch.Tensor, toep: torch.Tensor, box: torch.Tensor, scal: torch.Tensor,
                 gh: int, gw: int) -> torch.Tensor:
    """new_ncc_mini's kernel, (8 gh, tx gw) float32 NCC scores from the
    probe's operands: the zero-padded image, the Toeplitz operator toep (n_k
    L, 8 tx) of the centered template, the box matrix (L, tx) and scal =
    (t_mean, t_std, sum of the centered template, n) in device memory
    (pvot_torch/csrc/pallas_probe.cu has the formula)."""
    _toeplitz_args(img, toep, box, scal, gh, gw)
    if img.device.type == "cpu":
        return toeplitz_ncc_reference(img, toep, box, scal, gh, gw)
    n_k, length, tx = toep.shape[0] // box.shape[0], box.shape[0], box.shape[1]
    out = torch.empty((8 * gh, tx * gw), dtype=torch.float32, device=img.device)
    _launch(toeplitz_ncc, "pvot_probe_toeplitz_ncc", img.device, img.data_ptr(), img.shape[0],
            img.shape[1], toep.data_ptr(), n_k, length, tx, box.data_ptr(), scal.data_ptr(),
            out.data_ptr(), gh, gw)
    return out


toeplitz_ncc.launches = 0
toeplitz_ncc.cuda_kernels = ("toeplitz_ncc_kernel",)
WRAPPERS = (elementwise, gemm, window, toeplitz_ncc)


# ---- the probes --------------------------------------------------------------


def case_trivial() -> Case:
    x = np.ones((8, 128), np.float32)
    return Case(elementwise, (x,), lambda x: elementwise("times2", x),
                lambda x: elementwise_reference("times2", x),
                lambda out: _allclose(out[0], np.full_like(x, 2.0), 1e-7),
                library=lambda x: torch.mul(x, 2.0), flops=x.size)


def case_grid() -> Case:
    x = np.arange(32 * 256, dtype=np.float32).reshape(32, 256)
    return Case(elementwise, (x,), lambda x: elementwise("plus1", x),
                lambda x: elementwise_reference("plus1", x),
                lambda out: _allclose(out[0], x + 1.0, 1e-7),
                library=lambda x: torch.add(x, 1.0), flops=x.size)


def _product_case(a, b, passes: int, rtol: float, rows=None, want=None) -> Case:
    """A product probe held to the JAX probe's assert_allclose(rtol) against
    the exact product (float64, rounded once), and to the plain version
    within 1e-6 (float32) or 1e-5 (bf16 passes) of its largest value."""
    m = a.shape[0] if rows is None else rows
    k, n = b.shape
    if want is None:
        want = _prod(a, b)

    def library_args(a, b):
        if passes == 1:  # bf16 operands, made before the timing
            return a.to(torch.bfloat16), b.to(torch.bfloat16)
        return a.reshape(-1).as_strided((m, k), (a.shape[1], 1)), b

    return gemm_case((a, b), lambda a, b: (a, b, passes, None, False, rows),
                     lambda out: _allclose(out[0], want, rtol), tol=1e-5 if passes else 1e-6,
                     library=torch.matmul, library_args=library_args, flops=2.0 * m * n * k,
                     passes=passes)


def case_matmul() -> Case:
    rng = np.random.default_rng(0)
    a = rng.random((8, 256), np.float32)
    b = rng.random((256, 128), np.float32)
    return _product_case(a, b, 1, 3e-3)  # one bf16 pass (~1e-3 relative)


def case_big_matmul() -> Case:
    rng = np.random.default_rng(0)
    a = rng.random((8, 80 * 256), np.float32)
    b = rng.random((80 * 256, 128), np.float32)
    return _product_case(a, b, 1, 1e-4)


def _precision_case(passes: int, rtol: float) -> Case:
    """tools/pallas_probe.py `_matmul_precision_probe` (:93): (8, 2048) @
    (2048, 128) against the float64 product."""
    rng = np.random.default_rng(0)
    a = rng.random((8, 2048), np.float32)
    b = rng.random((2048, 128), np.float32)
    return _product_case(a, b, passes, rtol)


def case_dot_highest() -> Case:
    return _precision_case(0, 1e-5)


def case_dot_high() -> Case:
    return _precision_case(3, 1e-4)


def _band_case() -> Case:
    """scratch_copy_dot and unrolled_dots (:133, :181): block i of 2 is the
    concatenation of x[8 i + r : 8 i + r + 8] over r < 8, times b (2048,
    128), at HIGHEST: rows 8 i + r' of A read x from row 8 i + r' on."""
    rng = np.random.default_rng(0)
    x = rng.random((24, 256), np.float32)
    b = rng.random((8 * 256, 128), np.float32)
    bands = np.stack([np.concatenate([x[i * 8 + r : i * 8 + r + 8] for r in range(8)], axis=1)
                      for i in range(2)]).reshape(16, 8 * 256)
    return _product_case(x, b, 0, 1e-4, rows=16, want=_prod(bands, b))


def case_dyn_sublane() -> Case:
    x = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    kw = dict(blocks=2, block_step=8, terms=3, term_step=1, rows=8, cols=128)
    want = np.stack([sum(x[i * 8 + r : i * 8 + r + 8] for r in range(3))
                     for i in range(2)]).reshape(16, 128)
    return Case(window, (x,), lambda x: window(x, **kw), lambda x: window_reference(x, **kw),
                lambda out: _allclose(out[0], want, 1e-7),
                library=lambda x: x.as_strided((2, 3, 8, 128), (8 * 128, 128, 128, 1)).sum(1),
                flops=2 * 16 * 128, read_bytes=18 * 128 * 4)


def case_concat_lanes() -> Case:
    x = np.arange(16 * 256, dtype=np.float32).reshape(16, 256)
    kw = dict(rows=8, cols=256, band=256)
    return Case(window, (x,), lambda x: window(x, **kw), lambda x: window_reference(x, **kw),
                lambda out: _allclose(out[0], x[:8], 1e-7),
                library=lambda x: x[:8].clone(), read_bytes=8 * 256 * 4)


def case_smem() -> Case:
    x = np.ones((8, 128), np.float32)
    s = np.asarray([[2.0, 3.0, 4.0, 5.0]], np.float32)
    return Case(elementwise, (x, s), lambda x, s: elementwise("mul_f32", x, s, 1),
                lambda x, s: elementwise_reference("mul_f32", x, s, 1),
                lambda out: _allclose(out[0], np.full_like(x, 3.0), 1e-7),
                library=lambda x, s: torch.mul(x, s[0, 1]), flops=x.size)


def _k4_case(img_shape, templ_shape) -> Case:
    """small_ncc and headline_ncc (:327, :343): the port's K4 map against the
    matmul engine within 1e-3, as the probes assert."""
    from pvot_torch.ops.ncc_matmul import ncc_map_matmul
    from pvot_torch.ops.ncc_pallas import ncc_map_pallas, ncc_map_pallas_reference

    rng = np.random.default_rng(0)
    img = rng.random(img_shape, np.float32)
    templ = rng.random(templ_shape, np.float32)
    want = ncc_map_matmul(torch.from_numpy(img), torch.from_numpy(templ)).numpy()
    out_px = (img_shape[0] - templ_shape[0] + 1) * (img_shape[1] - templ_shape[1] + 1)
    return Case(ncc_map_pallas, (img, templ), ncc_map_pallas, ncc_map_pallas_reference,
                lambda out: _at_most(_max_abs(out[0], want), 1e-3, "err"), tol=K4_TOL,
                cuda_kernels=K5_KERNEL,
                absolute=True, flops=2.0 * out_px * templ.size)


def case_small_ncc() -> Case:
    return _k4_case((64, 256), (8, 8))


def case_headline_ncc() -> Case:
    return _k4_case((200, 200), (80, 80))


def case_aligned_dyn16() -> Case:
    x = np.arange(40 * 256, dtype=np.float32).reshape(40, 256)
    kw = dict(blocks=2, block_step=8, terms=2, term_step=8, rows=8, cols=128)
    want = np.stack([(x[8 * i : 8 * i + 16] + x[8 * (i + 1) : 8 * (i + 1) + 16])[:8, :128]
                     for i in range(2)]).reshape(16, 128)
    return Case(window, (x,), lambda x: window(x, **kw), lambda x: window_reference(x, **kw),
                lambda out: _allclose(out[0], want, 1e-7),
                library=lambda x: x.as_strided((2, 2, 8, 128), (2048, 2048, 256, 1)).sum(1),
                flops=16 * 128, read_bytes=4 * 8 * 128 * 4)


def case_slice16_add() -> Case:
    x = np.arange(16 * 128, dtype=np.float32).reshape(16, 128)
    kw = dict(terms=8, term_step=1, rows=8, cols=128)
    return Case(window, (x,), lambda x: window(x, **kw), lambda x: window_reference(x, **kw),
                lambda out: _allclose(out[0], sum(x[p : p + 8] for p in range(8)), 1e-7),
                library=lambda x: x.as_strided((8, 8, 128), (128, 128, 1)).sum(0),
                flops=7 * 8 * 128)


SELECTOR_SHIFT = 3  # tools/pallas_probe.py:465


def case_selector_dot() -> Case:
    x = np.random.default_rng(0).random((16, 128), np.float32)
    sel = np.zeros((8, 16), np.float32)
    for ty in range(8):
        sel[ty, ty + SELECTOR_SHIFT] = 1.0  # shift-by-3 selector
    return gemm_case((x, sel), lambda x, sel: (sel, x),
                     lambda out: _allclose(out[0], x[3:11], 1e-6), tol=1e-6,
                     library=lambda x, sel: torch.matmul(sel, x),
                     flops=2.0 * 128 * np.count_nonzero(sel))  # the selector's ones


def new_ncc_mini_operands():
    """(img_pad, toep, box, scal, img, templ, gh, gw) as
    tools/pallas_probe.py `probe_new_ncc_mini` (:536-558) builds them, the
    template's stats from the port's template_stats."""
    from pvot_torch.ops.ncc_reference import template_stats

    th, tw, length, h, w = (NCC_MINI[k] for k in ("TH", "TW", "L", "H", "W"))
    n_k = th // 8
    rng = np.random.default_rng(0)
    img = rng.random((h, w), np.float32)
    templ = rng.random((th, tw), np.float32)
    t_mean, t_std = (float(v) for v in template_stats(torch.from_numpy(templ)))
    tc = templ - np.float32(t_mean)
    # toep[k L + l, p TX + dx] = tc[8 k + p, l - dx] for 0 <= l - dx < TW
    toep = np.zeros((n_k * length, 8 * TX), np.float32)
    for r in range(th):
        k, p = divmod(r, 8)
        for dx in range(TX):
            toep[k * length + dx : k * length + dx + tw, p * TX + dx] = tc[r]
    box = np.zeros((length, TX), np.float32)
    for dx in range(TX):
        box[dx : dx + tw, dx] = 1.0
    out_h, out_w = h - th + 1, w - tw + 1
    gh, gw = -(-out_h // 8), -(-out_w // TX)
    img_pad = np.zeros((gh * 8 + 8 * (n_k - 1) + 16, (gw - 1) * TX + length), np.float32)
    img_pad[:h, :w] = img
    scal = np.array([[t_mean, t_std, float(tc.sum()), th * tw]], np.float32)
    return img_pad, toep, box, scal, img, templ, gh, gw


def case_new_ncc_mini() -> Case:
    from pvot_torch.ops.ncc_matmul import ncc_map_matmul

    img_pad, toep, box, scal, img, templ, gh, gw = new_ncc_mini_operands()
    out_h, out_w = img.shape[0] - templ.shape[0] + 1, img.shape[1] - templ.shape[1] + 1
    want = ncc_map_matmul(torch.from_numpy(img), torch.from_numpy(templ)).numpy()
    # The operators' nonzeros: the correlation and the two box products (sum
    # and sum of squares), each output row block times each grid column.
    flops = 2.0 * gh * 8 * gw * (np.count_nonzero(toep) + 2 * np.count_nonzero(box))
    return Case(toeplitz_ncc, (img_pad, toep, box, scal),
                lambda *ops: toeplitz_ncc(*ops, gh, gw),
                lambda *ops: toeplitz_ncc_reference(*ops, gh, gw),
                lambda out: _at_most(_max_abs(out[0][:out_h, :out_w], want), 1e-4, "err"),
                tol=NCC_PLAIN_TOL, absolute=True, flops=flops)


# The JAX tool's PROBES, in its order (tools/pallas_probe.py:359, :579-582).
PROBES = [
    ("trivial", case_trivial),
    ("grid", case_grid),
    ("matmul", case_matmul),
    ("big_matmul", case_big_matmul),
    ("dyn_sublane", case_dyn_sublane),
    ("concat_lanes", case_concat_lanes),
    ("smem", case_smem),
    ("dot_highest", case_dot_highest),
    ("dot_high", case_dot_high),
    ("scratch_copy_dot", _band_case),
    ("unrolled_dots", _band_case),  # the same function as scratch_copy_dot
    ("small_ncc", case_small_ncc),
    ("headline_ncc", case_headline_ncc),
    ("aligned_dyn16", case_aligned_dyn16),
    ("slice16_add", case_slice16_add),
    ("selector_dot", case_selector_dot),
    ("new_ncc_mini", case_new_ncc_mini),
]
K4_PROBES = ("small_ncc", "headline_ncc")


def main(argv=None) -> int:
    return run_catalogue(PROBES, argv, "pallas_probe")


if __name__ == "__main__":
    sys.exit(main())
