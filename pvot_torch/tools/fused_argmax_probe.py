"""The fused-argmax probe catalogue on the card: the port of
tools/fused_argmax_probe.py (T4).

On the TPU each probe tried one construct of the relay's Mosaic build in a
tiny pallas_call (20 of them), and three probes drove the fused region
argmax (K5).  Here each pallas_call's function is a CUDA kernel of
pvot_torch/csrc/argmax_probe.cu, behind a wrapper with a plain PyTorch
version beside it:

  tile_reduce   P1  reduce_max, argmax_tiebreak, two_outputs
  elementwise   P2  smem_i32_in, u8_convert, scalar_align (and T5's trivial,
                    grid, smem)
  gemm          P3  dot_high_emul (3 bf16 passes, B as hi and lo planes),
                    dot_rhs_lane (float32, B given as (n, k)) (and T5's
                    products)
  window        P4  dma_dyn_2d, dma_3d_lead, dma_u8_slab (and T5's window
                    sums)
  carry_sum, offset_chain, gated_gemm, gated_copy
                P5  scratch_carry, dyn_hbm_dma, when_heavy, when_dma: one
                    block walks the TPU grid's steps in order
  roll          P6  roll_static, roll_strided, roll_traced
  shear_corr    P7  shear_dot, shear_dot_val

fused_region, fused_multitile and vmap_fused run the port's K5
(pvot_torch/ops/ncc_pallas.py).  On a CUDA tensor a wrapper checks its
operands, launches its kernel on the current stream (`<wrapper>.launches`
grows by 1) and raises on any refusal; on a CPU tensor it runs the plain
version.  Precision follows the TPU: HIGHEST is float32 FMAs, HIGH 3 bf16
passes (hi hi + hi lo + lo hi), Pallas's default one bf16 pass; the plain
products sum in float64 and round once.

Each probe builds its inputs as the JAX probe does (the same default_rng
seeds, shapes and planted values), runs the kernel, holds it to the JAX
probe's own assertion and bound (restated here, against float64 products)
and to the plain version, prints PASS or FAIL and exits nonzero on any FAIL:

    python -m pvot_torch.tools.fused_argmax_probe [--device cpu] [names...]

On the card it also prints each kernel's device microseconds a call;
`--device cpu` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pvot_torch.ops.ncc_reference import full_f32, split_bf16

TX = 128  # tools/fused_argmax_probe.py:51
U8_SCALE = np.float32(1 / 255)  # the probes' jnp.float32(1 / 255)
K5_VALUE_TOL = 2e-5  # tools/fused_argmax_probe.py:215: the probe's bound on the value
K5_PLAIN_TOL = 1e-5  # K5 against its plain version (chip_smoke.py K5_ATOL)
K5_KERNEL = ("ncc_kernel",)  # K4's and K5's CUDA kernel (csrc/ncc_pallas.cu)


# ---- launching ---------------------------------------------------------------


def _launch(wrapper, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point on the current stream of `device`, raise on its
    CUDA error, and count one launch on `wrapper`."""
    from pvot_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
        _build.check(err, wrapper.__name__)
    wrapper.launches += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _need(t, name: str, dtypes, ndims=None, device=None) -> torch.Tensor:
    """Raise ValueError unless t is a tensor of one of `dtypes`, of one of
    `ndims` dimensions, on `device` and, on the card, contiguous."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if not isinstance(t, torch.Tensor) or t.dtype not in dtypes:
        raise ValueError(f"{name}: expected a tensor of {dtypes}, got "
                         f"{getattr(t, 'dtype', type(t))}")
    if ndims is not None and t.ndim not in (ndims if isinstance(ndims, tuple) else (ndims,)):
        raise ValueError(f"{name}: {t.ndim} dimensions, expected {ndims}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


# ---- P1: tile reduce ---------------------------------------------------------

REDUCE_MODES = ("max", "argmax")


def tile_reduce_reference(x: torch.Tensor, mode: str = "max", fill: Optional[int] = None):
    """Plain version of `tile_reduce`."""
    flat = x.reshape(-1)
    v = torch.argmax(flat).to(torch.float32) if mode == "argmax" else torch.max(flat)
    val = v.reshape(1, 1).expand(8, TX).contiguous()
    if fill is None:
        return (val,)
    return val, torch.full((8, TX), fill, dtype=torch.int32, device=x.device)


def tile_reduce(x: torch.Tensor, mode: str = "max", fill: Optional[int] = None):
    """(val,) or, with `fill`, (val, idx): val an (8, 128) float32 tile of
    x's maximum (mode "max") or of the first row-major index of it as
    float32 ("argmax"); idx an (8, 128) int32 tile of `fill`."""
    _need(x, "x", torch.float32)
    if mode not in REDUCE_MODES or x.numel() < 1:
        raise ValueError(f"mode {mode!r} over {x.numel()} values")
    if x.device.type == "cpu":
        return tile_reduce_reference(x, mode, fill)
    val = torch.empty((8, TX), dtype=torch.float32, device=x.device)
    idx = None if fill is None else torch.empty((8, TX), dtype=torch.int32, device=x.device)
    _launch(tile_reduce, "pvot_probe_tile_reduce", x.device, x.data_ptr(), x.numel(),
            REDUCE_MODES.index(mode), val.data_ptr(), _ptr(idx), fill or 0, val.numel())
    return (val,) if idx is None else (val, idx)


# ---- P2: elementwise with scalars in device memory --------------------------

EW_OPS = ("add_i32", "mul_f32", "times2", "plus1", "u8", "align")


def elementwise_reference(op: str, x=None, scal=None, index: int = 0) -> torch.Tensor:
    """Plain version of `elementwise`."""
    if op == "add_i32":
        return x + scal.reshape(-1)[index].to(torch.float32)
    if op == "mul_f32":
        return x * scal.reshape(-1)[index]
    if op == "times2":
        return x * 2.0
    if op == "plus1":
        return x + 1.0
    if op == "u8":
        return x.to(torch.float32) * float(U8_SCALE)
    y0, x0 = scal.reshape(-1)[index], scal.reshape(-1)[index + 1]
    ya, xa = (y0 >> 5) << 5, x0 & ~127
    row = torch.zeros(TX, dtype=torch.int32, device=scal.device)
    row[:4] = torch.stack([ya, xa, y0 - ya, x0 - xa]).to(torch.int32)
    return row.expand(8, TX).contiguous()


def elementwise(op: str, x: Optional[torch.Tensor] = None, scal: Optional[torch.Tensor] = None,
                index: int = 0) -> torch.Tensor:
    """One elementwise op, its scalars read from `scal` (a tensor, in device
    memory on the card) at `index`: "add_i32" x + float(scal[index]) (int32
    scal), "mul_f32" x * scal[index], "times2", "plus1", "u8" float(x) *
    float32(1/255) (uint8 x), all float32 of x's shape; "align" an (8, 128)
    int32 tile whose lanes 0-3 are (y0 >> 5) << 5, x0 & ~127 and the two
    residuals, y0 = scal[index], x0 = scal[index + 1] (int32)."""
    if op not in EW_OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "align":
        _need(scal, "scal", torch.int32)
        if scal.numel() < index + 2:
            raise ValueError("align reads two scalars")
        dev = scal.device
    else:
        _need(x, "x", torch.uint8 if op == "u8" else torch.float32)
        dev = x.device
        if op in ("add_i32", "mul_f32"):
            _need(scal, "scal", torch.int32 if op == "add_i32" else torch.float32, device=dev)
            if not 0 <= index < scal.numel():
                raise ValueError(f"scalar index {index} of {scal.numel()}")
    if dev.type == "cpu":
        return elementwise_reference(op, x, scal, index)
    if op == "align":
        out = torch.empty((8, TX), dtype=torch.int32, device=dev)
    else:
        out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    _launch(elementwise, "pvot_probe_ew", dev, EW_OPS.index(op), _ptr(x), _ptr(scal), index,
            out.data_ptr(), out.numel(), out.shape[-1] if out.ndim else 1)
    return out


# ---- P3: products ------------------------------------------------------------


def gemm_shape(a, b, passes: int = 0, b_lo=None, transpose_b: bool = False,
               rows: Optional[int] = None) -> tuple:
    """(m, k, n) of a `gemm` call; raises ValueError on what the kernel does
    not take."""
    _need(a, "a", torch.float32, 2)
    if passes not in (0, 1, 3):
        raise ValueError(f"passes {passes}: 0 (float32), 1 or 3 bf16 passes")
    if b_lo is not None:
        _need(b, "b", torch.bfloat16, 2, a.device)
        _need(b_lo, "b_lo", torch.bfloat16, 2, a.device)
        if b_lo.shape != b.shape or passes != 3 or transpose_b:
            raise ValueError("hi and lo planes of one shape, at 3 passes")
    else:
        _need(b, "b", torch.float32, 2, a.device)
    if transpose_b and passes != 0:
        raise ValueError("B given as (n, k) at float32 only")
    n, k = b.shape if transpose_b else b.shape[::-1]
    m = a.shape[0] if rows is None else rows
    if rows is None and a.shape[1] != k:
        raise ValueError(f"a {tuple(a.shape)} against k = {k}")
    if m < 1 or (m - 1) * a.shape[1] + k > a.numel():
        raise ValueError(f"{m} rows of {k} from a {tuple(a.shape)}")
    return m, k, n


def gemm_reference(a, b, passes: int = 0, b_lo=None, transpose_b: bool = False,
                   rows: Optional[int] = None) -> torch.Tensor:
    """Plain version of `gemm`: the tier's exact products summed in float64,
    rounded to float32 once."""
    m, k, _ = gemm_shape(a, b, passes, b_lo, transpose_b, rows)
    A = a.reshape(-1).as_strided((m, k), (a.shape[1], 1))
    B = b.t() if transpose_b else b
    if passes == 0:
        return (A.double() @ B.double()).to(torch.float32)
    ah, al = (v.double() for v in split_bf16(A))
    bh, bl = ((B.double(), b_lo.double()) if b_lo is not None
              else (v.double() for v in split_bf16(B)))
    out = ah @ bh
    if passes == 3:
        out = out + ah @ bl + al @ bh
    return out.to(torch.float32)


# The product kernels' plan (csrc/argmax_probe.cu P3): C in tiles, k in
# splits, one block a tile and split.  The tilings and the order of sums are
# held here; the launch passes the tiling and the kernels refuse one that is
# not their own, and tests/test_torch_gemm_plan.py models the order from
# these and holds the constants that are not passed to the source.


@dataclass(frozen=True)
class GemmTiling:
    """A product kernel's tiling: tiles of C of tile_m x tile_n, and the
    block's `groups` (the mma kernel's warps, the FMA kernel's k-groups),
    each taking stage_k / groups k of every stage of stage_k; a group sums
    its share in order, then the block adds the groups in order."""

    tile_m: int
    tile_n: int
    groups: int
    stage_k: int


GEMM_MMA = GemmTiling(8, 16, 8, 256)        # bf16 passes; a warp takes 2 mma steps a stage
GEMM_FMA = GemmTiling(8, 16, 4, 64)         # float32; a group takes one chunk a stage
GEMM_FMA_WIDE = GemmTiling(16, 64, 8, 128)  # float32 where the small tiles fill the card twice
GEMM_K_STEP = 16        # k of an mma step and of a chunk of FMAs; a split's k is a multiple
GEMM_MMA_CHUNK = 8      # mma steps a fragment sums before it joins its warp's float32 total
GEMM_ONE_SPLIT_K = 512  # k up to this takes one split: no workspace, no reduction
GEMM_MIN_SPLIT_K = 64   # the least k a split takes
GEMM_SMS = 132          # the H100's SMs: the blocks a plan aims to reach


@dataclass(frozen=True)
class GemmPlan:
    """One launch of a product kernel: `tiles` tiles of C and `splits`
    ranges of k_split k (the last takes the rest), a block each; with more
    than one split, each block writes its tile to a workspace and the last
    of a tile's blocks adds them in split order."""

    tiling: GemmTiling
    tiles: int
    splits: int
    k_split: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def ws_floats(self) -> int:
        t = self.tiling
        return self.blocks * t.tile_m * t.tile_n if self.splits > 1 else 0

    def k_ranges(self, k: int) -> list:
        return [(s * self.k_split, min(k, (s + 1) * self.k_split)) for s in range(self.splits)]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, passes: int, sms: int = GEMM_SMS) -> GemmPlan:
    """The plan of `gemm` for C (m x n) = A (m x k) B: bf16 passes take the
    mma kernel; float32 takes the FMA kernel, wide where its small tiles
    would fill the card twice over.  Fewer tiles than SMs and k past
    GEMM_ONE_SPLIT_K: k splits into up to 2 sms blocks, two an SM (the
    kernels fit two, and `sms` would leave a tile count that does not divide
    it with some SMs running two blocks and most one)."""
    if passes:
        tiling = GEMM_MMA
    else:
        small = _ceil_div(m, GEMM_FMA.tile_m) * _ceil_div(n, GEMM_FMA.tile_n)
        tiling = GEMM_FMA_WIDE if small >= 2 * sms else GEMM_FMA
    tiles = _ceil_div(m, tiling.tile_m) * _ceil_div(n, tiling.tile_n)
    splits, k_split = 1, _ceil_div(k, GEMM_K_STEP) * GEMM_K_STEP
    if tiles < sms and k > GEMM_ONE_SPLIT_K:
        want = 2 * sms // tiles  # two blocks an SM, as many on every SM
        k_split = max(GEMM_MIN_SPLIT_K, _ceil_div(_ceil_div(k, want), GEMM_K_STEP) * GEMM_K_STEP)
        splits = _ceil_div(k, k_split)
    return GemmPlan(tiling, tiles, splits, k_split)


_GEMM_SCRATCH: dict = {}


def _gemm_scratch(dev: torch.device, stream: int, plan: GemmPlan):
    """(workspace, tickets) for `plan` on `stream`: made once per device and
    stream (torch.empty, torch.zeros) and grown as needed; the kernel leaves
    every ticket at zero, and the launches of one stream run in order."""
    ws, tickets = _GEMM_SCRATCH.get((dev, stream), (None, None))
    if ws is None or ws.numel() < plan.ws_floats:
        ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < plan.tiles:
        tickets = torch.zeros(plan.tiles, dtype=torch.int32, device=dev)
    _GEMM_SCRATCH[(dev, stream)] = ws, tickets
    return ws, tickets


def gemm_c_args(a: torch.Tensor, b: torch.Tensor, passes: int = 0,
                b_lo: Optional[torch.Tensor] = None, transpose_b: bool = False,
                rows: Optional[int] = None) -> tuple:
    """(C, the arguments of pvot_probe_gemm before the stream) for `gemm` on
    the card: its plan, the output C it writes, and the workspace of the
    current stream.  The arguments point into the operands and C: keep them
    alive while the arguments are used."""
    m, k, n = gemm_shape(a, b, passes, b_lo, transpose_b, rows)
    dev = a.device
    plan = gemm_plan(m, n, k, passes, torch.cuda.get_device_properties(dev).multi_processor_count)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    kind = 2 if b_lo is not None else 1 if transpose_b else 0
    ws, tickets = None, None
    if plan.splits > 1:
        ws, tickets = _gemm_scratch(dev, torch.cuda.current_stream(dev).cuda_stream, plan)
    t = plan.tiling
    return c, (a.data_ptr(), a.shape[1], b.data_ptr(), _ptr(b_lo), kind, b.shape[1],
               c.data_ptr(), m, n, k, passes, t.tile_m, t.tile_n, t.groups, t.stage_k,
               plan.splits, plan.k_split, _ptr(ws), 0 if ws is None else ws.numel(),
               _ptr(tickets), 0 if tickets is None else tickets.numel())


def gemm(a: torch.Tensor, b: torch.Tensor, passes: int = 0, b_lo: Optional[torch.Tensor] = None,
         transpose_b: bool = False, rows: Optional[int] = None) -> torch.Tensor:
    """C = A B, (m, n) float32: passes 0 float32 FMAs (HIGHEST), 1 one bf16
    pass, 3 three (hi hi + hi lo + lo hi), bf16 on the tensor cores.

    a (m, k) float32, or with `rows` the m = rows overlapping rows A[i, kk] =
    a.flat[i * a.shape[1] + kk] (the concatenated row bands of T5's
    scratch_copy_dot); b (k, n) float32, (n, k) with transpose_b, or the
    bf16 hi plane with b_lo the lo plane (3 passes).  On the card one
    launch (`gemm_plan`), into a workspace kept per device and stream."""
    if a.device.type == "cpu":
        return gemm_reference(a, b, passes, b_lo, transpose_b, rows)
    c, args = gemm_c_args(a, b, passes, b_lo, transpose_b, rows)
    _launch(gemm, "pvot_probe_gemm", a.device, *args)
    return c


# ---- P4: windows -------------------------------------------------------------


def _window_args(x, off, blocks, rows, cols, band):
    _need(x, "x", (torch.float32, torch.uint8), (2, 3))
    if off is not None:
        _need(off, "off", torch.int32, 1, x.device)
        if off.numel() != 2:
            raise ValueError("off holds (row, column) offsets")
    if min(blocks, rows, cols, band or 1) < 1 or (x.ndim == 3 and blocks > x.shape[0]):
        raise ValueError(f"{blocks} blocks of {rows} x {cols} from {tuple(x.shape)}")
    return band or cols


def window_reference(x, off=None, units=(1, 1), blocks: int = 1, block_step: int = 0,
                     terms: int = 1, term_step: int = 0, rows: int = 8, cols: int = TX,
                     band: Optional[int] = None) -> torch.Tensor:
    """Plain version of `window`: the same sums in the same order, the
    offsets read as tensors (no host read)."""
    band = _window_args(x, off, blocks, rows, cols, band)
    frames = x if x.ndim == 3 else x[None]
    h, w = frames.shape[1:]
    dev = x.device
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    b, r, c = ar(blocks)[:, None, None], ar(rows)[None, :, None], ar(cols)[None, None, :]
    oy, ox = ((off.to(torch.int64)[0] * units[0], off.to(torch.int64)[1] * units[1])
              if off is not None else (0, 0))
    y_base = oy + b * block_step + r + c // band
    xs = (ox + c % band).expand(blocks, rows, cols)
    fi = (b if x.ndim == 3 else torch.zeros_like(b)).expand(blocks, rows, cols)
    acc = torch.zeros((blocks, rows, cols), dtype=torch.float32, device=dev)
    for t in range(terms):
        y = (y_base + t * term_step).expand(blocks, rows, cols)
        inside = (y >= 0) & (y < h) & (xs >= 0) & (xs < w)
        v = frames[fi, y.clamp(0, h - 1), xs.clamp(0, w - 1)]
        v = v.to(torch.float32) * float(U8_SCALE) if x.dtype == torch.uint8 else v
        acc = acc + torch.where(inside, v, 0.0)
    return acc.reshape(blocks * rows, cols)


def window(x: torch.Tensor, off: Optional[torch.Tensor] = None, units=(1, 1), blocks: int = 1,
           block_step: int = 0, terms: int = 1, term_step: int = 0, rows: int = 8,
           cols: int = TX, band: Optional[int] = None) -> torch.Tensor:
    """Sums of row-shifted windows, (blocks * rows, cols) float32:

        out[b, r, c] = sum_{t < terms} X(b, oy + b block_step + t term_step
                                           + r + c // band, ox + c % band)

    added in order from 0; X the pixel of frame b (x 3-D) or of x (2-D) as
    float32 (uint8 times float32(1/255)), 0 outside x; (oy, ox) = (off[0]
    units[0], off[1] units[1]) with `off` two int32 offsets read on the
    device, or (0, 0).  band (default cols) folds the columns into bands of
    rows: T5's concat_lanes."""
    band = _window_args(x, off, blocks, rows, cols, band)
    if x.device.type == "cpu":
        return window_reference(x, off, units, blocks, block_step, terms, term_step, rows, cols,
                                band)
    out = torch.empty((blocks * rows, cols), dtype=torch.float32, device=x.device)
    h, w = x.shape[-2:]
    _launch(window, "pvot_probe_window", x.device, x.data_ptr(), int(x.dtype == torch.uint8),
            h * w if x.ndim == 3 else 0, w, h, w, _ptr(off), units[0], units[1], blocks,
            block_step, terms, term_step, rows, cols, band, out.data_ptr())
    return out


# ---- P5: one block walks the steps ------------------------------------------


def _steps_of(x, steps):
    if steps < 1 or x.numel() % steps:
        raise ValueError(f"{x.numel()} values in {steps} steps")
    return x.numel() // steps


def carry_sum_reference(x: torch.Tensor, steps: int, inc: int = 2) -> torch.Tensor:
    """Plain version of `carry_sum`."""
    tile = _steps_of(x, steps)
    xs, acc, cnt, outs = x.reshape(steps, tile), torch.zeros_like(x.reshape(-1)[:tile]), 0, []
    for t in range(steps):
        acc = acc + xs[t]
        cnt += inc
        outs.append(acc + float(cnt))
    return torch.stack(outs).reshape(x.shape)


def carry_sum(x: torch.Tensor, steps: int, inc: int = 2) -> torch.Tensor:
    """scratch_carry: x split into `steps` tiles (at most 2048 values each);
    step t writes the running sum of tiles 0..t plus float(inc (t + 1)), the
    sum and the counter carried across the steps in one block."""
    _need(x, "x", torch.float32)
    tile = _steps_of(x, steps)
    if tile > 2048:
        raise ValueError(f"tiles of {tile} values: at most 2048")
    if x.device.type == "cpu":
        return carry_sum_reference(x, steps, inc)
    out = torch.empty_like(x)
    _launch(carry_sum, "pvot_probe_carry_sum", x.device, x.data_ptr(), steps, tile, inc,
            out.data_ptr())
    return out


def offset_chain_reference(x: torch.Tensor, steps: int, rows: int, unit: int) -> torch.Tensor:
    """Plain version of `offset_chain`, the chain kept as a tensor."""
    h = x.shape[0]
    units = torch.zeros((), dtype=torch.int64, device=x.device)
    outs = []
    for _ in range(steps):
        row0 = units * unit
        inside = (row0 >= 0) & (row0 + rows <= h)
        idx = (row0 + torch.arange(rows, device=x.device)).clamp(0, h - 1)
        outs.append(torch.where(inside, x[idx], 0.0))
        units = units + torch.where(inside, x[row0.clamp(0, h - 1), 0].to(torch.int64), 0)
    return torch.cat(outs)


def offset_chain(x: torch.Tensor, steps: int, rows: int, unit: int) -> torch.Tensor:
    """dyn_hbm_dma: step t copies rows [o_t, o_t + rows) of x (h, w), o_t =
    unit u_t, u_0 = 0, u_{t+1} = u_t + int(x[o_t, 0]) (truncated): each
    step's offset comes from the data the step before fetched, on the
    device.  A window past x writes zeros and leaves the chain where it is.
    (steps * rows, w) float32."""
    _need(x, "x", torch.float32, 2)
    if steps < 1 or rows < 1:
        raise ValueError(f"{steps} steps of {rows} rows")
    if x.device.type == "cpu":
        return offset_chain_reference(x, steps, rows, unit)
    out = torch.empty((steps * rows, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch(offset_chain, "pvot_probe_offset_chain", x.device, x.data_ptr(), x.shape[0],
            x.shape[1], steps, rows, unit, out.data_ptr())
    return out


def _square_pair(a, b):
    _need(a, "a", torch.float32, 2)
    _need(b, "b", torch.float32, 2, a.device)
    if a.shape[0] != a.shape[1] or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)}: one square shape")
    return a.shape[0]


def gated_gemm_reference(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of `gated_gemm`: the product in float64, rounded once."""
    n = _square_pair(a, b)
    ab = (a.double() @ b.double()).to(torch.float32)
    flag, outs = 1, []
    for _ in range(steps):
        outs.append(ab if flag == 1 else torch.zeros_like(ab))
        flag = 1 - flag
    return torch.cat(outs).reshape(steps * n, n)


def gated_gemm(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """when_heavy: step t writes the float32 product a b (n, n) when a flag
    carried across the steps is 1, zeros otherwise; the flag starts at 1 and
    flips every step.  (steps * n, n) float32."""
    n = _square_pair(a, b)
    if steps < 1:
        raise ValueError(f"{steps} steps")
    if a.device.type == "cpu":
        return gated_gemm_reference(a, b, steps)
    out = torch.empty((steps * n, n), dtype=torch.float32, device=a.device)
    _launch(gated_gemm, "pvot_probe_gated_gemm", a.device, a.data_ptr(), b.data_ptr(), n, steps,
            out.data_ptr())
    return out


def _copy_args(x, y0, x0, rows, cols):
    _need(x, "x", torch.float32, 3)
    if y0 < 0 or x0 < 0 or y0 + rows > x.shape[1] or x0 + cols > x.shape[2]:
        raise ValueError(f"window ({y0}, {x0}) {rows} x {cols} past {tuple(x.shape)}")
    return x.shape[0]


def gated_copy_reference(x: torch.Tensor, y0: int, x0: int, rows: int, cols: int) -> torch.Tensor:
    """Plain version of `gated_copy`."""
    steps = _copy_args(x, y0, x0, rows, cols)
    flag, outs = 1, []
    for t in range(steps):
        win = x[t, y0 : y0 + rows, x0 : x0 + cols]
        outs.append(win if flag == 1 else torch.zeros_like(win))
        flag = 1 - flag
    return torch.cat(outs)


def gated_copy(x: torch.Tensor, y0: int, x0: int, rows: int, cols: int) -> torch.Tensor:
    """when_dma: for frame t of x (steps, h, w), its window at (y0, x0), rows
    x cols, when a flag carried across the steps is 1, zeros (and no read)
    otherwise; the flag starts at 1.  (steps * rows, cols) float32."""
    steps = _copy_args(x, y0, x0, rows, cols)
    if x.device.type == "cpu":
        return gated_copy_reference(x, y0, x0, rows, cols)
    out = torch.empty((steps * rows, cols), dtype=torch.float32, device=x.device)
    _launch(gated_copy, "pvot_probe_gated_copy", x.device, x.data_ptr(), x.shape[1], x.shape[2],
            y0, x0, rows, cols, steps, out.data_ptr())
    return out


# ---- P6: roll ----------------------------------------------------------------


def _roll_args(x, shifts, out_rows):
    _need(x, "x", torch.float32, 2)
    _need(shifts, "shifts", torch.int32, 1, x.device)
    if shifts.numel() != 2 or (out_rows is not None and out_rows < 1):
        raise ValueError("shifts holds (rows, columns); out_rows >= 1")
    return x.shape[0] if out_rows is None else out_rows


def roll_reference(x: torch.Tensor, shifts: torch.Tensor, stride: int = 0,
                   out_rows: Optional[int] = None) -> torch.Tensor:
    """Plain version of `roll`."""
    out_h = _roll_args(x, shifts, out_rows)
    h, w = x.shape
    s = shifts.to(torch.int64)
    r = torch.arange(out_h, device=x.device)[:, None]
    c = torch.arange(w, device=x.device)[None, :]
    src_r = torch.zeros_like(r) if out_rows is not None else torch.remainder(r - s[0], h)
    return x[src_r, torch.remainder(c - s[1] - stride * r, w)]


def roll(x: torch.Tensor, shifts: torch.Tensor, stride: int = 0,
         out_rows: Optional[int] = None) -> torch.Tensor:
    """np.roll of x (h, w) by shifts = (sy, sx), two int32 read on the
    device: out[r, c] = x[(r - sy) mod h, (c - sx - stride r) mod w].  With
    out_rows, row 0 broadcast to out_rows rows is rolled instead
    (roll_strided's shear)."""
    out_h = _roll_args(x, shifts, out_rows)
    if x.device.type == "cpu":
        return roll_reference(x, shifts, stride, out_rows)
    out = torch.empty((out_h, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch(roll, "pvot_probe_roll", x.device, x.data_ptr(), x.shape[0], x.shape[1],
            shifts.data_ptr(), stride, out_h, int(out_rows is not None), out.data_ptr())
    return out


# ---- P7: shear correlation ---------------------------------------------------


def _shear_args(w, t, ty, tx):
    _need(w, "w", torch.float32, 2)
    _need(t, "t", torch.float32, 2, w.device)
    (p, m), length = t.shape, w.shape[1]
    if length > m or tx > m or w.shape[0] < ty + p - 1 or min(ty, tx) < 1:
        raise ValueError(f"w {tuple(w.shape)}, t {tuple(t.shape)}, output {ty} x {tx}")


def shear_corr_reference(w: torch.Tensor, t: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """Plain version of `shear_corr`: float64, rounded once."""
    _shear_args(w, t, ty, tx)
    length, (p_rows, m) = w.shape[1], t.shape
    idx = torch.remainder(torch.arange(length, device=w.device)[None, :]
                          - torch.arange(tx, device=w.device)[:, None], m)
    acc = torch.zeros((ty, tx), dtype=torch.float64, device=w.device)
    for p in range(p_rows):
        acc = acc + w[p : p + ty].double() @ t[p][idx].double().t()
    return acc.to(torch.float32)


def shear_corr(w: torch.Tensor, t: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """shear_dot's correlation, (ty, tx) float32: acc[y, dx] = sum_p sum_{l <
    L} w[y + p, l] t[p, (l - dx) mod M] for w (>= ty + P - 1, L), t (P, M):
    the transposed Toeplitz block of each template row, consumed as it is
    built."""
    _shear_args(w, t, ty, tx)
    if w.device.type == "cpu":
        return shear_corr_reference(w, t, ty, tx)
    out = torch.empty((ty, tx), dtype=torch.float32, device=w.device)
    _launch(shear_corr, "pvot_probe_shear", w.device, w.data_ptr(), w.shape[0], w.shape[1],
            t.data_ptr(), t.shape[1], t.shape[0], ty, tx, out.data_ptr())
    return out


WRAPPERS = (tile_reduce, elementwise, gemm, window, carry_sum, offset_chain, gated_gemm,
            gated_copy, roll, shear_corr)
for _w in WRAPPERS:
    _w.launches = 0
    # the names of the CUDA kernels the wrapper launches (csrc/argmax_probe.cu)
    _w.cuda_kernels = (f"{_w.__name__}_kernel",)
elementwise.cuda_kernels = ("ew_kernel",)
gemm.cuda_kernels = ("gemm_fma_kernel", "gemm_mma_kernel")
shear_corr.cuda_kernels = ("shear_corr_kernel",)


def reset_launches(*wrappers) -> None:
    """Zero the launch counters of `wrappers` (default: this module's)."""
    for w in wrappers or WRAPPERS:
        w.launches = 0


# ---- the probes --------------------------------------------------------------


@dataclass
class Case:
    """One probe: the pallas_call's operands (numpy, in the JAX call's order;
    a bf16 plane as float32 values), the kernel's call and the plain
    version's on their tensors, the JAX probe's own assertion, and what the
    bound and the library yardstick need."""

    kernel: Callable               # the wrapper whose `launches` the call counts
    operands: tuple                # numpy arrays
    call: Callable                 # (*tensors) -> output tensor or tuple
    plain: Callable                # (*tensors) -> the same, by the plain version
    check: Callable                # (outputs as numpy arrays) -> the probe's error; raises
    tol: float = 0.0               # kernel against plain: 0 exactly, else relative to max |plain|
    absolute: bool = False         # tol is absolute
    library: Optional[Callable] = None  # (*tensors) -> one PyTorch call computing the same
    library_args: Optional[Callable] = None  # (*tensors) -> the library call's operands
    flops: float = 0.0             # operations; with passes, the bf16 product's 2 m n k
    passes: int = 0                # 0: float32 operations; else bf16 passes
    read_bytes: Optional[float] = None  # bytes the function reads (default: every operand)
    dtypes: tuple = ()             # torch dtype an operand takes (default: its numpy dtype)
    compare: Optional[Callable] = None  # (got, ref) -> largest difference; raises
    launches: int = 1              # kernel launches a call
    cuda_kernels: tuple = ()       # their names (default: the wrapper's `cuda_kernels`)
    product: Optional[Callable] = None  # (*tensors) -> gemm's arguments, for a product probe

    def args(self, device) -> tuple:
        dtypes = self.dtypes or (None,) * len(self.operands)
        return tuple(torch.from_numpy(np.ascontiguousarray(o)).to(device=device, dtype=d)
                     for o, d in zip(self.operands, dtypes))


def gemm_case(operands: tuple, product: Callable, check: Callable, **kw) -> Case:
    """A probe of `gemm`: `product` maps its tensors to gemm's arguments
    (a, b, passes, b_lo, transpose_b, rows); the kernel and the plain version
    are gemm and gemm_reference on them."""
    return Case(gemm, operands, lambda *t: gemm(*product(*t)),
                lambda *t: gemm_reference(*product(*t)), check, product=product, **kw)


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _numpy(outs) -> tuple:
    return tuple(o.detach().cpu().numpy() for o in _tuple(outs))


def compare_outputs(case: Case, got, ref) -> float:
    """Largest |kernel - plain| over the outputs; raises AssertionError past
    the case's tolerance (exact equality at 0)."""
    if case.compare is not None:
        return case.compare(got, ref)
    worst = 0.0
    for g, r in zip(_numpy(got), _numpy(ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"kernel {g.dtype}{g.shape} vs plain {r.dtype}{r.shape}")
        d = float(np.max(np.abs(g.astype(np.float64) - r.astype(np.float64)), initial=0.0))
        limit = case.tol if case.absolute else case.tol * float(np.max(np.abs(r), initial=0.0))
        if (case.tol == 0 and not np.array_equal(g, r)) or d > limit:
            raise AssertionError(f"kernel and plain version differ by {d:.3g} (limit {limit:.3g})")
        worst = max(worst, d)
    return worst


def run_case(name: str, case: Case, device) -> dict:
    """The probe on `device`: on the card the kernel, held to the JAX probe's
    assertion and to the plain version; on the CPU the plain version, held
    to the assertion.  Returns {"probe", "err" (the probe's own measure),
    "max_abs_err" (kernel against plain; 0.0 on the CPU)}; raises."""
    args = case.args(device)
    if torch.device(device).type == "cpu":
        return {"probe": name, "err": case.check(_numpy(case.plain(*args))), "max_abs_err": 0.0}
    got = case.call(*args)
    torch.cuda.synchronize()
    err = case.check(_numpy(got))
    return {"probe": name, "err": err, "max_abs_err": compare_outputs(case, got, case.plain(*args))}


def device_us(fn, repeats: int = 200) -> float:
    """Microseconds a call between CUDA events around `repeats` calls, after
    one warm call: the host's time a call where it exceeds the card's."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / repeats


def profiled_us(fn, kernels: tuple, per_call: int, calls: int = 20) -> Optional[float]:
    """Device microseconds a call of fn's kernels (those whose name holds one
    of `kernels`, `per_call` launches a call): the mean duration of the
    launches that torch.profiler recorded with a duration over `calls` calls,
    after a warm call and a warm profiler run, times per_call.  Records the
    profiler drops or leaves without a duration do not move the mean (in a
    process that profiled before, its per-name averages have come out at
    half a kernel's time); None when it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first run starts the profiler's tracing
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA") and any(k in e.name for k in kernels)]
    us = [u for u in us if u > 0]
    return sum(us) / len(us) * per_call if us else None


def case_bound(case: Case, outputs) -> tuple:
    """(least milliseconds the card could take, "operations" or "bytes"):
    the operations at the FP32 peak (at the bf16 peak times passes for a
    bf16 product) against the bytes read and written once at the memory
    rate."""
    from pvot_torch.bench import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S

    read = case.read_bytes
    if read is None:  # each operand at the dtype the call takes it in
        dtypes = case.dtypes or (None,) * len(case.operands)
        read = sum(o.size * (o.itemsize if d is None else torch.empty(0, dtype=d).element_size())
                   for o, d in zip(case.operands, dtypes))
    n_bytes = read + sum(o.numel() * o.element_size() for o in _tuple(outputs))
    t_ops = case.flops * case.passes / BF16_FLOPS if case.passes else case.flops / FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _allclose(got, want, rtol: float) -> float:
    """np.testing.assert_allclose(got, want, rtol) (atol 0); returns the
    largest relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol)
    nz = want != 0
    return float(np.max(np.abs(got[nz] / want[nz] - 1.0), initial=0.0))


def _at_most(err: float, bound: float, what: str, strict: bool = True) -> float:
    if not (err < bound if strict else err <= bound):
        raise AssertionError(f"{what}: {err:.3e} against {bound:g}")
    return err


def _max_abs(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _prod(a, b) -> np.ndarray:
    """The exact product of two float32 matrices, rounded to float32."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _const(values, dtype):
    """A function of a device giving `values` as a tensor there, made once a
    device (so a timed call copies nothing from the host)."""
    made = {}

    def on(device) -> torch.Tensor:
        if device not in made:
            made[device] = torch.tensor(values, dtype=dtype, device=device)
        return made[device]

    return on


_U8_SCALE_T = _const(U8_SCALE, torch.float32)


def case_reduce_max() -> Case:
    x = np.random.default_rng(0).random((128, 128), np.float32)
    return Case(tile_reduce, (x,), lambda x: tile_reduce(x, "max"),
                lambda x: tile_reduce_reference(x, "max"),
                lambda out: _allclose(out[0][0, 0], x.max(), 1e-6),
                library=lambda x: torch.max(x), flops=x.size)


def case_argmax_tiebreak() -> Case:
    x = np.random.default_rng(1).random((128, 128)).astype(np.float32)
    x[3, 7] = 2.0  # a tie: two positions share the max
    x[90, 2] = 2.0

    def check(out):
        got = int(out[0][0, 0])
        if got != 3 * TX + 7:
            raise AssertionError(f"tie-break wrong: {got} != {3 * TX + 7}")
        return 0.0

    return Case(tile_reduce, (x,), lambda x: tile_reduce(x, "argmax"),
                lambda x: tile_reduce_reference(x, "argmax"), check,
                library=lambda x: torch.argmax(x), flops=2 * x.size)


def case_two_outputs() -> Case:
    x = np.random.default_rng(2).random((128, 128), np.float32)

    def check(out):
        if int(out[1][0, 0]) != 42:
            raise AssertionError(f"second output {out[1][0, 0]}")
        return _allclose(out[0][0, 0], x.max(), 1e-6)

    return Case(tile_reduce, (x,), lambda x: tile_reduce(x, "max", fill=42),
                lambda x: tile_reduce_reference(x, "max", fill=42), check,
                library=lambda x: torch.max(x), flops=x.size)


def case_smem_i32_in() -> Case:
    b = np.asarray([[7, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    x = np.ones((8, TX), np.float32)
    return Case(elementwise, (b, x), lambda b, x: elementwise("add_i32", x, b),
                lambda b, x: elementwise_reference("add_i32", x, b),
                lambda out: _allclose(out[0], np.full((8, TX), 8.0), 1e-7),
                library=lambda b, x: torch.add(x, b[0, 0]), flops=x.size)


def _fused_case(span: int, templ_px: int, seed: int) -> Case:
    """tools/fused_argmax_probe.py `_fused_case` (:187): K5 over one region
    and template at three windows (whole, clamped, one point)."""
    from pvot_torch.ops.ncc_pallas import ncc_map_lanes_reference, ncc_region_argmax_pallas
    from pvot_torch.ops.ncc_reference import template_stats
    from pvot_torch.ops.search import WindowBounds, masked_region_best

    rng = np.random.default_rng(seed)
    th = tw = templ_px
    region = rng.random((span + th - 1, span + tw - 1), np.float32)
    templ = rng.random((th, tw), np.float32)
    x0 = int(rng.integers(0, 500))
    y0 = int(rng.integers(0, 300))
    windows = [(0, span - 1, 0, span - 1), (5, span - 7, 11, span - 3),
               (span // 2, span // 2, span // 2, span // 2)]
    bounds = [WindowBounds(x0 + ax0, x0 + ax1, y0 + ay0, y0 + ay1)
              for ax0, ax1, ay0, ay1 in windows]

    def call(region, templ):
        return torch.stack([torch.stack([v, x.to(torch.float32), y.to(torch.float32)])
                            for v, x, y in (ncc_region_argmax_pallas(region, templ, b, x0, y0)
                                            for b in bounds)])

    def plain(region, templ):
        # The plain K5 on each window, the region scored once for all three.
        t_mean, t_std = template_stats(templ)
        scores = ncc_map_lanes_reference(region, templ, t_mean, t_std, out_shape=(span, span))[0]
        return torch.stack([masked_region_best(scores, x0, y0, b) for b in bounds])

    def check(out):
        return _oracle_check(out[0], [(region, templ, b, x0, y0) for b in bounds])

    flops, read = _k5_work([(ax1 - ax0 + 1, ay1 - ay0 + 1) for ax0, ax1, ay0, ay1 in windows],
                           th, tw)
    return Case(ncc_region_argmax_pallas, (region, templ), call, plain, check,
                compare=_compare_best, launches=len(bounds), cuda_kernels=K5_KERNEL,
                flops=flops, read_bytes=read)


def _k5_work(windows, th: int, tw: int) -> tuple:
    """(operations, bytes read) of K5 over windows of (columns, rows)
    positions: 2 th tw operations a position, and the float32 region
    pixels and template that the window's positions read."""
    flops = sum(2.0 * wx * wy * th * tw for wx, wy in windows)
    read = sum(4.0 * ((wx + tw - 1) * (wy + th - 1) + th * tw) for wx, wy in windows)
    return flops, read


def _oracle_check(rows: np.ndarray, lanes) -> float:
    """Each (value, x, y) row against the probes' oracle, the port's matmul
    engine and masked argmax (tools/fused_argmax_probe.py:176): value within
    2e-5, (x, y) exactly.  Returns the largest value difference."""
    from pvot_torch.ops.ncc_matmul import ncc_map_matmul
    from pvot_torch.ops.search import masked_region_best

    worst = 0.0
    for row, (region, templ, bounds, x0, y0) in zip(rows, lanes):
        scores = ncc_map_matmul(torch.from_numpy(region), torch.from_numpy(templ))
        want = masked_region_best(scores, x0, y0, bounds).numpy()
        d = abs(float(row[0]) - float(want[0]))
        if not (d < K5_VALUE_TOL and row[1] == want[1] and row[2] == want[2]):
            raise AssertionError(f"(val, x, y) {row.tolist()} vs {want.tolist()} window {bounds}")
        worst = max(worst, d)
    return worst


def _compare_best(got, ref) -> float:
    """(value, x, y) rows of K5 against its plain version: (x, y) exactly,
    the value within K5_PLAIN_TOL."""
    g, r = _numpy(got)[0], _numpy(ref)[0]
    d = float(np.max(np.abs(g[:, 0] - r[:, 0])))
    if not (np.array_equal(g[:, 1:], r[:, 1:]) and d <= K5_PLAIN_TOL):
        raise AssertionError(f"K5 {g.tolist()} vs plain {r.tolist()}")
    return d


def case_fused_region() -> Case:
    return _fused_case(121, 80, 10)


def case_fused_multitile() -> Case:
    return _fused_case(321, 80, 11)


def case_vmap_fused() -> Case:
    """tools/fused_argmax_probe.py `probe_vmap_fused` (:229): S = 4 lanes,
    each with its own region, template and window, in one K5 launch."""
    from pvot_torch.ops.ncc_pallas import (
        ncc_region_argmax_pallas, region_argmax_lanes, region_argmax_lanes_reference,
    )
    from pvot_torch.ops.ncc_reference import template_stats
    from pvot_torch.ops.search import WindowBounds

    rng = np.random.default_rng(12)
    span, t, s = 121, 80, 4
    regions = rng.random((s, span + t - 1, span + t - 1), np.float32)
    templs = rng.random((s, t, t), np.float32)
    x0, y0 = np.arange(s) * 3, np.arange(s) * 5
    lanes = [(0, 0, 1, span - 2, 2, span - 4)] * s  # the window in region coordinates
    shift = _const(np.stack([np.zeros(s), x0, y0], axis=1), torch.float32)

    def lanes_of(fn):
        def run(regions, templs):
            out = fn(regions, templs, *template_stats(templs), lanes, (span, span))
            return out + shift(out.device)
        return run

    bounds = [WindowBounds(int(x0[i]) + 1, int(x0[i]) + span - 2, int(y0[i]) + 2,
                           int(y0[i]) + span - 4) for i in range(s)]
    flops, read = _k5_work([(rx1 - rx0 + 1, ry1 - ry0 + 1) for _, _, rx0, rx1, ry0, ry1 in lanes],
                           t, t)
    return Case(ncc_region_argmax_pallas, (regions, templs),
                lanes_of(region_argmax_lanes), lanes_of(region_argmax_lanes_reference),
                lambda out: _oracle_check(out[0], [(regions[i], templs[i], bounds[i], int(x0[i]),
                                                    int(y0[i])) for i in range(s)]),
                compare=_compare_best, cuda_kernels=K5_KERNEL, flops=flops, read_bytes=read)


def case_dot_high_emul() -> Case:
    rng = np.random.default_rng(3)
    a = rng.random((128, 256), np.float32)
    b = rng.random((256, 128), np.float32)
    bh, bl = (v.numpy() for v in split_bf16(torch.from_numpy(b)))

    def check(out):
        want = a.astype(np.float64) @ b.astype(np.float64)
        return _at_most(_max_abs(out[0], want) / float(np.max(np.abs(want))), 1e-4, "rel")

    return gemm_case((a, bh, bl), lambda a, bh, bl: (a, bh, 3, bl), check, tol=1e-5,
                     dtypes=(torch.float32, torch.bfloat16, torch.bfloat16),
                     library=lambda a, b: torch.matmul(a, b),
                     library_args=lambda a, bh, bl: (a, (bh.float() + bl.float()).contiguous()),
                     flops=2.0 * 128 * 256 * 128, passes=3)


def case_dot_rhs_lane() -> Case:
    rng = np.random.default_rng(4)
    a = rng.random((136, 256), np.float32)
    b = rng.random((1024, 256), np.float32)
    return gemm_case((a, b), lambda a, b: (a, b, 0, None, True),
                     lambda out: _at_most(_max_abs(out[0], _prod(a, b.T)), 1e-4, "err"),
                     tol=1e-6, library=lambda a, b: torch.matmul(a, b.t()),
                     flops=2.0 * 136 * 1024 * 256)


# The product kernels' edge shapes (no JAX probe of their own): k not a
# multiple of the split or of 16, m = 136, n not a multiple of 8 or 32, rows
# whose start is not 16-byte aligned (lda or n not a multiple of 4, planes
# of n not a multiple of 8: the kernels' element-by-element path), the
# overlapping row bands of lda < k, B as (n, k) and as bf16 planes.  Each
# is (m, k, n, passes, B's form, lda of the band rows or None).
GEMM_EDGES = {
    "k_ragged_f32": (8, 3001, 128, 0, "kn", None),
    "k_ragged_1pass": (8, 3001, 128, 1, "kn", None),
    "k_ragged_3pass": (8, 3001, 120, 3, "kn", None),
    "n_odd_f32": (8, 2048, 99, 0, "kn", None),
    "n_odd_3pass": (8, 2048, 99, 3, "kn", None),
    "m136_nk": (136, 256, 1001, 0, "nk", None),
    "m136_kn_odd": (136, 300, 1001, 0, "kn", None),
    "m136_3pass": (136, 520, 40, 3, "kn", None),
    "band_f32": (24, 800, 128, 0, "kn", 100),
    "band_unaligned": (16, 700, 72, 0, "kn", 99),
    "band_1pass": (16, 900, 64, 1, "kn", 102),
    "planes": (24, 520, 72, 3, "planes", None),
    "planes_odd": (13, 264, 70, 3, "planes", None),
}
# The edge shapes' own check against the exact product, relative to its
# largest value: a bf16 pass keeps 8 bits (T5 matmul's 3e-3), three keep
# about 16 (dot_high's 1e-4), float32 24 (dot_highest's 1e-5).
GEMM_EDGE_RTOL = {0: 1e-5, 1: 3e-3, 3: 1e-4}


def gemm_edge_operands(name: str) -> tuple:
    """(a, b) or (a, b_hi, b_lo) of an edge shape as numpy (uniform in [0,
    1), as the probes' operands; a's rows `lda` apart for band rows; b (n,
    k) for "nk"; the planes as float32 values of bf16)."""
    m, k, n, passes, form, lda = GEMM_EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if lda is None:
        a = rng.random((m, k), np.float32)
    else:
        a = rng.random((_ceil_div((m - 1) * lda + k, lda), lda), np.float32)
    b = rng.random((k, n), np.float32)
    if form == "nk":
        return a, np.ascontiguousarray(b.T)
    if form == "planes":
        return (a, *(v.numpy() for v in split_bf16(torch.from_numpy(b))))
    return a, b


def case_gemm_edge(name: str) -> Case:
    """An edge shape of the product kernels as a probe: held to the exact
    product within GEMM_EDGE_RTOL, and to the plain version within 1e-6
    (float32) or 1e-5 (bf16 passes) of its largest value."""
    m, k, n, passes, form, lda = GEMM_EDGES[name]
    ops = gemm_edge_operands(name)
    rows = None if lda is None else m
    if form == "planes":
        product = lambda a, bh, bl: (a, bh, passes, bl, False, rows)  # noqa: E731
        dtypes = (torch.float32, torch.bfloat16, torch.bfloat16)
        want_b = ops[1].astype(np.float64) + ops[2].astype(np.float64)
    else:
        product = lambda a, b: (a, b, passes, None, form == "nk", rows)  # noqa: E731
        dtypes = ()
        want_b = (ops[1].T if form == "nk" else ops[1]).astype(np.float64)
    A = np.lib.stride_tricks.as_strided(ops[0].reshape(-1), (m, k), (4 * ops[0].shape[1], 4))
    want = A.astype(np.float64) @ want_b

    def check(out):
        return _at_most(_max_abs(out[0], want) / float(np.max(np.abs(want))),
                        GEMM_EDGE_RTOL[passes], "rel")

    return gemm_case(ops, product, check, tol=1e-5 if passes else 1e-6, dtypes=dtypes,
                     flops=2.0 * m * n * k, passes=passes)


GEMM_EDGE_PROBES = [(name, (lambda name=name: case_gemm_edge(name))) for name in GEMM_EDGES]


def case_scratch_carry() -> Case:
    x = np.random.default_rng(7).random((8 * 8, 128), np.float32)
    want = np.cumsum(x.reshape(8, 8, 128), axis=0) + (
        2.0 * np.arange(1, 9, dtype=np.float32))[:, None, None]
    return Case(carry_sum, (x,), lambda x: carry_sum(x, 8), lambda x: carry_sum_reference(x, 8),
                lambda out: _at_most(_max_abs(out[0].reshape(8, 8, 128), want), 1e-5, "err"),
                flops=x.size + 8)  # an add a value, the counter's add a step


DHD_DELTAS = (16, 32, 64)  # tools/fused_argmax_probe.py:440: row offsets 0 -> 16 -> 48 -> 112
DHD_PLANTED = (2, 4, 8, 999)  # :442: the unit deltas planted at each landing row


def dyn_hbm_dma_offsets() -> list:
    offs = [0]
    for d in DHD_DELTAS:
        offs.append(offs[-1] + d)
    return offs


def case_dyn_hbm_dma() -> Case:
    x = np.random.default_rng(11).random((1024, 256), np.float32)
    offs = dyn_hbm_dma_offsets()
    for o, d in zip(offs, DHD_PLANTED):
        x[o, 0] = float(d)
    want = np.stack([x[o : o + 8] for o in offs])
    return Case(offset_chain, (x,), lambda x: offset_chain(x, 4, 8, 8),
                lambda x: offset_chain_reference(x, 4, 8, 8),
                lambda out: _at_most(_max_abs(out[0].reshape(4, 8, 256), want), 1e-6, "err"),
                read_bytes=4 * 8 * 256 * 4)


def case_when_heavy() -> Case:
    rng = np.random.default_rng(3)
    a = rng.random((128, 128), np.float32)
    b = rng.random((128, 128), np.float32)
    ab = _prod(a, b)
    want = np.stack([ab, np.zeros_like(ab), ab, np.zeros_like(ab)])
    return Case(gated_gemm, (a, b), lambda a, b: gated_gemm(a, b, 4),
                lambda a, b: gated_gemm_reference(a, b, 4),
                lambda out: _at_most(_max_abs(out[0].reshape(4, 128, 128), want), 1e-4, "err"),
                tol=1e-6, flops=2.0 * 128**3)  # one product, written on steps 0 and 2


def _exact(got, want) -> float:
    return _at_most(_max_abs(got, want), 0.0, "err", strict=False)


def _roll_case(x, shifts, want, stride=0, out_rows=None, library=None, operands=None) -> Case:
    sh = _const(shifts, torch.int32)

    def with_shifts(fn):
        def run(*ts):
            return fn(ts[-1], sh(ts[-1].device), stride, out_rows)
        return run

    return Case(roll, operands or (x,), with_shifts(roll), with_shifts(roll_reference),
                lambda out: _exact(out[0], want), library=library)


def case_roll_static() -> Case:
    x = np.random.default_rng(2).random((8, 256), np.float32)
    return _roll_case(x, [0, 5], np.roll(x, 5, axis=1), library=lambda x: torch.roll(x, 5, 1))


def case_roll_strided() -> Case:
    m = 384
    v = np.zeros((8, m), np.float32)
    v[0, :80] = np.random.default_rng(6).random(80, dtype=np.float32)
    return _roll_case(v, [0, 0], np.stack([np.roll(v[0], dx) for dx in range(TX)]), stride=1,
                      out_rows=TX)


ROLL_TRACED_SHIFTS = (61, 213)  # tools/fused_argmax_probe.py:702


def case_roll_traced() -> Case:
    x = np.random.default_rng(21).random((64, 256), np.float32)
    s = np.asarray(ROLL_TRACED_SHIFTS, np.int32)
    case = _roll_case(x, list(ROLL_TRACED_SHIFTS), np.roll(np.roll(x, 61, axis=0), 213, axis=1),
                      library=lambda s, x: torch.roll(x, ROLL_TRACED_SHIFTS, (0, 1)),
                      operands=(s, x))
    # The shifts the kernel reads are the operand itself, on the device.
    case.call = lambda s, x: roll(x, s)
    case.plain = lambda s, x: roll_reference(x, s)
    return case


SHEAR = dict(L=256, ty=128, tw=80)  # tools/fused_argmax_probe.py:589


def case_shear_dot() -> Case:
    length, ty, tw = SHEAR["L"], SHEAR["ty"], SHEAR["tw"]
    rng = np.random.default_rng(9)
    w = rng.random((ty + 8, length), np.float32)
    t = np.zeros((8, length + TX), np.float32)
    t[:, :tw] = rng.random((8, tw), dtype=np.float32)
    want = np.zeros((ty, TX), np.float64)
    for p in range(8):
        for dx in range(TX):
            want[:, dx] += w[p : p + ty, dx : dx + tw].astype(np.float64) @ t[p, :tw]

    def library(w, t):
        return F.conv2d(w[None, None], t[None, None, :, :tw])[0, 0, :ty, :TX]

    return Case(shear_corr, (w, t), lambda w, t: shear_corr(w, t, ty, TX),
                lambda w, t: shear_corr_reference(w, t, ty, TX),
                lambda out: _at_most(_max_abs(out[0], want) / float(np.max(np.abs(want))), 1e-5,
                                     "rel"),
                tol=1e-6, library=library,
                flops=2.0 * ty * TX * int(np.count_nonzero(t)))


def case_u8_convert() -> Case:
    x = np.random.default_rng(12).integers(0, 256, (32, 256), np.uint8)
    return Case(elementwise, (x,), lambda x: elementwise("u8", x),
                lambda x: elementwise_reference("u8", x),
                lambda out: _exact(out[0], x.astype(np.float32) * U8_SCALE),
                library=lambda x: torch.mul(x, _U8_SCALE_T(x.device)),
                flops=2 * x.size)


def _window_bytes(n_values: int, itemsize: int) -> float:
    return n_values * itemsize + 8  # the window and the two offsets


def case_dma_dyn_2d() -> Case:
    x = np.random.default_rng(13).random((512, 1280), np.float32)
    offs = np.asarray([5, 411], np.int32)  # rows 5 * 8 = 40; lanes unaligned
    return Case(window, (x, offs), lambda x, o: window(x, o, (8, 1), rows=16, cols=128),
                lambda x, o: window_reference(x, o, (8, 1), rows=16, cols=128),
                lambda out: _at_most(_max_abs(out[0], x[40:56, 411:539]), 1e-6, "err"),
                library=lambda x, o: x[40:56, 411:539].clone(),
                read_bytes=_window_bytes(16 * 128, 4))


def case_dma_3d_lead() -> Case:
    x = np.random.default_rng(17).random((3, 128, 512), np.float32)
    offs = np.asarray([5, 2], np.int32)  # rows 40, lanes 256
    kw = dict(units=(8, 128), blocks=3, rows=16, cols=128)
    return Case(window, (x, offs), lambda x, o: window(x, o, **kw),
                lambda x, o: window_reference(x, o, **kw),
                lambda out: _at_most(_max_abs(out[0], x[:, 40:56, 256:384].reshape(48, 128)),
                                     1e-6, "err"),
                library=lambda x, o: x[:, 40:56, 256:384].clone(),
                read_bytes=_window_bytes(3 * 16 * 128, 4))


def case_dma_u8_slab() -> Case:
    x = np.random.default_rng(19).integers(0, 256, (2, 256, 640), np.uint8)
    offs = np.asarray([3, 1], np.int32)  # rows 96, lanes 128
    kw = dict(units=(32, 128), blocks=2, rows=64, cols=256)
    want = x[:, 96:160, 128:384].reshape(2 * 64, 256).astype(np.float32) * U8_SCALE
    return Case(window, (x, offs), lambda x, o: window(x, o, **kw),
                lambda x, o: window_reference(x, o, **kw), lambda out: _exact(out[0], want),
                library=lambda x, o: torch.mul(x[:, 96:160, 128:384],
                                               _U8_SCALE_T(x.device)),
                flops=2 * 2 * 64 * 256, read_bytes=_window_bytes(2 * 64 * 256, 1))


SCALAR_ALIGN_IN = (517, 1233)  # tools/fused_argmax_probe.py:914
SCALAR_ALIGN_WANT = (512, 1152, 5, 81)  # :922


def case_scalar_align() -> Case:
    s = np.asarray(SCALAR_ALIGN_IN, np.int32)

    def check(out):
        got = out[0][0, :4]
        if not (got == np.asarray(SCALAR_ALIGN_WANT)).all():
            raise AssertionError(f"scalar-align got {got.tolist()}")
        return 0.0

    return Case(elementwise, (s,), lambda s: elementwise("align", scal=s),
                lambda s: elementwise_reference("align", scal=s), check, flops=6)


def case_when_dma() -> Case:
    x = np.random.default_rng(23).random((4, 64, 384), np.float32)
    want = x[:, 8:24, 128:256].copy()
    want[1] = 0.0
    want[3] = 0.0
    return Case(gated_copy, (x,), lambda x: gated_copy(x, 8, 128, 16, 128),
                lambda x: gated_copy_reference(x, 8, 128, 16, 128),
                lambda out: _at_most(_max_abs(out[0].reshape(4, 16, 128), want), 1e-6, "err"),
                read_bytes=2 * 16 * 128 * 4)


# The JAX tool's PROBES, in its order (tools/fused_argmax_probe.py:979).
PROBES = [
    ("reduce_max", case_reduce_max),
    ("argmax_tiebreak", case_argmax_tiebreak),
    ("two_outputs", case_two_outputs),
    ("smem_i32_in", case_smem_i32_in),
    ("fused_region", case_fused_region),
    ("fused_multitile", case_fused_multitile),
    ("vmap_fused", case_vmap_fused),
    ("dot_high_emul", case_dot_high_emul),
    ("dot_rhs_lane", case_dot_rhs_lane),
    ("scratch_carry", case_scratch_carry),
    ("dyn_hbm_dma", case_dyn_hbm_dma),
    ("when_heavy", case_when_heavy),
    ("roll_static", case_roll_static),
    ("roll_strided", case_roll_strided),
    ("roll_traced", case_roll_traced),
    ("shear_dot", case_shear_dot),
    ("shear_dot_val", case_shear_dot),  # the same function as shear_dot
    ("u8_convert", case_u8_convert),
    ("dma_dyn_2d", case_dma_dyn_2d),
    ("dma_3d_lead", case_dma_3d_lead),
    ("dma_u8_slab", case_dma_u8_slab),
    ("scalar_align", case_scalar_align),
    ("when_dma", case_when_dma),
]
K5_PROBES = ("fused_region", "fused_multitile", "vmap_fused")


def time_case(case: Case, device, repeats: int = 200) -> dict:
    """On the card: the kernel's us a call (CUDA events over `repeats`
    calls of the wrapper, host included), its kernels' device us a call
    (torch.profiler; None if it recorded none), the plain version's and the
    library call's ms, and the bound."""
    args = case.args(device)
    out = case.call(*args)
    bound, by = case_bound(case, out)
    plain_ms = device_us(lambda: case.plain(*args), 3) / 1e3
    library_ms = None
    if case.library is not None:
        largs = case.library_args(*args) if case.library_args else args
        with full_f32(torch.device(device)):
            library_ms = device_us(lambda: case.library(*largs), repeats) / 1e3
    return {"us": device_us(lambda: case.call(*args), repeats),
            "device_us": profiled_us(lambda: case.call(*args),
                                     case.cuda_kernels or case.kernel.cuda_kernels,
                                     case.launches), "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def library_device_us(case: Case, device) -> Optional[float]:
    """The library call's device us a call by the graph route (CUDA events
    around replays of a CUDA graph of its calls, no profiler session); None
    where the probe has none."""
    from pvot_torch.tools.region_step_breakdown import graph_us

    if case.library is None:
        return None
    args = case.args(device)
    largs = case.library_args(*args) if case.library_args else args
    with full_f32(torch.device(device)):
        return graph_us(lambda stream: case.library(*largs))


def run_catalogue(probes: Sequence, argv, prog: str) -> int:
    """The entry point of a catalogue: each probe (or those named) on the
    device, PASS or FAIL a probe, on the card each kernel's device us a
    call; 0 if every probe passed."""
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions, no time)")
    ap.add_argument("names", nargs="*", help="probes to run (default: all)")
    args = ap.parse_args(argv)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (pass --device cpu for the plain versions)", file=sys.stderr)
        return 1
    known = [name for name, _ in probes]
    unknown = [n for n in args.names if n not in known]
    if unknown:
        print(f"{prog}: unknown probes {unknown}; known: {known}", file=sys.stderr)
        return 2
    results, times = {}, {}
    for name, make in probes:
        if args.names and name not in args.names:
            continue
        print(f"--- probe: {name}", flush=True)
        try:
            case = make()
            res = run_case(name, case, device)
            results[name] = True
            print(f"PASS {name}: probe error {res['err']:.3g}, max |kernel - plain| "
                  f"{res['max_abs_err']:.3g}", flush=True)
            if device.type == "cuda":
                t = times[name] = time_case(case, device)
                t["library_device_us"] = library_device_us(case, device)
                dev_us = "not measured" if t["device_us"] is None else f"{t['device_us']:.3f} us"
                lib = ("" if t["library_device_us"] is None else
                       f"; the library call {t['library_device_us']:.3f} us (graph route)")
                print(f"     {t['us']:.3f} us a call, its kernels {dev_us} on the device{lib}",
                      flush=True)
        except Exception as e:  # report every probe, then fail
            results[name] = False
            print(f"FAIL {name}: {type(e).__name__}: {str(e)[:2000]}")
            print("\n".join(traceback.format_exc(limit=10).splitlines()[-10:]), flush=True)
    print({k: ("PASS" if v else "FAIL") for k, v in results.items()})
    if device.type == "cuda":
        print(json.dumps({"times": times, "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0 if all(results.values()) else 1


def main(argv=None) -> int:
    return run_catalogue(PROBES, argv, "fused_argmax_probe")


if __name__ == "__main__":
    sys.exit(main())
