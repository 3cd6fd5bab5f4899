"""Dense optical-flow tracker, the baseline B2: the port of pvot/models/flow.py.

The reference's second standalone baseline (baseline_cuda/cudab.cpp) tracks
a box with OpenCV's CUDA Farneback flow: per frame it computes the
full-frame flow, reads the (fx, fy) vectors inside the box, keeps those with
magnitude in (0.5, 25), and if more than 15 % of the box area survives,
shifts the box by the upper median (dx, dy) (nth_element) truncated toward
zero, clamped to the frame.  The JAX package keeps that box update and
computes the flow as coarse-to-fine Lucas-Kanade over integral-image window
sums and bilinear warps; this module is the same function in torch ops,
work that the JAX package leaves to XLA, so no hand-written kernel.

Parity with JAX: the window sums are the port's `sliding_box_sums` (XLA's
cumsum order), the warp is map_coordinates(order=1, mode="nearest")
written out as its four clipped corners summed in JAX's order (not
F.grid_sample, whose normalised coordinates round differently), the
gradients roll as jnp.roll does, and the box moves by the float32 median
truncated toward zero.  The state (box and previous frame) stays on the
device; the boxes come to the host once a chunk, as JAX reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops.ncc_matmul import sliding_box_sums
from pvot_torch.tracker.state import default_device
from pvot_torch.tracker.step import f32


def _box_mean(img: torch.Tensor, k: int) -> torch.Tensor:
    """Same-size k x k box mean via integral images (edge-padded)."""
    pad = k // 2
    padded = F.pad(img[None, None], (pad, k - 1 - pad, pad, k - 1 - pad), mode="replicate")[0, 0]
    sums, _ = sliding_box_sums(padded, k, k)
    return sums / (k * k)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2 x 2 block means, each block summed by rows, (a00 + a01) + (a10 +
    a11), written out so that the card sums in the CPU's order.  XLA's CPU
    reduce sums so where the output's width is a power of two from 64 on
    (the tests' clips), and row-major in sequence at other widths, which
    can round an ulp apart."""
    h, w = img.shape
    blocks = img[: h // 2 * 2, : w // 2 * 2]
    top = blocks[0::2, 0::2] + blocks[0::2, 1::2]
    return (top + (blocks[1::2, 0::2] + blocks[1::2, 1::2])) / 4


def _upsample2_flow(flow: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(2, h, w) -> (2, H, W), values doubled (flow scales with resolution)."""
    up = flow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0
    return up[:, : shape[0], : shape[1]]


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp: sample img at (y + fy, x + fx), corners
    clipped to the frame (jax.scipy.ndimage.map_coordinates(order=1,
    mode="nearest")): weights (1 - frac, frac) per axis, the four corners
    summed (y0, x0), (y0, x1), (y1, x0), (y1, x1) as XLA's fusion of that
    jitted function sums them: the first product, then each further corner
    as a fused multiply-add.  The fma is taken in float64, where the float32
    product is exact, and rounded to float32 once (a second rounding that
    lands on a float32 midpoint is the one way it can differ)."""
    h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] + flow[1]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] + flow[0]
    nodes = []
    for coord, size in ((ys, h), (xs, w)):
        lower = torch.floor(coord)
        upper_weight = coord - lower
        index = lower.to(torch.int32)
        nodes.append([(index.clamp(0, size - 1), 1 - upper_weight),
                      ((index + 1).clamp(0, size - 1), upper_weight)])
    flat = img.reshape(-1)
    result = None
    for (iy, wy) in nodes[0]:
        for (ix, wx) in nodes[1]:
            weight, value = wy * wx, flat[(iy * w + ix).long()]
            if result is None:
                result = weight * value
            else:
                result = (weight.double() * value.double() + result.double()).float()
    return result


def _lk_refine(prev: torch.Tensor, curr: torch.Tensor, flow: torch.Tensor,
               win: int) -> torch.Tensor:
    """One Lucas-Kanade iteration at this scale."""
    warped = _warp(curr, flow)
    ix = (torch.roll(prev, -1, dims=1) - torch.roll(prev, 1, dims=1)) * 0.5
    iy = (torch.roll(prev, -1, dims=0) - torch.roll(prev, 1, dims=0)) * 0.5
    it = warped - prev
    ixx = _box_mean(ix * ix, win)
    iyy = _box_mean(iy * iy, win)
    ixy = _box_mean(ix * iy, win)
    ixt = _box_mean(ix * it, win)
    iyt = _box_mean(iy * it, win)
    det = ixx * iyy - ixy * ixy
    inv_det = torch.where(torch.abs(det) > f32(1e-9), 1.0 / det, 0.0)
    du = -(iyy * ixt - ixy * iyt) * inv_det
    dv = -(ixx * iyt - ixy * ixt) * inv_det
    # Reject wild updates (ill-conditioned windows).
    du = torch.clamp(du, -win, win)
    dv = torch.clamp(dv, -win, win)
    return flow + torch.stack([du, dv])


def dense_flow(prev: torch.Tensor, curr: torch.Tensor, levels: int = 3, iters: int = 2,
               win: int = 7) -> torch.Tensor:
    """Coarse-to-fine dense LK flow.  prev/curr (H, W) f32 -> (2, H, W) with
    channel 0 = fx, channel 1 = fy (cudab.cpp's split order)."""
    pyr_prev = [prev]
    pyr_curr = [curr]
    for _ in range(levels - 1):
        pyr_prev.append(_downsample2(pyr_prev[-1]))
        pyr_curr.append(_downsample2(pyr_curr[-1]))
    flow = torch.zeros((2, *pyr_prev[-1].shape), dtype=torch.float32, device=prev.device)
    for lvl in range(levels - 1, -1, -1):
        if lvl != levels - 1:
            flow = _upsample2_flow(flow, pyr_prev[lvl].shape)
        for _ in range(iters):
            flow = _lk_refine(pyr_prev[lvl], pyr_curr[lvl], flow, win)
    return flow


def masked_upper_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """C++ nth_element(v.begin() + v.size() / 2) median of the masked values:
    sort with the masked-out entries pushed to +inf, take index count // 2;
    0 when nothing is masked in.  A 0-d tensor on the values' device (no
    host read)."""
    flat = torch.where(mask.reshape(-1), values.reshape(-1), float("inf"))
    srt = torch.sort(flat).values
    count = mask.sum()
    idx = torch.clamp(count // 2, 0, flat.shape[0] - 1)
    return torch.where(count > 0, srt[idx], 0.0)


class FlowState(NamedTuple):
    """The box's top-left corner (0-d int32) and the previous frame (H, W)
    float32, all on the device."""

    bbox_x: torch.Tensor
    bbox_y: torch.Tensor
    prev_gray: torch.Tensor


def make_flow_step(
    frame_shape: Tuple[int, int],
    bbox_size: Tuple[int, int],
    mag_lo: float = 0.5,
    mag_hi: float = 25.0,
    min_valid_frac: float = 0.15,
):
    """Per-frame median-flow box update (cudab.cpp:63-115): step(state,
    frame (H, W) uint8 or float32) -> (state, box (4,) int32), all on the
    frame's device and with no read of the device.  The box's size is fixed
    for the run (the reference never resizes it)."""
    frame_h, frame_w = frame_shape
    bw, bh = bbox_size
    rows_of, cols_of = torch.arange(bh), torch.arange(bw)
    min_count = f32(min_valid_frac * (bw * bh))

    def step(state: FlowState, frame: torch.Tensor):
        frame = ensure_gray_f32(frame)
        dev = frame.device
        flow = dense_flow(state.prev_gray, frame)
        # lax.dynamic_slice: the start clamped so that the box lies inside.
        y0 = torch.clamp(state.bbox_y, 0, frame_h - bh)
        x0 = torch.clamp(state.bbox_x, 0, frame_w - bw)
        rows = (y0 + rows_of.to(dev))[:, None]
        cols = (x0 + cols_of.to(dev))[None, :]
        fx, fy = flow[0][rows, cols], flow[1][rows, cols]
        mag = torch.sqrt(fx * fx + fy * fy)
        mask = (mag > f32(mag_lo)) & (mag < f32(mag_hi))
        dx = masked_upper_median(fx, mask)
        dy = masked_upper_median(fy, mask)
        move = mask.sum() > min_count
        # int(dx): C++ truncation toward zero.
        new_x = state.bbox_x + torch.where(move, dx.to(torch.int32), 0)
        new_y = state.bbox_y + torch.where(move, dy.to(torch.int32), 0)
        new_x = torch.clamp(new_x, 0, frame_w - bw).to(torch.int32)
        new_y = torch.clamp(new_y, 0, frame_h - bh).to(torch.int32)
        box = torch.stack([new_x, new_y, new_x.new_tensor(bw), new_y.new_tensor(bh)])
        return FlowState(new_x, new_y, frame), box

    return step


def track_video_flow(
    frames: np.ndarray,
    bbox: Tuple[int, int, int, int],
    chunk_size: int = 16,
    device=None,
) -> Tuple[FlowState, np.ndarray]:
    """Track a gray video (F, H, W) with the flow baseline on `device`
    (default: the current CUDA device; pass device="cpu" for the CPU); frame
    0 seeds prev_gray (cudab.cpp:55-57).  Frames go to the device a chunk
    at a time and the chunk's boxes come back once.  Returns (final state,
    boxes (F - 1, 4) int32)."""
    frames = np.asarray(frames)
    f, h, w = frames.shape
    x, y, bw, bh = bbox
    device = default_device(device)
    first = frames[0]
    first_f32 = first.astype(np.float32) / 255.0 if first.dtype == np.uint8 else first
    corner = torch.tensor([x, y], dtype=torch.int32, device=device)
    state = FlowState(corner[0], corner[1], torch.as_tensor(first_f32, device=device))
    step = make_flow_step((h, w), (bw, bh))
    outs = []
    for start in range(1, f, chunk_size):
        chunk = torch.from_numpy(np.ascontiguousarray(frames[start : start + chunk_size]))
        boxes = []
        for frame in chunk.to(device):
            state, box = step(state, frame)
            boxes.append(box)
        outs.append(torch.stack(boxes).cpu().numpy())
    return state, np.concatenate(outs) if outs else np.zeros((0, 4), np.int32)

