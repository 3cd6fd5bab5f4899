"""The roofline count: the least time the card could take for the frames a
chunk kernel tracked, from the trajectory itself.

A frozen copy of pvot_torch/bench.py's `scored_windows`, `union_pixels` and
`bound_ms` and of its peaks (reviewed with that module), with the local
window's bounds copied beside them, so that no later change of the program
moves the yardstick.  The work is what the inputs need: each frame's scored
window around the box it starts from (the template's extent past the last
position included), or the whole frame on a frame whose argmax ran global;
the operations are 2 * th * tw per scored position, the bytes the windows'
pixels read once (the union of the lanes' windows where lanes share one
frame), each lane's template read and written once a chunk, and each record
written once.
"""

from __future__ import annotations

from typing import Sequence

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, the rate of the float32 tier's correlation;
# dense bf16 on the tensor cores, the rate of the bf16 tiers' passes; HBM3.
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
RECORD_BYTES = 40  # ten float32 fields a tracker-frame


def window_bounds(cx: int, cy: int, tw: int, th: int, out_w: int, out_h: int, rx: int,
                  ry: int):
    """Inclusive map bounds (min_tx, max_tx, min_ty, max_ty) of the clamped
    local window around the center (cx, cy)."""
    return (max(0, cx - rx - tw // 2), min(out_w - 1, cx + rx - tw // 2),
            max(0, cy - ry - th // 2), min(out_h - 1, cy + ry - th // 2))


def scored_windows(start_bbox, bboxes, used_global, frame_shape, templ_shape, radii) -> list:
    """The frame pixels each of one tracker's frames reads, as (x0, y0, w, h):
    its clamped local window around the box it starts from, the template's
    extent past the last position included, or the whole frame on a frame
    whose argmax ran global.  bboxes (F, 4) are the boxes after each frame,
    used_global (F,) the frames' flags, radii (rx, ry)."""
    (h, w), (th, tw) = frame_shape, templ_shape
    out_h, out_w = h - th + 1, w - tw + 1
    out = []
    bx, by, bw, bh = (int(v) for v in start_bbox)
    for box, glob in zip([list(b) for b in bboxes], [bool(g) for g in used_global]):
        if glob:
            out.append((0, 0, w, h))
        else:
            x0, x1, y0, y1 = window_bounds(bx + bw // 2, by + bh // 2, tw, th, out_w, out_h,
                                           *radii)
            out.append((x0, y0, x1 - x0 + tw, y1 - y0 + th))
        bx, by, bw, bh = (int(v) for v in box)
    return out


def union_pixels(rects) -> int:
    """Pixels covered by any of the rectangles (x0, y0, w, h): what lanes
    that share one frame read of it."""
    xs = sorted({v for x, _, w, _ in rects for v in (x, x + w)})
    ys = sorted({v for _, y, _, h in rects for v in (y, y + h)})
    return sum((x1 - x0) * (y1 - y0)
               for x0, x1 in zip(xs, xs[1:]) for y0, y1 in zip(ys, ys[1:])
               if any(x <= x0 and x1 <= x + w and y <= y0 and y1 <= y + h
                      for x, y, w, h in rects))


def bound_ms(fma: float, n_bytes: float, passes: int = 0) -> tuple:
    """(least milliseconds the card could take, what bounds it): the larger of
    the correlation's operations at their peak, 2 * fma FP32 operations at
    the FP32 peak (passes 0) or passes * 2 * fma bf16 operations at the bf16
    tensor-core peak, and n_bytes at the memory rate."""
    t_ops = 2.0 * fma * passes / BF16_FLOPS if passes else 2.0 * fma / FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def chunk_work(windows: Sequence[list], templ_shape, shared_frame: bool) -> tuple:
    """(fma, bytes) of one chunk kernel: windows[l] the scored windows of lane
    l's frames in the chunk.  shared_frame: the lanes search one frame (K
    objects), whose pixels are read once, the union of their windows; else
    each lane reads its own frame."""
    th, tw = templ_shape
    fma = th * tw * sum((ww - tw + 1) * (wh - th + 1)
                        for lane in windows for _, _, ww, wh in lane)
    if shared_frame:
        pixels = sum(union_pixels(rects) for rects in zip(*windows))
    else:
        pixels = sum(ww * wh for lane in windows for _, _, ww, wh in lane)
    frames = sum(len(lane) for lane in windows)
    return fma, pixels + len(windows) * 2 * th * tw * 4 + frames * RECORD_BYTES
