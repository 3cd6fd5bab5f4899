"""Search-window math and argmax with row-major first-occurrence ties
(pvot/ops/search.py).

Window bounds are plain Python ints: the steps that use them run one frame
at a time on the host's control flow.  `argmax2d` returns (best_val as a
0-d tensor, x, y as ints); the `*_best` argmaxes return one (value, x, y)
float32 row on the scores' device, which a step reads once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class WindowBounds(NamedTuple):
    """Inclusive NCC-map coordinates of the clamped local window."""

    min_tx: int
    max_tx: int
    min_ty: int
    max_ty: int

    @property
    def valid(self) -> bool:
        return self.max_tx >= self.min_tx and self.max_ty >= self.min_ty


def local_window_bounds(
    cx: int, cy: int, templ_w: int, templ_h: int, out_w: int, out_h: int,
    radius_x: int, radius_y: int,
) -> WindowBounds:
    """Clamped window around bbox center (cx, cy), in NCC-map coordinates;
    each bound clamps on its own to [0, out - 1]."""
    half_w = templ_w // 2
    half_h = templ_h // 2
    return WindowBounds(
        max(0, cx - radius_x - half_w),
        min(out_w - 1, cx + radius_x - half_w),
        max(0, cy - radius_y - half_h),
        min(out_h - 1, cy + radius_y - half_h),
    )


def argmax2d(score_map: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(best_val, x, y); torch.argmax returns the first maximal index of the
    row-major flattening, which is the reference's tie-break."""
    w = score_map.shape[1]
    flat = score_map.reshape(-1)
    idx = int(torch.argmax(flat))
    return flat[idx], idx % w, idx // w


def _window_mask(shape, x0: int, y0: int, bounds: WindowBounds, device):
    h, w = shape
    ys = y0 + torch.arange(h, device=device)[:, None]
    xs = x0 + torch.arange(w, device=device)[None, :]
    return (
        (xs >= bounds.min_tx) & (xs <= bounds.max_tx)
        & (ys >= bounds.min_ty) & (ys <= bounds.max_ty)
    )


def region_origin(
    bounds: WindowBounds, out_w: int, out_h: int, span_x: int, span_y: int
) -> Tuple[int, int]:
    """Top-left map coordinate of the fixed (span_y, span_x) candidate
    region that covers the window and stays inside the map."""
    return min(bounds.min_tx, out_w - span_x), min(bounds.min_ty, out_h - span_y)


def best_rows(scores: torch.Tensor, x0=0, y0=0) -> torch.Tensor:
    """(..., 3) float32 rows (best value, x0 + x, y0 + y) of score maps
    (..., h, w), row-major first occurrence (torch.argmax's rule), computed on
    the maps' device so that one read brings all three to the host.
    Coordinates are exact in float32 below 2^24."""
    w = scores.shape[-1]
    flat = scores.reshape(*scores.shape[:-2], -1)
    idx = torch.argmax(flat, dim=-1, keepdim=True)
    val = torch.gather(flat, -1, idx)[..., 0].to(torch.float32)
    idx = idx[..., 0]
    return torch.stack([val, (idx % w + x0).to(torch.float32),
                        (idx // w + y0).to(torch.float32)], dim=-1)


def masked_region_best(region_scores: torch.Tensor, x0: int, y0: int,
                       bounds: WindowBounds) -> torch.Tensor:
    """Argmax over a region whose (0, 0) is map position (y0, x0), masked to
    the window (outside scores -inf), as one (3,) row (value, x, y) in map
    coordinates on the scores' device."""
    mask = _window_mask(region_scores.shape, x0, y0, bounds, region_scores.device)
    return best_rows(torch.where(mask, region_scores, float("-inf")), x0, y0)


def masked_window_best(ncc_map: torch.Tensor, bounds: WindowBounds) -> torch.Tensor:
    """Argmax of a full map restricted to `bounds`, as one (3,) row."""
    return masked_region_best(ncc_map, 0, 0, bounds)
