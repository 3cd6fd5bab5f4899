"""The plain reference tracker: NCC template tracking in plain PyTorch.

It follows the published tracking state machine (the reference tracker's
tracker_ghc/src/main.cpp: a local search window around the box, a
full-frame search once the target is lost, confidence gates and an EMA
template update) and its score formula, per output position with
N = th * tw:

    mean, var = moments of the window (summed in float64, rounded once)
    std       = sqrt(max(var, 1e-6))
    score     = (corr(window, T - t_mean) - mean * sum(T - t_mean))
                / ((std + 1e-6) * (t_std + 1e-6) * N)

with t_std the template's population std plus 1e-6.  The correlation is a
float32 product (TF32 off): the region is unfolded along its columns and
multiplied with the template's rows, and each output sums its template rows'
products.  `tf32=True` rounds both operands of that product to TF32 first,
as the tensor cores' TF32 mode does: the control, one precision below.

It imports nothing of the program under test and takes nothing it made:
frames come in as uint8, states as boxes and float32 templates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

U8_SCALE = float(np.float32(1.0 / 255.0))
# Elements of one block's unfolded region at most (1 GiB of float32).
_BLOCK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class Params:
    """The geometry and the tracker's knobs, from a configuration file."""

    frame_h: int
    frame_w: int
    th: int
    tw: int
    radius_x: int
    radius_y: int
    min_confidence: float
    global_confidence: float
    strong_confidence: float
    template_update_lr: float
    lost_frame_threshold: int
    enable_global_search: bool

    @classmethod
    def from_config(cls, config: dict) -> "Params":
        t = config["tracker"]
        (h, w), (th, tw) = config["frame"], config["template"]
        return cls(h, w, th, tw, t["search_radius_x"], t["search_radius_y"],
                   t["min_confidence"], t["global_confidence"], t["strong_confidence"],
                   t["template_update_lr"], t["lost_frame_threshold"],
                   t["enable_global_search"])

    @property
    def out_h(self) -> int:
        return self.frame_h - self.th + 1

    @property
    def out_w(self) -> int:
        return self.frame_w - self.tw + 1


@dataclasses.dataclass
class Lane:
    """One tracker's state: box (x, y, w, h), template (th, tw) float32, lost
    frames and the sticky global-search flag."""

    bbox: List[int]
    template: torch.Tensor
    lost: int = 0
    use_global: bool = False

    def copy(self) -> "Lane":
        return Lane(list(self.bbox), self.template.clone(), self.lost, self.use_global)


def f32(v: float) -> float:
    return float(np.float32(v))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


def is_outside(bbox: Sequence[int], frame_w: int, frame_h: int) -> bool:
    """Center out of frame, or box entirely out of frame."""
    bx, by, bw, bh = bbox
    cx, cy = bx + bw // 2, by + bh // 2
    return (cx < 0 or cx >= frame_w or cy < 0 or cy >= frame_h
            or bx + bw < 0 or bx >= frame_w or by + bh < 0 or by >= frame_h)


def window_bounds(p: Params, bbox: Sequence[int]):
    """Inclusive map bounds (min_tx, max_tx, min_ty, max_ty) of the local
    window around the box's center, each clamped on its own."""
    bx, by, bw, bh = bbox
    cx, cy = bx + (bw >> 1), by + (bh >> 1)
    return (max(0, cx - p.radius_x - p.tw // 2), min(p.out_w - 1, cx + p.radius_x - p.tw // 2),
            max(0, cy - p.radius_y - p.th // 2), min(p.out_h - 1, cy + p.radius_y - p.th // 2))


def template_stats(tpl: torch.Tensor):
    """(mean, population std + 1e-6) over the last two axes, float32."""
    mean = tpl.mean(dim=(-2, -1))
    var = (tpl * tpl).mean(dim=(-2, -1)) - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6


def correlate(region: torch.Tensor, tc: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Valid cross-correlation of regions (L, RH, RW) with templates (L, th,
    tw): (L, RH - th + 1, RW - tw + 1) float32, the products in float32
    (or TF32-rounded operands with `tf32`), in blocks of output rows."""
    n_l, rh, rw = region.shape
    th, tw = tc.shape[-2:]
    oh, ow = rh - th + 1, rw - tw + 1
    if tf32:
        region, tc = tf32_round(region), tf32_round(tc)
    rhs = tc.transpose(-2, -1).contiguous()  # (L, tw, th)
    rows = max(1, _BLOCK_ELEMS // max(1, n_l * ow * tw) - th + 1)
    out = torch.empty((n_l, oh, ow), dtype=torch.float32, device=region.device)
    for p0 in range(0, oh, rows):
        p1 = min(oh, p0 + rows)
        slab = region[:, p0 : p1 + th - 1]  # (L, r, RW)
        r = slab.shape[1]
        unfolded = slab.unfold(2, tw, 1).reshape(n_l, r * ow, tw)
        m = torch.bmm(unfolded, rhs).reshape(n_l, r, ow, th)
        # out[l, p, q] = sum_i m[l, p + i, q, i]
        diag = m.as_strided((n_l, p1 - p0, ow, th),
                            (m.stride(0), m.stride(1), m.stride(2), m.stride(1) + 1))
        out[:, p0:p1] = diag.sum(dim=-1)
    return out


def window_moments(region: torch.Tensor, th: int, tw: int):
    """(mean, var) of every th x tw window of regions (L, RH, RW), summed in
    float64 over integral images and rounded to float32 once."""
    r64 = region.to(torch.float64)
    n = float(th * tw)

    def box(x):
        ii = torch.nn.functional.pad(x.cumsum(1).cumsum(2), (1, 0, 1, 0))
        return ii[:, th:, tw:] - ii[:, :-th, tw:] - ii[:, th:, :-tw] + ii[:, :-th, :-tw]

    mean64 = box(r64) / n
    var = (box(r64 * r64) / n - mean64 * mean64).to(torch.float32)
    return mean64.to(torch.float32), var


def scores(region: torch.Tensor, tpl: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """NCC scores of every window of regions (L, RH, RW) against templates
    (L, th, tw), float32."""
    th, tw = tpl.shape[-2:]
    n = float(th * tw)
    t_mean, t_std = template_stats(tpl)
    tc = tpl - t_mean[:, None, None]
    sum_tc = tc.sum(dim=(-2, -1))
    mean, var = window_moments(region, th, tw)
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    cov = correlate(region, tc, tf32) - mean * sum_tc[:, None, None]
    return cov / ((std + 1e-6) * (t_std + 1e-6)[:, None, None] * n)


def initial_lane(frame_u8: torch.Tensor, bbox: Sequence[int]) -> Lane:
    """A tracker started on `bbox` of a uint8 frame (H, W): its template is
    the box's pixels times float32(1/255)."""
    x, y, w, h = (int(v) for v in bbox)
    return Lane([x, y, w, h], frame_u8[y : y + h, x : x + w].to(torch.float32) * U8_SCALE)


def ema(tpl: torch.Tensor, patch_u8: torch.Tensor, lr: float) -> torch.Tensor:
    """(1 - lr) * tpl + lr * (patch * float32(1/255)), each product and the
    sum rounded to float32."""
    return tpl * f32(1.0 - lr) + (patch_u8.to(torch.float32) * U8_SCALE) * f32(lr)


def step(frames: torch.Tensor, lanes: List[Lane], p: Params, tf32: bool = False) -> np.ndarray:
    """One frame for every lane: frames (L, H, W) uint8, lane l searching
    frames[l] (the same tensor repeated for objects in one stream).  Updates
    the lanes in place and returns their records (L, 7): x, y, w, h, score,
    updated, used_global."""
    span_y, span_x = 2 * p.radius_y + 1, 2 * p.radius_x + 1
    modes = []
    for lane in lanes:
        ug = p.enable_global_search and (
            lane.use_global or is_outside(lane.bbox, p.frame_w, p.frame_h)
            or lane.lost >= p.lost_frame_threshold)
        b = window_bounds(p, lane.bbox)
        modes.append((ug, ug or not (b[1] >= b[0] and b[3] >= b[2]), b))
    best = [None] * len(lanes)
    local = [i for i, (_, g, _) in enumerate(modes) if not g]
    if local:
        origins = [(min(modes[i][2][0], p.out_w - span_x), min(modes[i][2][2], p.out_h - span_y))
                   for i in local]
        region = torch.stack([frames[i, y0 : y0 + span_y + p.th - 1, x0 : x0 + span_x + p.tw - 1]
                              for i, (x0, y0) in zip(local, origins)])
        s = scores(region.to(torch.float32) * U8_SCALE,
                   torch.stack([lanes[i].template for i in local]), tf32)
        ys = torch.arange(span_y, device=s.device)[None, :, None]
        xs = torch.arange(span_x, device=s.device)[None, None, :]
        lo = torch.tensor([[modes[i][2][0] - x0, modes[i][2][1] - x0,
                            modes[i][2][2] - y0, modes[i][2][3] - y0]
                           for i, (x0, y0) in zip(local, origins)], device=s.device)
        inside = ((xs >= lo[:, 0, None, None]) & (xs <= lo[:, 1, None, None])
                  & (ys >= lo[:, 2, None, None]) & (ys <= lo[:, 3, None, None]))
        flat = torch.where(inside, s, float("-inf")).reshape(len(local), -1)
        idx = torch.argmax(flat, dim=1)
        val = flat.gather(1, idx[:, None])[:, 0]
        host = torch.stack([val.to(torch.float64), idx.to(torch.float64)]).cpu().numpy()
        for k, (i, (x0, y0)) in enumerate(zip(local, origins)):
            j = int(host[1, k])
            best[i] = (float(np.float32(host[0, k])), x0 + j % span_x, y0 + j // span_x)
    for i, (_, g, _) in enumerate(modes):
        if g:  # the whole map
            s = scores(frames[i][None].to(torch.float32) * U8_SCALE, lanes[i].template[None],
                       tf32)[0]
            j = int(torch.argmax(s.reshape(-1)))
            best[i] = (float(np.float32(float(s.reshape(-1)[j]))), j % p.out_w, j // p.out_w)
    out = np.zeros((len(lanes), 7), np.float64)
    for i, lane in enumerate(lanes):
        ug, do_global, _ = modes[i]
        val, bx, by = best[i]
        accept = val >= f32(p.global_confidence if ug else p.min_confidence)
        if accept:
            lane.bbox = [bx, by, p.tw, p.th]
            lane.lost = 0
        else:
            lane.lost += 1
        lane.use_global = ug and not (accept and not is_outside(lane.bbox, p.frame_w, p.frame_h))
        if accept and val >= f32(p.strong_confidence):
            lane.template = ema(lane.template, frames[i, by : by + p.th, bx : bx + p.tw],
                                p.template_update_lr)
        out[i] = (*lane.bbox, val, float(accept), float(do_global))
    return out


def track(frames_at, n_frames: int, lanes: List[Lane], p: Params, tf32: bool = False) -> np.ndarray:
    """n_frames steps; frames_at(t) gives step t's frames (L, H, W) uint8.
    Returns the records (n_frames, L, 7); the lanes end in their new state."""
    out = np.zeros((n_frames, len(lanes), 7))
    for t in range(n_frames):
        out[t] = step(frames_at(t), lanes, p, tf32)
    return out
