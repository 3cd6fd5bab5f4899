"""The one traffic generator: seeded gray clips made on the device.

A clip is `period` frames of a smooth low-frequency background with K
noise-textured targets pasted on it and per-frame sensor noise, the frame
format the configuration states.  Target k's center follows
center_k + round(amplitude * sin(2 pi * cycles * t / period)) in x and y, with
t taken modulo the period, so the clip loops without a seam: frame `period`
would equal frame 0 but for its noise.  A mix lays the targets out on a grid of
cells inside the area where every local search window stays whole, so every
seed asks for the same work; the seed draws the textures, the background and
the noise.  A clip's `phase` shifts its targets along their paths: streams of
one mix start at different points of the path.

A mix may hide its targets: with `"occlusion": {"first": f, "step": s,
"hidden": n}`, clip `index` leaves its targets out of clip frames
[f + index * s, f + index * s + n), so only the background and the sensor
noise show there.  The clip draws the same random numbers either way: its
visible frames are the unoccluded clip's bit for bit.

Everything is made with a torch.Generator on the clip's device, in blocks of
frames; the boxes are computed on the host in float64 and are exact.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

_BLOCK = 32  # frames made at once


def clip_seed(seed: int, index: int) -> int:
    """The generator seed of clip `index` of a run seeded `seed`."""
    return (int(seed) * 0x9E3779B1 + int(index) * 0x85EBCA77 + 0x165667B1) % (2**63 - 1)


def layout(config: dict, mix: dict) -> List[Tuple[int, int]]:
    """Path centers (cx, cy) of the mix's targets: the cells of a rows x cols
    grid over the area in which each path keeps its whole local search
    window inside the frame.  Raises when a path leaves that area."""
    (h, w), (th, tw) = config["frame"], config["template"]
    rx, ry = config["tracker"]["search_radius_x"], config["tracker"]["search_radius_y"]
    ax, ay = mix["amplitude_px"]
    rows, cols = mix["grid"]
    # Window whole: rx + tw // 2 <= cx <= w - tw + tw // 2 - rx, likewise y
    # (one pixel to spare).
    lo_x, hi_x = rx + tw // 2 + ax, w - tw + tw // 2 - rx - 1 - ax
    lo_y, hi_y = ry + th // 2 + ay, h - th + th // 2 - ry - 1 - ay
    if lo_x > hi_x or lo_y > hi_y:
        raise ValueError("the mix's paths leave the area of whole search windows")
    centers = []
    for r in range(rows):
        for c in range(cols):
            cx = lo_x + (hi_x - lo_x) * (2 * c + 1) // (2 * cols)
            cy = lo_y + (hi_y - lo_y) * (2 * r + 1) // (2 * rows)
            centers.append((cx, cy))
    # Neighbours' boxes never overlap.
    if cols > 1 and (hi_x - lo_x) // cols < tw + 2 * ax:
        raise ValueError("the mix's targets overlap in x")
    if rows > 1 and (hi_y - lo_y) // rows < th + 2 * ay:
        raise ValueError("the mix's targets overlap in y")
    return centers


def boxes(config: dict, mix: dict, phase: int = 0) -> np.ndarray:
    """Ground-truth boxes (period, K, 4) int64, (x, y, w, h), of a clip whose
    targets start `phase` frames along their paths."""
    (th, tw), period = config["template"], mix["period"]
    ax, ay = mix["amplitude_px"]
    fx, fy = mix["cycles"]
    t = (np.arange(period, dtype=np.int64) + phase) % period
    centers = layout(config, mix)
    out = np.zeros((period, len(centers), 4), np.int64)
    for k, (cx, cy) in enumerate(centers):
        # Each target's path starts a fraction k / K of a cycle later.
        off = k / len(centers)
        x = cx + np.rint(ax * np.sin(2 * math.pi * (fx * t / period + off)))
        y = cy + np.rint(ay * np.sin(2 * math.pi * (fy * t / period + off)))
        out[:, k] = np.stack([x - tw // 2, y - th // 2, np.full_like(x, tw),
                              np.full_like(y, th)], axis=1)
    return out


def hidden(config: dict, mix: dict, index: int) -> np.ndarray:
    """(period,) bool: the clip frames on which clip `index` hides its
    targets.  Raises where the box a tracker must report there is not
    defined: an interval that reaches the clip's last frame (every tracker
    starts on it), or one that does not outlast the lost threshold (the
    first visible frame after it must be searched globally)."""
    period = mix["period"]
    out = np.zeros(period, bool)
    occ = mix.get("occlusion")
    if occ is None:
        return out
    first, n = occ["first"] + index * occ["step"], occ["hidden"]
    t = config["tracker"]
    if first < 0 or first + n > period - 1:
        raise ValueError(f"clip {index} hides frames {first}-{first + n - 1}, outside "
                         f"frames 0-{period - 2} of its period")
    if n <= t["lost_frame_threshold"] or not t["enable_global_search"]:
        raise ValueError("a hidden interval must outlast lost_frame_threshold, with the "
                         "global search on")
    out[first : first + n] = True
    return out


def expected(paths: np.ndarray, hide: np.ndarray) -> np.ndarray:
    """The boxes (period, K, 4) a correct tracker reports: the path's box on a
    visible frame; on a hidden frame, nothing in it passes the gates, so the
    box of the last visible frame before it (the clip loops, and its last
    frame is always visible)."""
    t = np.arange(len(hide))
    last = np.maximum.accumulate(np.where(hide, -1, t))
    return paths[np.where(last < 0, len(hide) - 1, last)]


def make_clip(config: dict, mix: dict, seed: int, index: int, phase: int,
              device: torch.device, out: torch.Tensor = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Clip `index` of a run: (frames (period, H, W) uint8 on `device`, written
    into `out` when given, and the boxes (period, K, 4) a correct tracker
    reports, `expected`)."""
    (h, w), (th, tw) = config["frame"], config["template"]
    period = mix["period"]
    paths = boxes(config, mix, phase)
    hide = hidden(config, mix, index)
    n_k = paths.shape[1]
    g = torch.Generator(device=device)
    g.manual_seed(clip_seed(seed, index))
    textures = torch.randint(0, 256, (n_k, th, tw), generator=g, device=device).to(torch.float32)
    small = torch.randint(64, 192, (1, 1, h // 40 + 2, w // 40 + 2), generator=g,
                          device=device).to(torch.float32)
    background = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                                 align_corners=True)[0, 0]
    frames = out if out is not None else torch.empty((period, h, w), dtype=torch.uint8,
                                                     device=device)
    dy = torch.arange(th, device=device)
    dx = torch.arange(tw, device=device)
    for f0 in range(0, period, _BLOCK):
        n = min(_BLOCK, period - f0)
        block = background.expand(n, h, w).clone()
        shown = np.flatnonzero(~hide[f0 : f0 + n])  # the block's frames with targets
        sel = torch.as_tensor(shown, device=device)[:, None, None]
        for k in range(n_k):
            xy = torch.as_tensor(paths[f0 + shown, k, :2], device=device)
            ys = xy[:, 1, None, None] + dy[None, :, None]
            xs = xy[:, 0, None, None] + dx[None, None, :]
            block[sel, ys, xs] = textures[k]
        block += float(mix["noise_std"]) * torch.randn((n, h, w), generator=g, device=device)
        frames[f0 : f0 + n] = block.clamp_(0, 255).round_().to(torch.uint8)
    return frames, expected(paths, hide)
