"""Deterministic synthetic video generator (test fixture + benchmark input).

A copy of pvot/io/synthetic.py (numpy only; copied because importing `pvot`
imports JAX).  tests/test_torch_imports.py holds its clips byte-equal to the
original's.

The reference's input video `data/car.mp4` is not available, so a deterministic clip with a
known-motion target doubles as the correctness fixture (golden trajectories)
and the benchmark input (720p/1080p/4K configs from BASELINE.json).

The clip is a noise-textured square target moving along a parametric path over
a low-frequency background.  Everything derives from a seed, so golden tests
are reproducible bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    width: int = 1280
    height: int = 720
    num_frames: int = 120
    target_w: int = 80
    target_h: int = 80
    seed: int = 0
    # Path amplitude as a fraction of the free travel space.
    amplitude: float = 0.8
    # Per-frame additive noise std (uint8 counts); 0 = clean.
    noise_std: float = 2.0
    # If True the target leaves the frame in the middle third of the clip and
    # re-enters afterwards (exercises the lost-object / global re-acquisition
    # state machine, reference tracker_ghc/src/main.cpp:49-55, 183-192).
    exit_and_reenter: bool = False
    # Horizontal background scroll in px/frame (camera-pan analog): the
    # background moves while the target follows its own path, so trackers
    # can't succeed by latching onto background texture.
    background_scroll: float = 0.0
    # Periodic occlusions (round 4, the occlusion-heavy serving regime):
    # in every `occlusion_period`-frame window the target parks fully
    # outside the right edge for the LAST `occlusion_len` frames, then
    # re-enters.  0 disables.  Composes the lost-object -> global-search ->
    # re-acquire cycle repeatedly, unlike exit_and_reenter's single
    # mid-clip episode.
    occlusion_period: int = 0
    occlusion_len: int = 0
    # Phase offset (frames) for the occlusion cycle — lets multi-stream
    # fixtures STAGGER their occlusion windows (each stream a different
    # phase) vs occluding simultaneously (all phase 0).
    occlusion_phase: int = 0


def target_center(spec: SyntheticSpec, frame_idx: int) -> Tuple[int, int]:
    """Known ground-truth center of the target at `frame_idx` (x, y)."""
    t = frame_idx / max(1, spec.num_frames - 1)
    free_x = (spec.width - spec.target_w) // 2
    free_y = (spec.height - spec.target_h) // 2
    cx = spec.width // 2 + int(spec.amplitude * free_x * np.sin(2 * np.pi * t))
    cy = spec.height // 2 + int(spec.amplitude * free_y * np.sin(4 * np.pi * t) * 0.5)
    if spec.exit_and_reenter:
        third = spec.num_frames // 3
        if third <= frame_idx < 2 * third:
            # Park the target fully outside the right edge.
            cx = spec.width + spec.target_w
    if spec.occlusion_period:
        phase = (frame_idx + spec.occlusion_phase) % spec.occlusion_period
        if phase >= spec.occlusion_period - spec.occlusion_len:
            cx = spec.width + spec.target_w
    return cx, cy


def target_bbox(spec: SyntheticSpec, frame_idx: int) -> Tuple[int, int, int, int]:
    """Ground-truth bbox (x, y, w, h) at `frame_idx` (may lie outside frame)."""
    cx, cy = target_center(spec, frame_idx)
    return (cx - spec.target_w // 2, cy - spec.target_h // 2, spec.target_w, spec.target_h)


def _textures(spec: SyntheticSpec):
    rng = np.random.default_rng(spec.seed)
    # Target: high-contrast noise texture (trackable, high template variance).
    target = rng.integers(0, 256, size=(spec.target_h, spec.target_w), dtype=np.uint8)
    # Background: smooth low-frequency field so NCC peaks stay unambiguous.
    small = rng.integers(64, 192, size=(spec.height // 40 + 2, spec.width // 40 + 2)).astype(np.float32)
    ys = np.linspace(0, small.shape[0] - 1.001, spec.height)
    xs = np.linspace(0, small.shape[1] - 1.001, spec.width)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    fy = (ys - y0)[:, None].astype(np.float32)
    fx = (xs - x0)[None, :].astype(np.float32)
    bg = (
        small[y0][:, x0] * (1 - fy) * (1 - fx)
        + small[y0][:, x0 + 1] * (1 - fy) * fx
        + small[y0 + 1][:, x0] * fy * (1 - fx)
        + small[y0 + 1][:, x0 + 1] * fy * fx
    )
    return target, bg.astype(np.float32), rng


def generate_gray_frames(spec: SyntheticSpec) -> Iterator[np.ndarray]:
    """Yield uint8 grayscale frames (H, W) one at a time."""
    target, bg, rng = _textures(spec)
    for i in range(spec.num_frames):
        if spec.background_scroll:
            shift = int(round(spec.background_scroll * i)) % spec.width
            frame = np.roll(bg, -shift, axis=1).copy()
        else:
            frame = bg.copy()
        x, y, w, h = target_bbox(spec, i)
        # Paste the visible intersection of the target.
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(spec.width, x + w), min(spec.height, y + h)
        if x1 > x0 and y1 > y0:
            frame[y0:y1, x0:x1] = target[y0 - y : y1 - y, x0 - x : x1 - x]
        if spec.noise_std > 0:
            frame = frame + rng.normal(0.0, spec.noise_std, size=frame.shape)
        yield np.clip(frame, 0, 255).astype(np.uint8)


def generate_gray_video(spec: SyntheticSpec) -> np.ndarray:
    """All frames stacked: uint8 (num_frames, H, W)."""
    return np.stack(list(generate_gray_frames(spec)))


def generate_bgr_frames(spec: SyntheticSpec) -> Iterator[np.ndarray]:
    """Yield uint8 BGR frames (H, W, 3) — gray replicated across channels so the
    grayscale conversion round-trips exactly."""
    for g in generate_gray_frames(spec):
        yield np.repeat(g[:, :, None], 3, axis=2)
