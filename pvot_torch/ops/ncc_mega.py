"""A whole chunk of single-stream tracking: the port of pvot/ops/ncc_mega.py
`mega_track_chunk` (:818) at its f32 tier, with in-kernel global search.

`mega_track_chunk` runs the chunk through the hand-written Hopper kernel
(pvot_torch/csrc/ncc_mega.cu: per frame one scoring launch over the whole card
and one commit launch, the state resident in device memory) when its
tensors lie on a CUDA device, and through `mega_track_chunk_reference`, the
plain PyTorch version beside it, when they lie on the CPU.  A CUDA tensor
never reaches the plain version: there the kernel runs or the call raises.

Both return (rows (F, 10) float32, final template (th, tw) float32): the
per-frame records in lanes O_* (pvot/ops/ncc_mega.py:78-81; O_POISON is
always 0) and the template after the chunk's EMA updates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.ncc_reference import corr2_valid
from pvot_torch.tracker.state import is_bbox_outside_frame
from pvot_torch.tracker.step import f32

(
    O_BX, O_BY, O_BW, O_BH, O_SCORE, O_UPDATED, O_POISON, O_LOST, O_USEG,
    O_GUSED,
) = range(10)
N_LANES = 10
BIG = 2**30

# Shared memory one block may use on Hopper (227 KB), and the scoring
# kernel's tile constants (kTileH, kTileW, kSplit in csrc/ncc_mega.cu).
SMEM_LIMIT = 232_448
_TILE_H, _TILE_W, _SPLIT = 8, 16, 16
# The commit block holds the template in registers: kCommitThreads x
# kEmaPerThread pixels.
MAX_TEMPLATE_PX = 1024 * 20


class MegaGeometry:
    """Static shapes of one chunk and the port's envelope: the kernel stages
    the template and one input tile in shared memory, so the template must
    fit beside the tile."""

    def __init__(self, frame_shape, templ_shape, config: TrackerConfig):
        self.frame_h, self.frame_w = frame_shape
        self.th, self.tw = templ_shape
        self.out_h = self.frame_h - self.th + 1
        self.out_w = self.frame_w - self.tw + 1
        self.rx, self.ry = config.search_radius_x, config.search_radius_y

    def smem_bytes(self) -> int:
        """csrc/ncc_mega.cu score_smem_bytes: padded template,
        input tile, row sums and the row groups' partial correlations."""
        tw4 = -(-self.tw // 4) * 4
        in_w = _TILE_W + tw4 + (16 - (_TILE_W + tw4) % 32) % 32
        in_h, n_out = _TILE_H + self.th - 1, _TILE_H * _TILE_W
        return 4 * (self.th * tw4 + in_h * in_w + 2 * in_h * _TILE_W + _SPLIT * n_out)

    def check(self) -> "MegaGeometry":
        if self.out_h < 1 or self.out_w < 1:
            raise ValueError(
                f"template {self.th}x{self.tw} larger than frame "
                f"{self.frame_h}x{self.frame_w}"
            )
        if self.th * self.tw > MAX_TEMPLATE_PX:
            raise ValueError(
                f"template {self.th}x{self.tw} outside the kernel's envelope: "
                f"more than {MAX_TEMPLATE_PX} pixels"
            )
        if self.smem_bytes() > SMEM_LIMIT:
            raise ValueError(
                f"template {self.th}x{self.tw} outside the kernel's envelope: "
                f"{self.smem_bytes()} bytes of shared memory > {SMEM_LIMIT}"
            )
        return self


def _frame_mode(g: MegaGeometry, config: TrackerConfig, bbox, lost: int,
                useg: bool, valid: bool):
    """(use_global, do_global, inclusive region (ry0, ry1, rx0, rx1)) of a
    frame, as csrc/ncc_mega.cu frame_mode derives them."""
    bx, by, bw, bh = bbox
    use_global = config.enable_global_search and (
        useg or is_bbox_outside_frame(bx, by, bw, bh, g.frame_w, g.frame_h)
        or lost >= config.lost_frame_threshold
    )
    b = search_ops.local_window_bounds(
        bx + (bw >> 1), by + (bh >> 1), g.tw, g.th, g.out_w, g.out_h, g.rx, g.ry
    )
    do_global = (use_global or not b.valid) and valid
    if do_global:
        return use_global, True, (0, g.out_h - 1, 0, g.out_w - 1)
    return use_global, False, (b.min_ty, b.max_ty, b.min_tx, b.max_tx)


def _chunk_scores(region: torch.Tensor, tc: torch.Tensor, t_std, sum_tc, n: float):
    """The kernel's score formula over a float32 region (pvot/ops/ncc_mega.py
    :462-470), sums by valid-mode correlation."""
    ones = torch.ones_like(tc)
    mean = corr2_valid(region, ones) / n
    var = corr2_valid(region * region, ones) / n - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    cov = corr2_valid(region, tc) - mean * sum_tc
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)


def mega_track_chunk_reference(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid: int,
    config: TrackerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chunk kernel: a per-frame loop of torch
    ops with the kernel's inputs, outputs and arithmetic (the order of each
    sum aside).  On the card it needs TF32 off: its sums run through cuDNN."""
    if frames_u8.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("set torch.backends.cudnn.allow_tf32 = False first")
    f, h, w = frames_u8.shape
    th, tw = template.shape
    g = MegaGeometry((h, w), (th, tw), config).check()
    n = float(th * tw)
    lr = float(config.template_update_lr)
    bbox_l = [int(v) for v in bbox.tolist()]
    lost, useg = int(lost_count), bool(use_global)
    tpl = template.to(torch.float32).clone()
    t_mean = t_mean.to(torch.float32)
    t_std = t_std.to(torch.float32)
    sum_tc = torch.sum(tpl - t_mean)
    rows = torch.zeros((f, N_LANES), dtype=torch.float32)
    for t in range(f):
        valid = t < n_valid
        ug, do_global, (ry0, ry1, rx0, rx1) = _frame_mode(g, config, bbox_l, lost, useg, valid)
        if ry1 >= ry0 and rx1 >= rx0:
            region = ensure_gray_f32(frames_u8[t, ry0 : ry1 + th, rx0 : rx1 + tw])
            best_val, bx, by = search_ops.argmax2d(
                _chunk_scores(region, tpl - t_mean, t_std, sum_tc, n)
            )
            best = (float(best_val), ry0 + by, rx0 + bx)
        else:  # collapsed window on a frame past n_valid
            best = (float("-inf"), BIG, BIG)
        threshold = f32(config.global_confidence if ug else config.min_confidence)
        accept = valid and best[0] >= threshold
        if accept:
            bbox_l = [best[2], best[1], tw, th]
            lost = 0
        elif valid:
            lost += 1
        if valid:
            useg = ug and not (accept and not is_bbox_outside_frame(*bbox_l, w, h))
        if accept and best[0] >= f32(config.strong_confidence):
            y, x = best[1], best[2]
            patch = ensure_gray_f32(frames_u8[t, y : y + th, x : x + tw])
            tpl = f32(1.0 - lr) * tpl + f32(lr) * patch
            t_mean = tpl.sum() / n
            var = (tpl * tpl).sum() / n - t_mean * t_mean
            t_std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6
            sum_tc = torch.sum(tpl - t_mean)
        rows[t] = torch.tensor(
            [*bbox_l, best[0], float(accept), 0.0, lost, float(useg), float(do_global)]
        )
    return rows.to(frames_u8.device), tpl


def mega_track_chunk(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid: int,
    config: TrackerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track one chunk of frames (F, H, W) uint8 from the given state.

    On a CUDA device: 2F kernel launches on the current stream, no host
    synchronisation; `mega_track_chunk.launches` grows by 2F.  On the CPU:
    the plain version.  Frames past `n_valid` commit nothing."""
    if frames_u8.device.type == "cpu":
        return mega_track_chunk_reference(
            frames_u8, bbox, template, t_mean, t_std, lost_count, use_global,
            n_valid, config,
        )
    if frames_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 3:
        raise ValueError(f"expected (F, H, W) uint8 frames, got {frames_u8.dtype} "
                         f"{tuple(frames_u8.shape)}")
    dev = frames_u8.device
    for name, v in (("bbox", bbox), ("template", template), ("t_mean", t_mean),
                    ("t_std", t_std), ("lost_count", lost_count),
                    ("use_global", use_global)):
        if v.device != dev:
            raise ValueError(f"{name} on {v.device}, frames on {dev}")
    frames_u8 = frames_u8.contiguous()
    f, h, w = frames_u8.shape
    th, tw = template.shape
    MegaGeometry((h, w), (th, tw), config).check()
    from pvot_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(dev):
        i32 = torch.int32
        state_i = torch.cat([
            bbox.reshape(4).to(i32), lost_count.reshape(1).to(i32),
            use_global.reshape(1).to(i32), torch.zeros(2, dtype=i32, device=dev),
        ])
        tpl = template.to(torch.float32)
        tm = t_mean.reshape(()).to(torch.float32)
        state_f = torch.stack([
            tm, t_std.reshape(()).to(torch.float32), torch.sum(tpl - tm),
            torch.zeros((), dtype=torch.float32, device=dev),
        ])
        # The kernel updates the template in place, in its own buffer with the
        # rows padded to a multiple of 4 columns (float4 loads); the padding
        # stays 0.
        tpl_pad = torch.zeros((th, tw + (-tw % 4)), dtype=torch.float32, device=dev)
        tpl_pad[:, :tw] = tpl
        rows = torch.empty((f, N_LANES), dtype=torch.float32, device=dev)
        n_parts = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
        part_val = torch.empty(n_parts, dtype=torch.float32, device=dev)
        part_yx = torch.empty(2 * n_parts, dtype=i32, device=dev)
        # Local windows are at most span_y x span_x: their tiles, two halves each.
        max_split = (-(-(2 * config.search_radius_y + 1) // _TILE_H)
                     * -(-(2 * config.search_radius_x + 1) // _TILE_W))
        split_part = torch.empty(max_split * 2 * 3 * _TILE_H * _TILE_W,
                                 dtype=torch.float32, device=dev)
        split_count = torch.zeros(max_split, dtype=i32, device=dev)
        lr = float(config.template_update_lr)
        err = lib.pvot_mega_track_chunk(
            frames_u8.data_ptr(), f, h, w, th, tw, int(n_valid),
            state_i.data_ptr(), state_f.data_ptr(), tpl_pad.data_ptr(),
            part_val.data_ptr(), part_yx.data_ptr(), n_parts, split_part.data_ptr(),
            split_count.data_ptr(), max_split, rows.data_ptr(),
            config.search_radius_x, config.search_radius_y,
            config.lost_frame_threshold, int(config.enable_global_search),
            f32(config.min_confidence), f32(config.global_confidence),
            f32(config.strong_confidence), f32(lr), f32(1.0 - lr),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "mega_track_chunk")
        mega_track_chunk.launches += 2 * f
    return rows, tpl_pad[:, :tw].contiguous()


mega_track_chunk.launches = 0
