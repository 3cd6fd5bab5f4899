"""Whole chunks of tracking, one stream, many streams or many objects: the
port of pvot/ops/ncc_mega.py `mega_track_chunk` (:818, K1),
`mega_track_chunk_multi` (:966, K2) and `mega_track_chunk_objects` (:1115,
K3) with in-kernel global search, at every score tier and batch cadence.

Tiers: `highest=True` scores in float32; `highest=False` runs the
correlation as `score_passes` (1, 2 or 3) bf16 passes with exact products
and float32 sums (pvot/ops/ncc_mega.py:384-440; the plain versions through
`ncc_reference.tiered_corr`, the kernels on the tensor cores), in local
frames and global ones alike.  `batch` > 1 is the look-ahead cadence
(pvot/ops/ncc_mega.py:262-311): frame t of a chunk is scored and committed
only when t % batch == batch - 1 and t < (n_valid // batch) * batch; every
other frame emits the look-ahead record (the state as it stands, score -1,
no update).  Any batch >= 1 runs in the kernels; the drivers cut chunks on
batch boundaries.

`mega_track_chunk` (one stream), `mega_track_chunk_multi` (S streams) and
`mega_track_chunk_objects` (K objects over one clip, templates of one size
or zero-padded into a shared bucket) run the chunk through the hand-written
Hopper kernel (pvot_torch/csrc/ncc_mega.cu: one persistent cooperative
launch a chunk, whose blocks walk the scored frame steps together and meet
at one grid barrier a step, the lanes' states and templates in device
memory) when their tensors lie on a CUDA device, and through the plain
PyTorch versions beside them (`..._reference`) when they lie on the CPU.  A
CUDA tensor never reaches a plain version: there the kernel runs or the
call raises, also when the card refuses the cooperative launch.

They return (rows, final templates): the per-frame records in fields O_*
(pvot/ops/ncc_mega.py:78-81; O_POISON is always 0), (F, 10) or (S, F, 10)
float32, and the templates after the chunk's EMA updates, (th, tw) or
(S, th, tw) float32.

Each call is one `pvot.chunk` span (pvot_torch.utils.timing.span): the
checks, the state's packing, the buffers, the grid query, the C call and
the counters on the card, or the plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.ncc_reference import ncc_scores, score_tier
from pvot_torch.tracker.state import is_bbox_outside_frame
from pvot_torch.tracker.step import f32
from pvot_torch.utils import timing

(
    O_BX, O_BY, O_BW, O_BH, O_SCORE, O_UPDATED, O_POISON, O_LOST, O_USEG,
    O_GUSED,
) = range(10)
N_LANES = 10
BIG = 2**30

# The JAX mega kernel's envelope (pvot/ops/ncc_mega.py:148-167 MegaGeometry
# .supported): templates up to 256 px a side, spans up to 4 x 128.
MAX_TEMPLATE = 256
MAX_SPAN = 512
# Shared memory one block may use on Hopper (227 KB) less the 3 KB the chunk
# kernel keeps for its static shared memory (kSmemLimit), and the kernel's
# constants (kTileH, kTileW, kSplit and sizeof(LaneWork) in
# csrc/mega_body.cuh).
SMEM_LIMIT = 232_448 - 3072
_TILE_H, _TILE_W, _SPLIT = 8, 16, 16
_LANE_WORK_BYTES = 132
# The resident plan's constants (kResTileH, kResPart, kPreSlots and kThreads
# in csrc/mega_body.cuh).
_RES_TILE_H, _RES_PART, _PRE_SLOTS, _THREADS = 32, 32 * (16 + 4), 3, 512
# The chunk kernel's shared-memory plans (csrc/mega_body.cuh plan_of), in
# the C entry's numbering.
PLANS = ("whole", "resident", "chunked")


def check_batch(batch) -> int:
    """The look-ahead cadence as an int >= 1."""
    if int(batch) != batch or batch < 1:
        raise ValueError(f"batch must be an integer >= 1, got {batch}")
    return int(batch)


def chunk_launches(n_frames: int, batch: int = 1) -> int:
    """Kernel launches of one chunk (csrc/ncc_mega.cu launch_chunk): one
    cooperative launch, whose blocks walk every scored frame step (t % batch
    == batch - 1) and write every record, whatever the frames and the
    cadence."""
    return 1


def score_grid(blocks_per_sm: int, n_sms: int) -> int:
    """Blocks of a chunk launch: as many as the card holds at once (the
    kernel's blocks per SM at its shared-memory plan, times the SMs), which
    the cooperative launch requires of its grid; two an SM at 80 x 80, one
    for a template staged in chunks."""
    if blocks_per_sm < 1:
        raise RuntimeError(f"the chunk kernel fits {blocks_per_sm} blocks an SM")
    return blocks_per_sm * n_sms


def _table_bytes(table_lanes: int) -> int:
    return -(-table_lanes * _LANE_WORK_BYTES // 16) * 16 if table_lanes > 1 else 0


def score_smem_bytes(rows: int, tw: int, table_lanes: int) -> int:
    """csrc/mega_body.cuh score_smem_bytes: the lane table (none for one
    lane), `rows` centered template rows, their input rows with row sums, and
    both halves' partial correlations and column sums."""
    tw4 = -(-tw // 4) * 4
    in_w = _TILE_W + tw4 + ((16 - (_TILE_W + tw4) % 32) + 32) % 32
    in_h = rows + _TILE_H - 1
    n_out = _TILE_H * _TILE_W
    return _table_bytes(table_lanes) + 4 * (rows * tw4 + in_h * in_w + 2 * in_h * _TILE_W
                                            + 2 * _SPLIT * n_out + 4 * n_out)


def _res_work_floats(th: int, tw: int) -> int:
    """csrc/mega_body.cuh res_work_floats: the longer template half's window
    rows (32-row tiles, the row stride an odd multiple of 4 floats modulo 32),
    their row sums and sums of squares, and 8 shares' partials (32 rows of 16
    outputs, 20 floats apart)."""
    tw4 = -(-tw // 4) * 4
    in_w = _TILE_W + tw4 + (4 if (_TILE_W + tw4) % 8 == 0 else 0)
    in_h = th - th // 2 + _RES_TILE_H - 1
    return in_h * in_w + 2 * in_h * _TILE_W + _SPLIT // 2 * _RES_PART


def resident_smem_bytes(th: int, tw: int, table_lanes: int) -> int:
    """csrc/mega_body.cuh resident_smem_bytes: the lane table, the whole
    template, and the window work of one template half."""
    return _table_bytes(table_lanes) + 4 * (th * (-(-tw // 4) * 4) + _res_work_floats(th, tw))


class Plan(NamedTuple):
    """A launch's shared-memory plan (csrc/mega_body.cuh plan_of): its name
    in PLANS, its dynamic shared memory in bytes and the template rows the
    chunked plan stages at once."""

    name: str
    smem_bytes: int
    stage_rows: int


class MegaGeometry:
    """Static shapes of one chunk and the port's envelope, which is the JAX
    mega kernel's: templates up to 256 x 256, spans up to 512.  A score block
    stages the whole template beside its input tile when it fits in shared
    memory, else chunks of rows (`stage_rows`).

    In K3's bucketed mode `templ_shape` is the shared bucket: it sizes
    shared memory and `stage_rows`, while each object's map, window and
    global search follow its own extent in the kernel's extent table."""

    def __init__(self, frame_shape, templ_shape, config: TrackerConfig):
        self.frame_h, self.frame_w = frame_shape
        self.th, self.tw = templ_shape
        self.out_h = self.frame_h - self.th + 1
        self.out_w = self.frame_w - self.tw + 1
        self.rx, self.ry = config.search_radius_x, config.search_radius_y
        self.span_x, self.span_y = 2 * self.rx + 1, 2 * self.ry + 1

    def stage_rows(self, table_lanes: int = 1) -> int:
        """csrc/mega_body.cuh stage_rows: all th rows when they fit, else the
        fewest equal chunks of the longer half that fit; -1 if none does."""
        if score_smem_bytes(self.th, self.tw, table_lanes) <= SMEM_LIMIT:
            return self.th
        half = self.th - self.th // 2
        for n in range(1, half + 1):
            ck = -(-half // n)
            if score_smem_bytes(ck, self.tw, table_lanes) <= SMEM_LIMIT:
                return ck
        return -1

    def smem_bytes(self, table_lanes: int = 1) -> int:
        return score_smem_bytes(self.stage_rows(table_lanes), self.tw, table_lanes)

    def plan(self, table_lanes: int = 1, passes: int = 0) -> Plan:
        """csrc/mega_body.cuh plan_of: "whole" when the template stages whole;
        else "resident" at float32 (passes 0) when the whole template, the
        longer half's window work, the EMA's patch bytes (where the window
        rows go) and the half's 16-column groups (3 a thread) fit; else
        "chunked".  Raises where not even chunks fit."""
        rows = self.check(table_lanes).stage_rows(table_lanes)
        if rows == self.th:
            return Plan("whole", score_smem_bytes(rows, self.tw, table_lanes), rows)
        tw4 = -(-self.tw // 4) * 4
        in_h = self.th - self.th // 2 + _RES_TILE_H - 1
        fits = (resident_smem_bytes(self.th, self.tw, table_lanes) <= SMEM_LIMIT
                and self.th * ((self.tw + 6) // 4) <= _res_work_floats(self.th, self.tw)
                and in_h * -(-(_TILE_W + tw4) // 16) <= _PRE_SLOTS * _THREADS)
        if passes == 0 and fits:
            return Plan("resident", resident_smem_bytes(self.th, self.tw, table_lanes), rows)
        return Plan("chunked", score_smem_bytes(rows, self.tw, table_lanes), rows)

    def supported(self) -> bool:
        """The JAX mega envelope as a predicate of the geometry alone
        (pvot/ops/ncc_mega.py:148-167): spans and template sides within the
        caps, and a map at least as large as the span.  The serving entry
        points route a geometry outside it to their scan engine.  In the
        bucketed mode the bucket binds, as JAX's `out_*_b` do.  The port's
        shared memory for many lanes is not part of it: `check` raises on
        that."""
        return (self.span_x <= MAX_SPAN and self.span_y <= MAX_SPAN
                and self.th <= MAX_TEMPLATE and self.tw <= MAX_TEMPLATE
                and self.out_h >= self.span_y and self.out_w >= self.span_x)

    def check(self, table_lanes: int = 1) -> "MegaGeometry":
        if self.out_h < 1 or self.out_w < 1:
            raise ValueError(
                f"template {self.th}x{self.tw} larger than frame "
                f"{self.frame_h}x{self.frame_w}"
            )
        if (self.th > MAX_TEMPLATE or self.tw > MAX_TEMPLATE
                or self.span_x > MAX_SPAN or self.span_y > MAX_SPAN):
            raise ValueError(
                f"template {self.th}x{self.tw} with spans {self.span_y}x{self.span_x} "
                f"is outside the mega kernel's envelope (templates up to "
                f"{MAX_TEMPLATE}x{MAX_TEMPLATE}, spans up to {MAX_SPAN}); track it on "
                "the scan engines, track_video(backend=\"shared\") (ROADMAP A4/A10)"
            )
        if self.stage_rows(table_lanes) < 1:
            raise ValueError(
                f"{table_lanes} streams leave no shared memory for the "
                f"{self.th}x{self.tw} template; serve fewer streams a call"
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
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chunk kernel: a per-frame loop of torch
    ops with the kernel's inputs, outputs and arithmetic (the order of each
    sum aside, and the window moments summed in float64: `ncc_scores`)."""
    passes = score_tier(highest, score_passes)
    batch = check_batch(batch)
    n_full = (int(n_valid) // batch) * batch
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
        if batch > 1 and not (t % batch == batch - 1 and t < n_full):
            # The look-ahead record: the state as it stands, nothing scored.
            rows[t] = torch.tensor([*bbox_l, -1.0, 0.0, 0.0, lost, float(useg), 0.0])
            continue
        valid = t < n_valid
        ug, do_global, (ry0, ry1, rx0, rx1) = _frame_mode(g, config, bbox_l, lost, useg, valid)
        if ry1 >= ry0 and rx1 >= rx0:
            region = ensure_gray_f32(frames_u8[t, ry0 : ry1 + th, rx0 : rx1 + tw])
            best_val, bx, by = search_ops.argmax2d(
                ncc_scores(region, tpl - t_mean, t_std, sum_tc, n, passes)
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


def _per_lane(n_valid, k: int) -> list:
    """n_valid as K ints, from a tensor, a sequence or one count for all."""
    values = torch.as_tensor(n_valid).reshape(-1)
    return [int(v) for v in values.expand(k).tolist()]


def mega_track_chunk_multi_reference(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid,
    config: TrackerConfig,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the multi-stream kernel: `mega_track_chunk_reference`
    on each stream with its own state and its own n_valid."""
    n_valid = _per_lane(n_valid, frames_u8.shape[0])
    outs = [
        mega_track_chunk_reference(
            frames_u8[s], bbox[s], template[s], t_mean[s], t_std[s],
            lost_count[s], use_global[s], n_valid[s], config, highest, score_passes, batch,
        )
        for s in range(frames_u8.shape[0])
    ]
    return torch.stack([r for r, _ in outs]), torch.stack([t for _, t in outs])


def object_extents(template: torch.Tensor, bucket_extents=None) -> list:
    """Each object's true template extent (th_k, tw_k) inside the (K, th, tw)
    template buffer: all (th, tw) without `bucket_extents`, else those,
    checked to lie in the bucket."""
    k, th, tw = template.shape
    if bucket_extents is None:
        return [(th, tw)] * k
    extents = [(int(eh), int(ew)) for eh, ew in bucket_extents]
    if len(extents) != k:
        raise ValueError(f"{len(extents)} extents for {k} objects")
    for eh, ew in extents:
        if not (1 <= eh <= th and 1 <= ew <= tw):
            raise ValueError(f"extent {eh}x{ew} does not fit the {th}x{tw} bucket")
    return extents


def mega_track_chunk_objects_reference(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid,
    config: TrackerConfig,
    bucket_extents=None,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the multi-object kernel: `mega_track_chunk_reference`
    for each object on the one shared chunk (F, H, W), with that object's
    state, its n_valid and its template cropped to its true extent; the final
    template goes back into the object's place in the bucket."""
    extents = object_extents(template, bucket_extents)
    n_valid = _per_lane(n_valid, len(extents))
    rows, tpls = [], []
    for i, (eh, ew) in enumerate(extents):
        r, t = mega_track_chunk_reference(
            frames_u8, bbox[i], template[i, :eh, :ew], t_mean[i], t_std[i],
            lost_count[i], use_global[i], n_valid[i], config, highest, score_passes, batch,
        )
        out = template[i].to(torch.float32).clone()
        out[:eh, :ew] = t
        rows.append(r)
        tpls.append(out)
    return torch.stack(rows), torch.stack(tpls)


def _to_device_i32(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A small int32 host tensor on `dev` without a blocking copy: through
    pinned memory to a CUDA device."""
    host = host.to(torch.int32).contiguous()
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


def _n_valid_columns(values, s: int, dev: torch.device, batch: int = 1) -> torch.Tensor:
    """(s, 2) int32 on `dev`, each lane's last frame bound twice (the last two
    state fields), from a tensor, a sequence or one count for all, without a
    blocking copy: a host array goes through pinned memory.  The bound is
    n_valid, or with batch > 1 n_full = (n_valid // batch) * batch: the
    kernels then score only cadence frames, and a frame is valid there only
    below n_full (pvot/ops/ncc_mega.py:899-907)."""
    if isinstance(values, torch.Tensor) and values.device == dev:
        v = values.reshape(-1, 1).expand(s, 2).to(torch.int32)
        return v if batch == 1 else torch.div(v, batch, rounding_mode="floor") * batch
    host = torch.as_tensor(values).reshape(-1, 1).expand(s, 1).to(torch.int32)
    host = torch.div(host, batch, rounding_mode="floor") * batch
    if bool((host == host[0]).all()):
        return torch.full((s, 2), int(host[0]), dtype=torch.int32, device=dev)
    return _to_device_i32(host.expand(s, 2), dev)


class Launch(NamedTuple):
    """A chunk launch's outputs on the card: the CUDA error code, the records
    (S, F, 10), and the template (S, th, round_up4(tw)) and state (S, 8)
    int32 and (S, 4) float32 after the chunk, from whichever of the kernel's
    two buffers holds them."""

    err: int
    rows: torch.Tensor
    template: torch.Tensor
    state_i: torch.Tensor
    state_f: torch.Tensor


def _grid_blocks(lib, dev: torch.device, th: int, tw: int, n_lanes: int, ext: bool,
                 passes: int, rung=None) -> int:
    """`score_grid` of the kernel a launch runs on `dev` (a rung's for the
    ladder), from the card's occupancy of it."""
    per_sm = (lib.pvot_mega_score_blocks_per_sm(th, tw, n_lanes, int(ext), passes)
              if rung is None else lib.pvot_mega_breakdown_blocks_per_sm(rung, th, tw, passes))
    return score_grid(per_sm, torch.cuda.get_device_properties(dev).multi_processor_count)


def _launch(lib, entry: str, frames: torch.Tensor, bbox, template, t_mean, t_std,
            lost_count, use_global, n_valid, config: TrackerConfig, stream, extents=None,
            passes: int = 0, batch: int = 1, rung=None, clock=None) -> Launch:
    """Run one C entry ("one", "multi" or "objects") on S lanes: frames (S, F,
    H, W) u8, each lane's frames contiguous, lanes `frames.stride(0)` apart (0
    for objects); the states stacked on S, all on frames' device.  extents:
    each lane's true (th, tw) in the template buffer (default: all of it);
    objects whose extents differ get them as the kernel's extent table.
    passes: the score tier (0 float32, 1-3 bf16 passes); batch: the cadence.
    rung ("one" only): a stage of K1's rung ladder
    (pvot_torch.tools.mega_breakdown) in place of K1's production kernel.
    clock ("multi" only): the step clock's int64 slots, or None."""
    s, f, h, w = frames.shape
    th, tw = template.shape[-2:]
    extents = extents or [(th, tw)] * s
    mixed = entry == "objects" and any(e != (th, tw) for e in extents)
    dev = frames.device
    i32, fl = torch.int32, torch.float32
    # state_i = [bx, by, bw, bh, lost, use_global, n_valid, _] per lane (the
    # last field is padding); one cat, its int32 result promoted from the
    # int32 and bool parts.  These few small ops run once per chunk.
    state_i = torch.cat([
        bbox.reshape(s, 4), lost_count.reshape(s, 1), use_global.reshape(s, 1),
        _n_valid_columns(n_valid, s, dev, batch),
    ], dim=1).to(i32)
    tpl = template.reshape(s, th, tw).to(fl)
    tm = t_mean.reshape(s).to(fl)
    # sum_tc one lane at a time over its true extent, so that a lane's inputs,
    # and so its records, are those of the lane alone (K1 on its template).
    sum_tc = torch.stack([torch.sum(tpl[i, :eh, :ew].contiguous() - tm[i])
                          for i, (eh, ew) in enumerate(extents)])
    # state_f = [t_mean, t_std, sum_tc, _] per lane (the last field is padding).
    state_f = torch.stack([tm, t_std.reshape(s).to(fl), sum_tc, sum_tc], dim=1)
    # The kernel reads the templates in their own buffer with the rows padded
    # to a multiple of 4 columns (float4 loads); the padding columns are 0.
    tpl_pad = (torch.empty if tw % 4 == 0 else torch.zeros)(
        (s, th, tw + (-tw % 4)), dtype=fl, device=dev)
    tpl_pad[:, :, :tw] = tpl
    # The second buffers of the state and the template (by step parity), the
    # records, and the scratch (winners, partials, counters).
    state_i2, state_f2 = torch.empty_like(state_i), torch.empty_like(state_f)
    tpl2 = torch.zeros_like(tpl_pad)
    rows = torch.empty((s, f, N_LANES), dtype=fl, device=dev)
    n_blocks = _grid_blocks(lib, dev, th, tw, s, mixed, passes, rung)
    work = torch.empty(lib.pvot_mega_work_bytes(s, n_blocks), dtype=torch.uint8, device=dev)
    lr = float(config.template_update_lr)
    buffers = (state_i.data_ptr(), state_f.data_ptr(), tpl_pad.data_ptr(), state_i2.data_ptr(),
               state_f2.data_ptr(), tpl2.data_ptr(), work.data_ptr(), n_blocks,
               rows.data_ptr(), config.search_radius_x, config.search_radius_y,
               config.lost_frame_threshold, int(config.enable_global_search),
               f32(config.min_confidence), f32(config.global_confidence),
               f32(config.strong_confidence), f32(lr), f32(1.0 - lr), passes, batch, stream)
    if entry == "objects":
        ext = _to_device_i32(torch.tensor(extents), dev) if mixed else None
        err = lib.pvot_mega_track_chunk_objects(
            frames.data_ptr(), s, f, h, w, th, tw, None if ext is None else ext.data_ptr(),
            *buffers)
    elif entry == "multi":
        err = lib.pvot_mega_track_chunk_multi(frames.data_ptr(), frames.stride(0), s, f, h, w,
                                              th, tw, *buffers,
                                              None if clock is None else clock.data_ptr())
    else:
        args = (frames.data_ptr(), f, h, w, th, tw, *buffers)
        err = (lib.pvot_mega_track_chunk(*args) if rung is None
               else lib.pvot_mega_breakdown_chunk(rung, *args))
    if (f // batch) % 2:  # an odd number of steps ends in the second buffers
        return Launch(err, rows, tpl2, state_i2, state_f2)
    return Launch(err, rows, tpl_pad, state_i, state_f)


def _check_cuda_inputs(frames_u8: torch.Tensor, ndim: int, states) -> None:
    if frames_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != ndim:
        raise ValueError(f"expected {ndim}-d uint8 frames, got {frames_u8.dtype} "
                         f"{tuple(frames_u8.shape)}")
    for name, v in states.items():
        if v.device != frames_u8.device:
            raise ValueError(f"{name} on {v.device}, frames on {frames_u8.device}")


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
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track one chunk of frames (F, H, W) uint8 from the given state, at the
    score tier (highest, score_passes) and the batch cadence of the module
    docstring.

    On a CUDA device: one cooperative launch on the current stream
    (`chunk_launches`), whatever F and the batch, no host synchronisation;
    it raises if the card refuses it.  `mega_track_chunk.launches` grows by
    1, and so do `mega_track_chunk.launches_by_tier[p]` for the tier's pass
    count p (0: float32) and `mega_track_chunk.launches_by_plan[name]` for
    the kernel's shared-memory plan (`MegaGeometry.plan`).  On the CPU: the
    plain version.  Frames past `n_valid` commit nothing."""
    with timing.span("pvot.chunk"):
        passes = score_tier(highest, score_passes)
        batch = check_batch(batch)
        if frames_u8.device.type == "cpu":
            return mega_track_chunk_reference(
                frames_u8, bbox, template, t_mean, t_std, lost_count, use_global,
                n_valid, config, highest, score_passes, batch,
            )
        _check_cuda_inputs(frames_u8, 3, dict(
            bbox=bbox, template=template, t_mean=t_mean, t_std=t_std,
            lost_count=lost_count, use_global=use_global))
        frames_u8 = frames_u8.contiguous()
        f, h, w = frames_u8.shape
        th, tw = template.shape
        plan = MegaGeometry((h, w), (th, tw), config).plan(1, passes).name
        from pvot_torch.ops import _build

        lib = _build.load_library()
        dev = frames_u8.device
        with torch.cuda.device(dev):
            out = _launch(
                lib, "one", frames_u8[None], bbox, template, t_mean, t_std, lost_count,
                use_global, [int(n_valid)], config, torch.cuda.current_stream(dev).cuda_stream,
                passes=passes, batch=batch,
            )
            _build.check(out.err, "mega_track_chunk")
            _count(mega_track_chunk, chunk_launches(f, batch), passes, plan)
        return out.rows[0], out.template[0, :, :tw].contiguous()


def _count(wrapper, n: int, passes: int, plan: str) -> None:
    """Add a call's launches to its wrapper's counters: all, by tier, and by
    the kernel's shared-memory plan (`MegaGeometry.plan`)."""
    wrapper.launches += n
    wrapper.launches_by_tier[passes] += n
    wrapper.launches_by_plan[plan] += n


def reset_launches(*wrappers) -> None:
    """Set the wrappers' launch counters to 0."""
    for w in wrappers:
        w.launches = 0
        w.launches_by_tier = dict.fromkeys(range(4), 0)
        w.launches_by_plan = dict.fromkeys(PLANS, 0)


reset_launches(mega_track_chunk)


def mega_track_chunk_multi(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid,
    config: TrackerConfig,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
    clock=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track one chunk of S independent streams: frames (S, F, H, W) uint8
    (each stream's frames contiguous; the stream axis may have any stride),
    bbox (S, 4), template (S, th, tw), t_mean, t_std, lost_count, use_global
    and n_valid (S,).  Frames t >= n_valid[s] commit nothing for stream s.

    Tier and cadence as in `mega_track_chunk`.  On a CUDA device: one
    cooperative launch on the current stream whatever S, F and the batch are
    (`chunk_launches`), no host synchronisation; the counters of
    `mega_track_chunk_multi` grow as K1's do.  At every frame step each block
    grid-strides over all streams' tiles, so a stream in re-acquisition gets
    the whole card.  clock: None, or, for S >= 2, F // batch + 1 int64 slots
    on the frames' device (`timing.clock_buffer`, given only while a
    profiler session is on): the launch then runs the kernel's clocked twin
    (csrc/mega_clock.cu), which stamps its step clock into them
    (`timing.StepClock` says which step each interval holds); with None the
    kernel has no clock code.  On the CPU: the plain version, which has no
    clock."""
    with timing.span("pvot.chunk"):
        passes = score_tier(highest, score_passes)
        batch = check_batch(batch)
        if frames_u8.device.type == "cpu":
            return mega_track_chunk_multi_reference(
                frames_u8, bbox, template, t_mean, t_std, lost_count, use_global,
                n_valid, config, highest, score_passes, batch,
            )
        _check_cuda_inputs(frames_u8, 4, dict(
            bbox=bbox, template=template, t_mean=t_mean, t_std=t_std,
            lost_count=lost_count, use_global=use_global))
        s, f, h, w = frames_u8.shape
        if frames_u8.stride()[1:] != (h * w, w, 1):
            frames_u8 = frames_u8.contiguous()
        th, tw = template.shape[-2:]
        if template.shape[0] != s or bbox.shape != (s, 4):
            raise ValueError(f"states for {template.shape[0]} streams, frames for {s}")
        if clock is not None and (clock.dtype != torch.int64 or clock.device != frames_u8.device
                                  or clock.shape != (f // batch + 1,)
                                  or not clock.is_contiguous() or s < 2):
            raise ValueError(f"the step clock needs two streams or more and {f // batch + 1} "
                             f"contiguous int64 slots on {frames_u8.device}, got {s} streams "
                             f"and {clock.dtype} {tuple(clock.shape)} on {clock.device}")
        plan = MegaGeometry((h, w), (th, tw), config).plan(s, passes).name
        from pvot_torch.ops import _build

        lib = _build.load_library()
        dev = frames_u8.device
        with torch.cuda.device(dev):
            out = _launch(
                lib, "multi", frames_u8, bbox, template, t_mean, t_std, lost_count,
                use_global, n_valid, config, torch.cuda.current_stream(dev).cuda_stream,
                passes=passes, batch=batch, clock=clock,
            )
            _build.check(out.err, "mega_track_chunk_multi")
            _count(mega_track_chunk_multi, chunk_launches(f, batch), passes, plan)
        return out.rows, out.template[:, :, :tw].contiguous()


reset_launches(mega_track_chunk_multi)


def mega_track_chunk_objects(
    frames_u8: torch.Tensor,
    bbox: torch.Tensor,
    template: torch.Tensor,
    t_mean: torch.Tensor,
    t_std: torch.Tensor,
    lost_count: torch.Tensor,
    use_global: torch.Tensor,
    n_valid,
    config: TrackerConfig,
    bucket_extents=None,
    highest: bool = True,
    score_passes: int = 3,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track K objects through one chunk of ONE clip: frames (F, H, W) uint8
    read by every object; bbox (K, 4), template (K, th, tw), t_mean, t_std,
    lost_count, use_global and n_valid (K,) (or one n_valid for all).
    bucket_extents: each object's true (th_k, tw_k) when the templates are
    zero-padded into a shared (th, tw) bucket (the bucketed layout of
    pvot_torch.parallel.multi.init_multi_state_bucketed); each object then
    tracks exactly as `mega_track_chunk` on its own th_k x tw_k template, and
    only that corner of its template changes.

    Tier and cadence as in `mega_track_chunk`.  On a CUDA device: one
    cooperative launch on the current stream whatever K, F and the batch are
    (`chunk_launches`), no host synchronisation; the counters of
    `mega_track_chunk_objects` grow as K1's do.  On the CPU: the plain
    version."""
    with timing.span("pvot.chunk"):
        passes = score_tier(highest, score_passes)
        batch = check_batch(batch)
        extents = object_extents(template, bucket_extents)
        if frames_u8.device.type == "cpu":
            return mega_track_chunk_objects_reference(
                frames_u8, bbox, template, t_mean, t_std, lost_count, use_global,
                n_valid, config, bucket_extents, highest, score_passes, batch,
            )
        _check_cuda_inputs(frames_u8, 3, dict(
            bbox=bbox, template=template, t_mean=t_mean, t_std=t_std,
            lost_count=lost_count, use_global=use_global))
        frames_u8 = frames_u8.contiguous()
        f, h, w = frames_u8.shape
        k = len(extents)
        if bbox.shape != (k, 4):
            raise ValueError(f"bbox {tuple(bbox.shape)} for {k} objects")
        # The kernel's buffer is the smallest bucket that holds every object; a
        # set whose objects all share one extent runs without an extent table.
        bh, bw = max(e[0] for e in extents), max(e[1] for e in extents)
        plan = MegaGeometry((h, w), (bh, bw), config).plan(k, passes).name
        from pvot_torch.ops import _build

        lib = _build.load_library()
        dev = frames_u8.device
        with torch.cuda.device(dev):
            out = _launch(
                lib, "objects", frames_u8.expand(k, f, h, w), bbox, template[:, :bh, :bw],
                t_mean, t_std, lost_count, use_global, n_valid, config,
                torch.cuda.current_stream(dev).cuda_stream, extents=extents,
                passes=passes, batch=batch,
            )
            _build.check(out.err, "mega_track_chunk_objects")
            _count(mega_track_chunk_objects, chunk_launches(f, batch), passes, plan)
        if (bh, bw) == tuple(template.shape[-2:]):
            return out.rows, out.template[:, :, :bw].contiguous()
        full = template.to(torch.float32).clone()
        full[:, :bh, :bw] = out.template[:, :, :bw]
        return out.rows, full


reset_launches(mega_track_chunk_objects)
