"""Dense NCC maps (K4) and the fused region argmax (K5): the port of
pvot/ops/ncc_pallas.py `_ncc_pallas_padded` (:406) and `_ncc_argmax_padded`
(:531) with their entries `ncc_map_pallas` (:424), `ncc_map_pallas_batched`
(:629), `ncc_region_argmax_pallas` (:554) and the backend adapters
`pallas_full_fn` / `pallas_region_fn` / `pallas_region_argmax_fn`
(:785-848), at both of their tiers.

On a CUDA tensor the wrappers launch the hand-written kernels of
pvot_torch/csrc/ncc_pallas.cu (one launch a call, for every lane of it) or
raise; on a CPU tensor they run the plain PyTorch versions beside them
(`..._reference`).  The shear and operator forms of the JAX kernel compute
the same scores, so `shear` selects nothing here.  `highest=False` is the
`pallas_fast` tier, `_dot_hl3` (pvot/ops/ncc_pallas.py:63-87, :137-147): the
correlation as 3 bf16 passes, corr(hi w, hi t) + corr(hi w, lo t) + corr(lo
w, hi t), on the tensor cores (the lane functions' `passes=3`); the window
moments and the epilogue stay float32.  `pallas_full_fn` scores float32
whatever it is asked, as JAX's full maps do (pvot/ops/backends.py:212-214).

Lanes.  `ncc_map_lanes` and `region_argmax_lanes` score L lanes in one
launch: lane l reads images[l] (or the one image for all when images has
one), its template templates[l] (or the one for all) and its stats, from
its origin in the image.  That is one frame, N frames against one template
(the batched form), K objects on one frame, or S streams each on its own.
`ncc_map_pallas.launches` and `ncc_region_argmax_pallas.launches` count the
kernels' launches, whichever entry made them, and their `launches_by_tier`
split the count by pass count (0: float32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.ncc_mega import reset_launches
from pvot_torch.ops.ncc_reference import ncc_scores, template_stats

_LANE_INTS = 6  # x0, y0, rx0, rx1, ry0, ry1 (csrc/ncc_pallas.cu kLane)
_TILE_H, _TILE_W = 8, 16  # K5's tile (csrc/ncc_pallas.cu kTileH for kArgmax, kTileW)
_GROUPS = 8  # template-row groups, a warp each (kGroups)
_PARENT_BUDGET = 110 * 1024  # the plan whose chunk rows fix the sums (kParentBudget)
_TWO_BLOCKS = 115_712  # shared-memory bytes a block, two blocks an SM (kTwoBlocks)
_STATIC_BYTES = 256  # the kernel's static shared memory, rounded up (kStaticBytes)
FAST_PASSES = 3  # the `pallas_fast` tier, `_dot_hl3`


def tier_passes(highest: bool) -> int:
    """The pass count of a K4/K5 tier: 0 (float32) or 3 (`_dot_hl3`)."""
    return 0 if highest else FAST_PASSES


def _check_passes(passes: int) -> int:
    if passes not in (0, FAST_PASSES):
        raise ValueError(f"K4/K5 score at 0 (float32) or {FAST_PASSES} passes, not {passes}")
    return passes


def _as_lanes(t: torch.Tensor, n: int, item_ndim: int, name: str) -> torch.Tensor:
    """(n, ...) view of a per-lane stack, or of one item shared by all lanes
    (no lane axis, or a lane axis of 1), expanded with stride 0."""
    if t.ndim == item_ndim:
        t = t[None]
    if t.shape[0] not in (1, n):
        raise ValueError(f"{name}: {t.shape[0]} lanes for {n}")
    return t.expand(n, *t.shape[1:])


def _scores_plain(image: torch.Tensor, templ: torch.Tensor, t_mean, t_std, x0: int, y0: int,
                  out_h: int, out_w: int, passes: int = 0) -> torch.Tensor:
    """One lane's (out_h, out_w) scores from its origin in `image`, pixels
    past the image read 0, at the tier `passes`."""
    th, tw = templ.shape
    region = ensure_gray_f32(image[y0 : y0 + out_h + th - 1, x0 : x0 + out_w + tw - 1])
    pad_h, pad_w = out_h + th - 1 - region.shape[0], out_w + tw - 1 - region.shape[1]
    if pad_h or pad_w:
        region = torch.nn.functional.pad(region, (0, pad_w, 0, pad_h))
    templ = templ.to(torch.float32)
    tc = templ - t_mean
    return ncc_scores(region, tc, t_std, torch.sum(tc), float(th * tw), passes)


def ncc_map_lanes_reference(images, templates, t_mean, t_std, origins=None, out_shape=None,
                            passes: int = 0):
    """Plain version of `ncc_map_lanes`: each lane's map by torch ops."""
    _check_passes(passes)
    n, th, tw, out_h, out_w, origins = _lane_geometry(images, templates, origins, out_shape)
    images = _as_lanes(images, n, 2, "images")
    templates = _as_lanes(templates, n, 2, "templates")
    t_mean = _as_lanes(t_mean.reshape(-1), n, 0, "t_mean")
    t_std = _as_lanes(t_std.reshape(-1), n, 0, "t_std")
    return torch.stack([
        _scores_plain(images[l], templates[l], t_mean[l], t_std[l], *origins[l], out_h, out_w,
                      passes)
        for l in range(n)
    ])


def region_argmax_lanes_reference(images, templates, t_mean, t_std, lanes, span,
                                  passes: int = 0):
    """Plain version of `region_argmax_lanes`: each lane's region scores by
    torch ops, masked to its window, argmax by row-major first occurrence."""
    scores = ncc_map_lanes_reference(images, templates, t_mean, t_std,
                                     [(x0, y0) for x0, y0, *_ in lanes], span, passes)
    rows = []
    for l, (x0, y0, rx0, rx1, ry0, ry1) in enumerate(lanes):
        bounds = search_ops.WindowBounds(x0 + rx0, x0 + rx1, y0 + ry0, y0 + ry1)
        rows.append(search_ops.masked_region_best(scores[l], x0, y0, bounds))
    return torch.stack(rows)


def _lane_geometry(images, templates, origins, out_shape):
    """(lanes, th, tw, out_h, out_w, origins) of a lane call."""
    n = max(images.shape[0] if images.ndim == 3 else 1,
            templates.shape[0] if templates.ndim == 3 else 1)
    if origins is not None:
        n = max(n, len(origins))
    th, tw = templates.shape[-2:]
    h, w = images.shape[-2:]
    out_h, out_w = out_shape if out_shape is not None else (h - th + 1, w - tw + 1)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"template {th}x{tw} larger than image {h}x{w}")
    origins = [(0, 0)] * n if origins is None else [(int(x), int(y)) for x, y in origins]
    if len(origins) != n:
        raise ValueError(f"{len(origins)} origins for {n} lanes")
    _check_origins(origins)
    return n, th, tw, out_h, out_w, origins


def _check_origins(origins) -> None:
    """Origins lie in the image's quadrant: the kernels read pixels from
    them without a lower bound check."""
    if any(x < 0 or y < 0 for x, y in origins):
        raise ValueError(f"negative region origin in {list(origins)}")


def _lane_ints(rows: Sequence[Sequence[int]], dev: torch.device) -> torch.Tensor:
    """(L, 6) int32 on `dev`, through pinned memory for a CUDA device."""
    host = torch.tensor([list(r) + [0] * (_LANE_INTS - len(r)) for r in rows], dtype=torch.int32)
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


class NccPlan(NamedTuple):
    """A K4/K5 launch plan (csrc/ncc_pallas.cu): output rows a tile, the
    template rows of a chunk (the parent's `chunk_rows`, which fix the order
    of the sums) and the block's dynamic shared-memory bytes."""

    tile_h: int
    chunk_rows: int
    smem_bytes: int


def _parent_in_stride(tw4: int) -> int:
    return _TILE_W + tw4 + ((16 - (_TILE_W + tw4) % 32) + 32) % 32


def chunk_rows(th: int, tw: int) -> int:
    """Template rows a chunk holds: all th when the parent's plan (8-row
    tiles) fits its 110 KB budget, else the most that do; -1 if not one row
    does (csrc/ncc_pallas.cu `chunk_rows`, in closed form)."""
    tw4 = -(-tw // 4) * 4
    per_row = 4 * (tw4 + _parent_in_stride(tw4) + 2 * _TILE_W)
    fixed = 4 * (7 * (_parent_in_stride(tw4) + 2 * _TILE_W) + _GROUPS * 8 * _TILE_W)
    return min(th, (_PARENT_BUDGET - fixed) // per_row) if fixed + per_row <= _PARENT_BUDGET else -1


def _in_stride(tw4: int, tile_h: int, passes: int) -> int:
    if tile_h == 8:
        return _parent_in_stride(tw4)
    want = 4 if passes == 0 else 8
    return _TILE_W + tw4 + ((want - (_TILE_W + tw4) % 32) + 32) % 32


def _smem_bytes(rows: int, tw: int, tile_h: int, passes: int) -> int:
    tw4 = -(-tw // 4) * 4
    in_rows = rows + tile_h - 1
    return 4 * (rows * tw4 + in_rows * _in_stride(tw4, tile_h, passes) + 2 * in_rows * _TILE_W
                + _GROUPS * tile_h * _TILE_W)


def ncc_plan(th: int, tw: int, argmax: bool, passes: int = 0) -> NccPlan:
    """The launch plan of K5 (argmax) or K4 for a th x tw template at the
    tier `passes`, as csrc/ncc_pallas.cu computes it (`pvot_ncc_plan`): K5
    8-row tiles; K4 16-row tiles where their plan fits two blocks an SM, else
    8-row ones.  Raises ValueError where not one template row fits."""
    rows = chunk_rows(th, tw)
    if rows < 1:
        raise ValueError(f"template {th}x{tw}: not one row fits the kernel's shared memory")
    tile_h = 8
    if not argmax and _smem_bytes(rows, tw, 16, passes) + _STATIC_BYTES <= _TWO_BLOCKS:
        tile_h = 16
    return NccPlan(tile_h, rows, _smem_bytes(rows, tw, tile_h, passes))


def _launch_args(images, templates, t_mean, t_std, n: int):
    """Checked kernel operands: (images, lane stride, templates, template
    stride, t_mean, t_std, stat stride, u8 flag).  No copy where the
    operands are already float32 with unit or stride-0 lanes."""
    dev = images.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, v in (("templates", templates), ("t_mean", t_mean), ("t_std", t_std)):
        if v.device != dev:
            raise ValueError(f"{name} on {v.device}, images on {dev}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"images must be uint8 or float32, got {images.dtype}")
    images = _as_lanes(images, n, 2, "images")
    if images.stride(-1) != 1:
        images = images.contiguous()
    templates = _as_lanes(templates.to(torch.float32), n, 2, "templates")
    if templates.stride(0) == 0:  # one template for every lane
        templates, tpl_stride = templates[0].contiguous()[None], 0
    else:
        templates = templates.contiguous()
        tpl_stride = templates.stride(0)
    stats = [_as_lanes(v.reshape(-1).to(torch.float32), n, 0, name)
             for name, v in (("t_mean", t_mean), ("t_std", t_std))]
    if stats[0].stride(0) != stats[1].stride(0):  # one stride for both: lay them out alike
        stats = [v.contiguous() for v in stats]
    return (images, images.stride(0), templates, tpl_stride, stats[0], stats[1],
            stats[0].stride(0), int(images.dtype == torch.uint8))


def _scratch(dev: torch.device, stream: int, n: int, n_tiles: int):
    """K5's scratch (part_val, part_yx, done) for n lanes of n_tiles tiles on
    `stream`, made once per device, stream and shape: the kernel leaves
    `done` at zero after every launch, and the launches of one stream run in
    order."""
    key = (dev, stream, n, n_tiles)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = (torch.empty(n * n_tiles, dtype=torch.float32, device=dev),
                torch.empty(2 * n * n_tiles, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
        _SCRATCH[key] = bufs
    return bufs


_SCRATCH: dict = {}


def ncc_map_lanes(images, templates, t_mean, t_std, origins: Optional[Sequence] = None,
                  out_shape: Optional[Tuple[int, int]] = None, passes: int = 0) -> torch.Tensor:
    """K4 over L lanes: (L, out_h, out_w) float32 scores at the tier `passes`
    (0: float32, 3: `_dot_hl3`).

    images (L or 1, H, W) or (H, W), uint8 or float32, rows contiguous;
    templates (L or 1, th, tw) or (th, tw); t_mean, t_std (L,), (1,) or 0-d.
    origins: each lane's (x0, y0) in its image (default (0, 0)); out_shape:
    the positions each lane scores (default the valid map, (H - th + 1, W -
    tw + 1)).  Pixels past the image read 0.  On a CUDA device: one launch,
    no synchronisation; `ncc_map_pallas.launches` grows by 1."""
    _check_passes(passes)
    n, th, tw, out_h, out_w, origins = _lane_geometry(images, templates, origins, out_shape)
    if images.device.type == "cpu":
        return ncc_map_lanes_reference(images, templates, t_mean, t_std, origins,
                                       (out_h, out_w), passes)
    images, lane_stride, templates, tpl_stride, t_mean, t_std, stat_stride, u8 = _launch_args(
        images, templates, t_mean, t_std, n)
    from pvot_torch.ops import _build

    lib = _build.load_library()
    dev = images.device
    h, w = images.shape[-2:]
    with torch.cuda.device(dev):
        lanes = None if all(o == (0, 0) for o in origins) else _lane_ints(origins, dev)
        out = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
        err = lib.pvot_ncc_map(
            images.data_ptr(), u8, h, w, images.stride(-2), lane_stride,
            None if lanes is None else lanes.data_ptr(), n, out_h, out_w,
            templates.data_ptr(), tpl_stride, th, tw, t_mean.data_ptr(), t_std.data_ptr(),
            stat_stride, out.data_ptr(), passes, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "ncc_map_pallas")
        ncc_map_pallas.launches += 1
        ncc_map_pallas.launches_by_tier[passes] += 1
    return out


def region_argmax_lanes(images, templates, t_mean, t_std, lanes: Sequence[Sequence[int]],
                        span: Tuple[int, int], passes: int = 0) -> torch.Tensor:
    """K5 over L lanes: (L, 3) float32 rows (best value, x, y), x and y in the
    image's (map) coordinates, exact in float32; scores at the tier
    `passes`, as in `ncc_map_lanes`.

    lanes: per lane (x0, y0, rx0, rx1, ry0, ry1): the region origin in the
    image and the window in region coordinates, inclusive.  span: (span_y,
    span_x), the positions of each region.  The region is read in place from
    the image; positions outside the window score -inf, and ties go to the
    smallest y, then x.  On a CUDA device: one copy of the lane ints and one
    launch, no synchronisation (the scratch is kept per device, stream and
    shape); `ncc_region_argmax_pallas.launches` grows by 1."""
    if images.device.type == "cpu":
        _check_passes(passes)
        _check_origins([(x0, y0) for x0, y0, *_ in lanes])
        return region_argmax_lanes_reference(images, templates, t_mean, t_std, lanes, span,
                                             passes)
    call = region_argmax_operands(images, templates, t_mean, t_std, lanes, span, passes)
    launch_region_argmax(call)
    return call.out


class K5Call(NamedTuple):
    """One K5 launch's operands: the C entry's arguments before the stream
    (`args`, pointers into `keep`), its output rows, its tier and the stream
    whose scratch it holds."""

    args: tuple
    out: torch.Tensor
    passes: int
    stream: int
    keep: tuple


def region_argmax_operands(images, templates, t_mean, t_std, lanes: Sequence[Sequence[int]],
                           span: Tuple[int, int], passes: int = 0) -> K5Call:
    """K5's checked operands for CUDA tensors (`region_argmax_lanes`'
    arguments): the lane ints copied to the card, the output rows made and
    the scratch of the current stream found; no launch."""
    _check_passes(passes)
    _check_origins([(x0, y0) for x0, y0, *_ in lanes])
    out_h, out_w = span
    n = len(lanes)
    images, lane_stride, templates, tpl_stride, t_mean, t_std, stat_stride, u8 = _launch_args(
        images, templates, t_mean, t_std, n)
    th, tw = templates.shape[-2:]
    dev = images.device
    h, w = images.shape[-2:]
    n_tiles = -(-out_h // _TILE_H) * -(-out_w // _TILE_W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lane_t = _lane_ints(lanes, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    part_val, part_yx, done = _scratch(dev, stream, n, n_tiles)
    args = (images.data_ptr(), u8, h, w, images.stride(-2), lane_stride, lane_t.data_ptr(), n,
            out_h, out_w, templates.data_ptr(), tpl_stride, th, tw, t_mean.data_ptr(),
            t_std.data_ptr(), stat_stride, out.data_ptr(), part_val.data_ptr(),
            part_yx.data_ptr(), done.data_ptr(), passes)
    return K5Call(args, out, passes, stream, (images, templates, t_mean, t_std, lane_t,
                                              part_val, part_yx, done))


def launch_region_argmax(call: K5Call) -> None:
    """Launch K5 on `call`'s operands on their device and stream, and count
    it."""
    from pvot_torch.ops import _build

    with torch.cuda.device(call.out.device):
        err = _build.load_library().pvot_ncc_region_argmax(*call.args, call.stream)
    _build.check(err, "ncc_region_argmax_pallas")
    ncc_region_argmax_pallas.launches += 1
    ncc_region_argmax_pallas.launches_by_tier[call.passes] += 1


def _stats(templ, t_mean, t_std):
    templ = templ.to(torch.float32)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats(templ)
    return templ, t_mean, t_std


def ncc_map_pallas_reference(img, templ, t_mean=None, t_std=None,
                             highest: bool = True) -> torch.Tensor:
    """Plain version of `ncc_map_pallas`."""
    templ, t_mean, t_std = _stats(templ, t_mean, t_std)
    return ncc_map_lanes_reference(img, templ, t_mean, t_std, passes=tier_passes(highest))[0]


def ncc_map_pallas(img, templ, t_mean=None, t_std=None, highest: bool = True,
                   shear: bool = False) -> torch.Tensor:
    """Full valid-mode NCC map: img (H, W) uint8 or float32, templ (th, tw)
    -> (H - th + 1, W - tw + 1) float32, with the reference's epsilons
    (pvot/ops/ncc_pallas.py:424); highest=False scores at 3 bf16 passes."""
    del shear
    templ, t_mean, t_std = _stats(templ, t_mean, t_std)
    return ncc_map_lanes(img, templ, t_mean, t_std, passes=tier_passes(highest))[0]


def ncc_map_pallas_batched(frames, templ) -> torch.Tensor:
    """N frames (N, H, W) against one template snapshot in one launch
    (pvot/ops/ncc_pallas.py:629) -> (N, H - th + 1, W - tw + 1)."""
    templ, t_mean, t_std = _stats(templ, None, None)
    return ncc_map_lanes(frames, templ, t_mean, t_std)


def ncc_region_argmax_pallas_reference(region, templ, bounds, x0: int, y0: int, t_mean=None,
                                       t_std=None, highest: bool = True):
    """Plain version of `ncc_region_argmax_pallas`."""
    templ, t_mean, t_std = _stats(templ, t_mean, t_std)
    return _unpack(_region_argmax(region, templ, t_mean, t_std, bounds, x0, y0,
                                  region_argmax_lanes_reference, tier_passes(highest)))


def ncc_region_argmax_pallas(region, templ, bounds, x0: int, y0: int, t_mean=None, t_std=None,
                             highest: bool = True, shear: bool = False):
    """Fused scores + window mask + argmax over a candidate region
    (pvot/ops/ncc_pallas.py:554): region (span_y + th - 1, span_x + tw - 1)
    uint8/float32, bounds a WindowBounds in map coordinates, (x0, y0) the
    region's origin in the map.  Returns (best_val float32, x, y int32)
    0-d tensors in map coordinates; an all-masked window gives (-inf, x0,
    y0).  highest=False scores at 3 bf16 passes."""
    del shear
    templ, t_mean, t_std = _stats(templ, t_mean, t_std)
    return _unpack(_region_argmax(region, templ, t_mean, t_std, bounds, x0, y0,
                                  region_argmax_lanes, tier_passes(highest)))


reset_launches(ncc_map_pallas, ncc_region_argmax_pallas)


def _region_argmax(region, templ, t_mean, t_std, bounds, x0, y0, fn, passes):
    th, tw = templ.shape
    span = (region.shape[0] - th + 1, region.shape[1] - tw + 1)
    lane = (0, 0, bounds.min_tx - x0, bounds.max_tx - x0, bounds.min_ty - y0,
            bounds.max_ty - y0)
    row = fn(region, templ, t_mean, t_std, [lane], span, passes)[0]
    return torch.stack([row[0], row[1] + x0, row[2] + y0])


def _unpack(row: torch.Tensor):
    return row[0], row[1].to(torch.int32), row[2].to(torch.int32)


# --- Backend adapters (pvot/ops/ncc_pallas.py:785-848).  The port's engine
# callables take host ints for origins and windows; region_argmax_fn returns
# the (3,) float32 row (best value, x, y) on the frame's device, which the
# step reads once.


def pallas_full_fn(frame_shape, templ_shape, highest: bool = True, shear: bool = False):
    """Full-map callable (frame, templ, t_mean, t_std) -> map, float32 at
    either tier: the fast engine's global maps stay float32
    (pvot/ops/backends.py:212-214)."""
    del frame_shape, templ_shape, shear, highest

    def full_fn(frame, templ, t_mean, t_std):
        return ncc_map_lanes(frame, templ, t_mean, t_std)[0]

    return full_fn


def pallas_region_fn(frame_shape, templ_shape, span_shape, highest: bool = True,
                     shear: bool = False):
    """Region scorer (frame, templ, t_mean, t_std, x0, y0) -> (span_y,
    span_x) scores, read in place from the frame at (x0, y0), at the tier
    `highest` selects."""
    del frame_shape, templ_shape, shear
    passes = tier_passes(highest)

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        return ncc_map_lanes(frame, templ, t_mean, t_std, [(x0, y0)], span_shape, passes)[0]

    return region_fn


def pallas_region_argmax_fn(frame_shape, templ_shape, span_shape, highest: bool = True,
                            shear: bool = False):
    """Fused region scorer + masked argmax (frame, templ, t_mean, t_std, x0,
    y0, bounds) -> (3,) row (best value, x, y) in map coordinates, at the tier
    `highest` selects."""
    del frame_shape, templ_shape, shear
    passes = tier_passes(highest)

    def region_argmax_fn(frame, templ, t_mean, t_std, x0, y0, bounds):
        lane = (x0, y0, bounds.min_tx - x0, bounds.max_tx - x0, bounds.min_ty - y0,
                bounds.max_ty - y0)
        return region_argmax_lanes(frame, templ, t_mean, t_std, [lane], span_shape, passes)[0]

    return region_argmax_fn
