"""Tracking sharded over several devices on torch.distributed: the port of
pvot/parallel/sharded.py, one process a device.

JAX's Mesh with the axes ("data", "search") becomes a 2-D
torch.distributed DeviceMesh with the same dimension names (`make_mesh`);
its `get_group(name)` carries the collectives.  Two axes:

  "data"    independent video streams: each rank tracks its contiguous block
            of the streams (`shard_states`);
  "search"  inside one NCC search: the candidate window's rows are sliced
            across the ranks of a search group; each scores its slab, takes
            its masked argmax, and the winners combine by an all_gather that
            picks the largest value, then the smallest row-major position
            y * out_w + x (`_lex_combine`): cv::minMaxLoc's first occurrence,
            whichever rank holds it.  A global (re-acquisition) search splits
            the full map's rows the same way.

Every rank of a search group holds the same states and so takes the same
branches and the same updates.  As in the port's per-frame steps
(pvot_torch.tracker.step), a stream's discrete fields ride on the host and
its template on the device, and a step reads the device once: the combine's
rows.  The slab and strip scores come from the backend's full-map function
(pvot/parallel/sharded.py:88-101): "xla" is ncc_map_matmul, the CUDA engine
("pallas", "shared", "pallas_fast", ...) is K4, one launch for every local
stream's slab and one for their strips on a step where some stream searches
globally (full maps score float32 at every tier, as in JAX).

The combine reads its (S, 3) rows to the host, as the step does in any
case, and all_gathers them there over the search group: the mesh's groups
are gloo, which takes host tensors and serves ranks on any card, ranks that
share one included.

The caller owns the process group: torch.distributed.init_process_group
with its address, world size and rank (nothing here reads a cluster's
environment), then `make_mesh`.  pvot_torch.tools.dryrun_multichip starts
such a world of processes and checks it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pvot_torch.config import TrackerConfig
from pvot_torch.ops import search as search_ops
from pvot_torch.ops.backends import cuda_region_passes
from pvot_torch.ops.ncc_pallas import ncc_map_lanes
from pvot_torch.parallel.multi import (
    MultiCarry, _lane_modes, _update_lanes, lane_records_to_output, make_multi_step,
    multi_carry_from_state, state_from_multi_carry,
)
from pvot_torch.tracker.state import StepOutput, TrackerState, default_device
from pvot_torch.tracker.step import host_read


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def make_mesh(shape: Tuple[int, int], names: Tuple[str, str] = ("data", "search")):
    """A 2-D DeviceMesh over the default (gloo) process group's ranks,
    row-major (rank = i * shape[1] + j), with the dimension names of JAX's
    Mesh.  Its groups carry host tensors; the tracking device is the
    drivers' `device`."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def shard_states(mesh, states: TrackerState, dims: Sequence[str] = ("data",),
                 device=None) -> TrackerState:
    """This rank's block of a stacked state: leading axis i sliced into
    mesh.size(dims[i]) contiguous blocks, the block at this rank's
    coordinate on dims[i] (JAX's shard_states with the spec P(*dims)); on
    `device` (default: the states' device)."""
    index = []
    for axis, name in enumerate(dims):
        n, at = mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)
        total = states.t_mean.shape[axis]
        if total % n:
            raise ValueError(f"{total} lanes on axis {axis} do not split over {n} {name!r} ranks")
        index.append(slice(at * total // n, (at + 1) * total // n))
    block = TrackerState(*(v[tuple(index)] for v in states))
    return block.to(device) if device is not None else block


def _all_gather_rows(rows: torch.Tensor, group) -> np.ndarray:
    """(P, n, k) host array of every rank's (n, k) float32 rows in `group`,
    in group-rank order, gathered from the host (one read of the rows)."""
    rows = host_read(rows)
    out = [torch.empty_like(rows) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, rows, group=group)
    return torch.stack(out).numpy()


def _lex_combine(gathered: np.ndarray, out_w: int):
    """Per stream, the winner of the search ranks' (val, x, y) rows
    (gathered (P, S, 3)): the largest value, ties to the smallest
    y * out_w + x (pvot/parallel/sharded.py:104-111)."""
    best = []
    for cand in gathered.transpose(1, 0, 2):  # (P, 3) a stream
        vals = cand[:, 0]
        top = vals.max()
        keys = np.where(vals >= top, cand[:, 2].astype(np.int64) * out_w + cand[:, 1],
                        np.iinfo(np.int64).max)
        p = int(np.argmin(keys))
        best.append((float(vals[p]), int(cand[p, 1]), int(cand[p, 2])))
    return best


def make_search_sharded_step(
    mesh,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    data_axis: str = "data",
    search_axis: str = "search",
    backend: str = "xla",
):
    """The (streams x search rows) step of one rank: step(mc, frames) ->
    (mc, records), mc the MultiCarry of this rank's streams (the block of
    `data_axis` it holds) and frames (S_local, H, W) on their device.

    Each stream's candidate window (span_y x span_x) splits into slabs of
    ceil(span_y / n) rows, one a rank of `search_axis`, each slab clamped to
    stay inside the map and masked to the window and to its own share of
    rows; the global pass, run only on a step where some local stream
    searches globally (JAX's scalar cond), splits the full map into strips
    of ceil(out_h / n) rows the same way.  The winners combine by
    `_lex_combine`, and every rank applies the same update."""
    frame_h, frame_w = frame_shape
    th, tw = templ_shape
    out_w, out_h = frame_w - tw + 1, frame_h - th + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    n_search = mesh.size(mesh.mesh_dim_names.index(search_axis))
    group = mesh.get_group(search_axis)
    my = mesh.get_local_rank(search_axis)
    slab_y = _ceil_to(span_y, n_search) // n_search  # candidate rows a rank
    full_slab = _ceil_to(out_h, n_search) // n_search  # global-map rows a rank
    if out_h * out_w >= 2**31:
        raise ValueError("NCC map too large for int32 position keys")
    if out_w < span_x or out_h < span_y:
        raise ValueError(
            "search-sharded step needs the NCC map to contain the candidate "
            f"span: out=({out_h}, {out_w}) < span=({span_y}, {span_x})"
        )
    cuda_lanes = cuda_region_passes(backend) is not None
    if backend == "xla":
        from pvot_torch.ops.ncc_matmul import ncc_map_matmul as map_fn
    elif not cuda_lanes:
        from pvot_torch.ops.backends import get_backend

        map_fn = get_backend(backend, frame_shape, templ_shape, config)[0]

    def scores(mc: MultiCarry, frames, origins, rows: int, cols: int) -> torch.Tensor:
        """Each local stream's (rows, cols) map from its origin (x, y)."""
        if cuda_lanes:  # one K4 launch for every local stream
            return ncc_map_lanes(frames, mc.template, mc.t_mean, mc.t_std, origins, (rows, cols))
        return torch.stack([
            map_fn(frames[s, y : y + rows + th - 1, x : x + cols + tw - 1], mc.template[s],
                   mc.t_mean[s], mc.t_std[s])
            for s, (x, y) in enumerate(origins)])

    def share_best(maps, origins, keep) -> torch.Tensor:
        """(S, 3) rows (value, x, y) of each map masked by keep(s, ys, xs)."""
        dev = maps.device
        rows = []
        for s, (x0, y0) in enumerate(origins):
            ys = y0 + torch.arange(maps.shape[1], device=dev)[:, None]
            xs = x0 + torch.arange(maps.shape[2], device=dev)[None, :]
            rows.append(search_ops.best_rows(torch.where(keep(s, ys, xs), maps[s], float("-inf")),
                                             x0, y0))
        return torch.stack(rows)

    def step(mc: MultiCarry, frames: torch.Tensor):
        k = len(mc.bbox)
        modes = _lane_modes(mc, frame_shape, [(th, tw)] * k, config)
        regions = [search_ops.region_origin(b, out_w, out_h, span_x, span_y) for _, b, _ in modes]
        slabs = [(x0, min(y0 + my * slab_y, out_h - slab_y)) for x0, y0 in regions]

        def in_window(s, ys, xs):
            b, share_lo = modes[s][1], regions[s][1] + my * slab_y
            return ((xs >= b.min_tx) & (xs <= b.max_tx) & (ys >= b.min_ty) & (ys <= b.max_ty)
                    & (ys >= share_lo) & (ys < share_lo + slab_y))

        cand = share_best(scores(mc, frames, slabs, slab_y, span_x), slabs, in_window)
        if any(ga for _, _, ga in modes):
            strips = [(0, min(my * full_slab, out_h - full_slab))] * k

            def in_share(s, ys, xs):
                return (ys >= my * full_slab) & (ys < (my + 1) * full_slab)

            glob = share_best(scores(mc, frames, strips, full_slab, out_w), strips, in_share)
            sel = torch.tensor([ga for _, _, ga in modes], device=cand.device)
            cand = torch.where(sel[:, None], glob, cand)
        best = _lex_combine(_all_gather_rows(cand, group), out_w)
        return _update_lanes(mc, frames, best, modes, [(th, tw)] * k, frame_shape, config, True)

    return step


def make_data_parallel_multi_step(
    mesh,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    data_axis: str = "data",
    obj_axis: str = "obj",
    strategy: str = "fused",
    backend: str = "xla",
):
    """The (streams x objects) step of one rank (pvot/parallel/sharded.py:301):
    step(states, frames) -> (states, StepOutput), states this rank's block
    (S_local, K_local, ...) of streams on `data_axis` and their objects on
    `obj_axis` (shard_states(mesh, states, (data_axis, obj_axis))), frames
    (S_local, H, W).  Each stream's objects run the multi-object step on its
    frame; no collectives are needed."""
    del mesh, data_axis, obj_axis  # the block is the caller's shard_states
    multi_step = make_multi_step(frame_shape, templ_shape, config, strategy, backend)

    def step(states: TrackerState, frames: torch.Tensor):
        finals, outs = [], []
        for s in range(frames.shape[0]):
            mc, recs = multi_step(multi_carry_from_state(TrackerState(*(v[s] for v in states))),
                                  frames[s])
            finals.append(state_from_multi_carry(mc))
            out = lane_records_to_output([recs], len(recs))
            outs.append(StepOutput(*(v[0] for v in out)))
        return (TrackerState(*(torch.stack(vs) for vs in zip(*finals))),
                StepOutput(*(np.stack(vs) for vs in zip(*outs))))

    return step


def make_sharded_scan_fn(sharded_step):
    """The masked chunk loop of a sharded step (pvot/parallel/sharded.py:349):
    (this rank's stacked states, frames (C, S_local, H, W), valid (C,)) ->
    (states, StepOutput with the (C, S_local) leading layout).  Every frame
    runs the step, collectives included, so all ranks stay in step; an
    invalid (padding) frame leaves the states as they were."""

    def scan_chunk(states: TrackerState, frames: torch.Tensor, valid):
        mc = multi_carry_from_state(states)
        per_frame = []
        for frame, ok in zip(frames, np.asarray(valid, bool)):
            new, recs = sharded_step(mc, frame)
            if ok:
                mc = new
            per_frame.append(recs)
        return state_from_multi_carry(mc), lane_records_to_output(per_frame, frames.shape[1])

    return scan_chunk


def _all_gather_blocks(arrays: Sequence[np.ndarray], group, axis: int):
    """Each array concatenated along `axis` over the ranks of `group`, in
    group-rank order (host arrays of one shape on every rank)."""
    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, [np.asarray(a) for a in arrays], group=group)
    return [np.concatenate(parts, axis=axis) for parts in zip(*got)]


def track_video_sharded(
    videos: np.ndarray,
    states: TrackerState,
    mesh,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 16,
    data_axis: str = "data",
    search_axis: str = "search",
    backend: str = "xla",
    device=None,
) -> Tuple[TrackerState, StepOutput]:
    """Scan S video streams across the mesh (pvot/parallel/sharded.py:371),
    on every rank of it: the multi-device analog of track_video.

    videos: (S, F, H, W) uint8 or float32, the same on every rank; states: a
    stacked TrackerState of the S streams (any device).  Each rank tracks
    its block of `data_axis` on `device` (default: the current CUDA device;
    device="cpu" for the CPU), chunk_size frames a chunk with the tail
    padded and masked, its searches split over `search_axis`.  Returns, on
    every rank, (the S final states on `device`, StepOutput with (F, S)
    leading axes in host arrays), as JAX returns global arrays."""
    videos = np.asarray(videos)
    if videos.ndim != 4:
        raise ValueError(f"expected (S, F, H, W) videos, got {videos.shape}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    s, f, h, w = videos.shape
    device = default_device(device)
    n_data = mesh.size(mesh.mesh_dim_names.index(data_axis))
    at = mesh.get_local_rank(data_axis)
    lo, hi = at * s // n_data, (at + 1) * s // n_data
    local = shard_states(mesh, states, (data_axis,), device)
    step = make_search_sharded_step(mesh, (h, w), tuple(states.template.shape[-2:]), config,
                                    data_axis, search_axis, backend)
    scan_fn = make_sharded_scan_fn(step)
    outs = []
    for start in range(0, f, chunk_size):
        chunk = videos[lo:hi, start : start + chunk_size]  # (S_local, C', H, W)
        n_real = chunk.shape[1]
        if n_real < chunk_size:  # pad the tail; padding is masked out
            pad = np.repeat(chunk[:, -1:], chunk_size - n_real, axis=1)
            chunk = np.concatenate([chunk, pad], axis=1)
        frames = torch.from_numpy(np.ascontiguousarray(chunk.transpose(1, 0, 2, 3))).to(device)
        local, out = scan_fn(local, frames, np.arange(chunk_size) < n_real)
        outs.append(StepOutput(*(v[:n_real] for v in out)))
    out = StepOutput(*(np.concatenate(vs) for vs in zip(*outs))) if outs else StepOutput(
        np.zeros((0, hi - lo, 4), np.int32), np.zeros((0, hi - lo), np.float32),
        np.zeros((0, hi - lo), bool), np.zeros((0, hi - lo), bool))
    group = mesh.get_group(data_axis)
    out = StepOutput(*_all_gather_blocks(out, group, axis=1))
    final = _all_gather_blocks([v.cpu().numpy() for v in local], group, axis=0)
    return TrackerState(*(torch.from_numpy(v).to(device) for v in final)), out
