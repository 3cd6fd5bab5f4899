"""The ranks' side of tests/test_torch_sharded.py: one gloo world of 4
processes runs every case of that file (pvot_torch.tools.dryrun_multichip
.spawn), so that process start-up is paid once.  Imports pvot_torch and
numpy, never JAX: the ranks are fresh processes.  The clips are those of
tests/test_parallel.py, made again here from the same seeds."""

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.io.gray import gray_u8_to_f32
from pvot_torch.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot_torch.parallel.multi import init_multi_state, multi_carry_from_state, stack_states
from pvot_torch.parallel.sharded import (
    make_data_parallel_multi_step, make_mesh, make_search_sharded_step, shard_states,
    track_video_sharded,
)
from pvot_torch.tracker.state import init_state

CFG = TrackerConfig(search_radius_x=20, search_radius_y=20)
CFG_REACQ = TrackerConfig(search_radius_x=20, search_radius_y=20, lost_frame_threshold=6)
TIE = dict(h=192, w=256, ts=32, first=(40, 30), second=(200, 130))


def setup(seed):
    """tests/test_parallel.py:31 `_setup`: (spec, video, roi, template)."""
    spec = SyntheticSpec(width=256, height=192, num_frames=16, target_w=24, target_h=24,
                         seed=seed, amplitude=0.25)
    video = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    return spec, video, (x, y, w, h), gray_u8_to_f32(video[0])[y : y + h, x : x + w]


def reacq_clips():
    """tests/test_parallel.py:296's two exit-and-reenter clips."""
    specs = [SyntheticSpec(width=320, height=240, num_frames=40, target_w=32, target_h=32,
                           seed=seed, exit_and_reenter=True) for seed in (3, 7)]
    videos = [generate_gray_video(s) for s in specs]
    starts = []
    for spec, video in zip(specs, videos):
        x, y, w, h = target_bbox(spec, 0)
        starts.append((gray_u8_to_f32(video[0])[y : y + h, x : x + w], (x, y, w, h)))
    return specs, videos, starts


def tie_frame():
    """tests/test_parallel.py:356's frame: one dyadic pattern planted twice,
    in rows that fall to different search ranks, so the two score exactly
    alike."""
    ts = TIE["ts"]
    pattern = np.random.default_rng(42).integers(0, 4, (ts, ts)).astype(np.float32) * 0.25
    frame = np.zeros((TIE["h"], TIE["w"]), np.float32)
    for x, y in (TIE["first"], TIE["second"]):
        frame[y : y + ts, x : x + ts] = pattern
    return frame, pattern


def _stack(pairs):
    return stack_states([init_state(t, r, device="cpu") for t, r in pairs], "cpu")


def _out(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def run_world(rank, world):
    """Every case on one rank; returns {case: host arrays}."""
    assert world == 4
    mesh = make_mesh((2, 2))
    res = {}

    # The sharded step frame by frame (tests/test_parallel.py:58): streams on
    # "data", their searches on "search"; this rank's block is one stream.
    (_, va, ra, ta), (_, vb, rb, tb) = setup(9), setup(11)
    states = _stack([(ta, ra), (tb, rb)])
    step = make_search_sharded_step(mesh, va.shape[1:], (24, 24), CFG)
    mc = multi_carry_from_state(shard_states(mesh, states))
    local = mesh.get_local_rank("data")
    steps = []
    for t in range(1, 8):
        frames = torch.from_numpy(np.stack([gray_u8_to_f32(v[t]) for v in (va, vb)]))
        mc, recs = step(mc, frames[local : local + 1])
        steps.append(recs[0])
    res["step"] = steps

    # The scan driver: chunks of 6, 6 and a masked 3.
    videos = np.stack([va[1:], vb[1:]])
    final, out = track_video_sharded(videos, states, mesh, CFG, chunk_size=6, device="cpu")
    res["scan"] = _out(out)
    res["scan_final_x"] = final.bbox_x.numpy()
    _, k4 = track_video_sharded(videos, states, mesh, CFG, chunk_size=6, backend="pallas",
                                device="cpu")
    res["scan_pallas"] = _out(k4)

    # Global re-acquisition through the strips and the combine.
    _, reacq, starts = reacq_clips()
    _, out = track_video_sharded(np.stack([v[1:] for v in reacq]), _stack(starts), mesh,
                                 CFG_REACQ, chunk_size=8, device="cpu")
    res["reacq"] = _out(out)

    # A tie across search ranks on a forced global frame.
    frame, pattern = tie_frame()
    ts = TIE["ts"]
    one = init_state(pattern, (*TIE["second"], ts, ts), device="cpu")
    one = one._replace(use_global=torch.tensor(True))
    tie_step = make_search_sharded_step(mesh, frame.shape, (ts, ts), CFG)
    mc = multi_carry_from_state(shard_states(mesh, stack_states([one, one], "cpu")))
    _, recs = tie_step(mc, torch.from_numpy(np.stack([frame])))
    res["tie"] = recs[0]

    # (streams x objects): 4 streams of 2 objects on a ("data", "obj") mesh.
    spec5, v5, r5, t5 = setup(5)
    roi2 = (40, 40, 24, 24)
    one = init_multi_state([t5, gray_u8_to_f32(v5[0])[40:64, 40:64]], [r5, roi2], device="cpu")
    states4 = type(one)(*(torch.stack([v] * 4) for v in one))
    obj_mesh = make_mesh((2, 2), ("data", "obj"))
    dp = make_data_parallel_multi_step(obj_mesh, v5.shape[1:], (24, 24), CFG)
    block = shard_states(obj_mesh, states4, ("data", "obj"))
    _, out = dp(block, torch.from_numpy(np.stack([gray_u8_to_f32(v5[1])] * 2)))
    res["data_parallel"] = _out(out)
    res["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("search"),
                     obj_mesh.get_local_rank("data"), obj_mesh.get_local_rank("obj"))
    return res
