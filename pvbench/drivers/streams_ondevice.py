"""Entry driver: S streams already on the card, through track_streams_mega.

The mix's clips stand for the frames a hardware decoder leaves in card
memory: one seeded clip per stream, `period` frames that loop without a
seam, stream s `s * phase_step` frames along its target's path.  Every call
tracks one segment of `segment` frames of all S streams, a view of the clips
(the decoder's output), with the stacked state carried from call to call;
the next call starts when the last one has returned its records to the host
(a closed loop).  Each tracker-frame's latency is its call's: from the
segment handed to the port to the records readable on the host.

Besides `Driver`, the module gives the harness the reference in the
program's place (`reference_program`) and the cell's CPU-size copy
(`small`).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
from torch.profiler import record_function

from pvbench import port
from pvbench.reference import programs
from pvbench.reference import tracker as ref
from pvbench.traffic import scene


def reference_program(cell, device: torch.device, tf32: bool, fault=None):
    """The plain reference in the place of the multi-stream chunk driver."""
    return programs.ReferenceStreams(ref.Params.from_config(cell.config), tf32=tf32,
                                     fault=fault)


def small(config: dict, mix: dict):
    """(config, mix) cut down so that the plain versions run the cell on the
    CPU in a second or two: 3 streams of 96 x 128 frames, 16 x 16 templates,
    radius 8, a period of 32 in segments of 8; an occlusion that still sends
    every stream to the global search."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config.update(frame=[96, 128], template=[16, 16])
    config["tracker"].update(search_radius_x=8, search_radius_y=8)
    mix.update(streams=3, period=32, segment=8, phase_step=10, amplitude_px=[10, 5])
    if "occlusion" in mix:
        config["tracker"]["lost_frame_threshold"] = 3
        mix["occlusion"] = {"first": 4, "step": 8, "hidden": 6}
    return config, mix


class PortStreams:
    """The program: pvot_torch's multi-stream chunk driver at the
    configuration's tier."""

    def __init__(self, config: dict, device: torch.device):
        from pvot_torch.config import TrackerConfig
        from pvot_torch.ops.ncc_mega import mega_track_chunk_multi

        self.config = TrackerConfig(**config["tracker"])
        self.tier = port.tier(config)
        self.device = device
        self.wrapper = mega_track_chunk_multi

    def init(self, templates: torch.Tensor, boxes: np.ndarray):
        return port.init_states(templates, boxes, self.device)

    def __call__(self, segment: torch.Tensor, state):
        from pvot_torch.tracker.mega import track_streams_mega

        state, out = track_streams_mega(segment, state, self.config,
                                        chunk_size=segment.shape[1], **self.tier)
        return state, port.records(out)

    def launches(self) -> int:
        return self.wrapper.launches

    final = staticmethod(port.final_state)


class Driver:
    shared_frame = False

    def __init__(self, cell, device: torch.device, seed: int, program=None):
        self.config, self.mix, self.device, self.seed = cell.config, cell.mix, device, seed
        self.p = ref.Params.from_config(cell.config)
        self.program = program or PortStreams(cell.config, device)
        self.n_lanes = self.mix["streams"]
        self.period, self.segment = self.mix["period"], self.mix["segment"]
        if self.period % self.segment:
            raise ValueError("a segment must divide the period")

    # -- inputs ---------------------------------------------------------------
    def setup(self, warm_profiler) -> None:
        (h, w), s, per = self.config["frame"], self.n_lanes, self.period
        self.clips = torch.empty((s, per, h, w), dtype=torch.uint8, device=self.device)
        self.truth = np.stack([scene.make_clip(self.config, self.mix, self.seed, i,
                                               i * self.mix["phase_step"], self.device,
                                               out=self.clips[i])[1][:, 0]
                               for i in range(s)], axis=1)  # (period, S, 4)
        # Every tracker starts on its box in the frame before frame 0 (the loop's last).
        self.init_lanes = [ref.initial_lane(self.clips[i, per - 1], self.truth[per - 1, i])
                           for i in range(s)]
        self.state = self.program.init(torch.stack([ln.template for ln in self.init_lanes]),
                                       self.truth[per - 1])
        self.recs, self.units = [], []
        self._call()  # the warm-up: every shape of the window once
        if warm_profiler is not None:
            warm_profiler(self._call)
        self.first_timed = len(self.units)

    def _call(self) -> None:
        t0 = len(self.units) * self.segment
        a = t0 % self.period
        with record_function("pvbench.call"):
            self.state, rec = self.program(self.clips[:, a : a + self.segment], self.state)
        self.recs.append(rec)
        self.units.append((t0, self.segment))

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> dict:
        self.launch0 = self.program.launches()
        lat = []
        opened = time.perf_counter()
        while True:
            handed = time.perf_counter()
            self._call()
            done = time.perf_counter()
            lat.append(done - handed)
            if done - opened >= seconds:
                break
            if tracer is not None:
                tracer.tick(done, opened)
        if tracer is not None:
            tracer.stop()
        frames = len(lat) * self.segment * self.n_lanes
        return {"opened": opened, "closed": done, "attempted": frames, "completed": frames,
                "latencies_ms": np.repeat(np.array(lat) * 1e3, self.segment * self.n_lanes)}

    # -- what the check reads ---------------------------------------------------
    def records(self) -> np.ndarray:
        return np.concatenate(self.recs)  # (T, S, 7)

    def truth_of(self, n_frames: int) -> np.ndarray:
        return self.truth[np.arange(n_frames) % self.period]

    def frames_at(self, t: int) -> torch.Tensor:
        return self.clips[:, t % self.period]

    def patches(self, ts: np.ndarray, xy: np.ndarray) -> torch.Tensor:
        dev = self.device
        lane = torch.arange(self.n_lanes, device=dev)[None, :, None, None]
        f = torch.as_tensor(ts % self.period, device=dev)[:, None, None, None]
        xy = torch.as_tensor(xy, device=dev)
        ys = xy[:, :, 1, None, None] + torch.arange(self.p.th, device=dev)[None, None, :, None]
        xs = xy[:, :, 0, None, None] + torch.arange(self.p.tw, device=dev)[None, None, None, :]
        return self.clips[lane, f, ys, xs]

    def final(self):
        out = self.program.final(self.state)
        self.state = None  # the program's state is freed before the reference runs
        return out
