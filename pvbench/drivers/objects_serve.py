"""Entry driver: K objects in one live stream of host frames, through
serve_objects.

The mix's clip is made on the card from the seed and copied once to host
memory: pre-decoded gray frames, `period` of them, looping.  One frame
iterator hands them to `pvot_torch.io.serving.serve_objects` (the feed, the
pinned staging, the copies and the records of the serving path, K3 for all K
objects a chunk) until the window's seconds are up.  The client keeps at
most `in_flight_frames` frames handed and not yet answered (a closed loop):
it hands the next frame once the serving path has returned enough records.
A frame's latency runs from its hand-off to the drain of its chunk's records,
which the `timings=` hook of serve_objects marks.

Besides `Driver`, the module gives the harness the reference in the
program's place (`reference_program`) and the cell's CPU-size copy
(`small`).
"""

from __future__ import annotations

import copy
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from pvbench import port
from pvbench.reference import programs
from pvbench.reference import tracker as ref
from pvbench.traffic import scene


def reference_program(cell, device: torch.device, tf32: bool, fault=None):
    """The plain reference in the place of the serving path, in the mix's
    chunks."""
    return programs.ReferenceObjects(ref.Params.from_config(cell.config), cell.mix["chunk"],
                                     device, tf32=tf32, fault=fault)


def small(config: dict, mix: dict):
    """(config, mix) cut down so that the plain versions run the cell on the
    CPU in a second or two: 2 objects in 96 x 160 frames, 16 x 16 templates,
    radius 8, a period of 32 in chunks of 4; an occlusion that still sends
    every object to the global search."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config.update(frame=[96, 160], template=[16, 16])
    config["tracker"].update(search_radius_x=8, search_radius_y=8)
    mix.update(period=32, chunk=4, in_flight_frames=16, grid=[1, 2], amplitude_px=[4, 4],
               cycles=[1, 1])
    if "occlusion" in mix:
        config["tracker"]["lost_frame_threshold"] = 3
        mix["occlusion"] = {"first": 4, "step": 8, "hidden": 6}
    return config, mix


class PortObjects:
    """The program: pvot_torch's serving path for K objects at the
    configuration's tier, chunk size and default pipeline depth."""

    def __init__(self, config: dict, chunk: int, device: torch.device):
        from pvot_torch.config import TrackerConfig
        from pvot_torch.ops.ncc_mega import mega_track_chunk_objects

        self.config = TrackerConfig(**config["tracker"])
        self.tier = port.tier(config)
        self.frame_shape = tuple(config["frame"])
        self.chunk, self.device = chunk, device
        self.wrapper = mega_track_chunk_objects

    def init(self, templates: torch.Tensor, boxes: np.ndarray):
        return port.init_states(templates, boxes, self.device)

    def serve(self, frames, state, timings):
        from pvot_torch.io.serving import serve_objects

        state, out = serve_objects(frames, state, self.frame_shape, self.config,
                                   chunk_size=self.chunk, timings=timings, **self.tier)
        return state, port.records(out)

    def launches(self) -> int:
        return self.wrapper.launches

    final = staticmethod(port.final_state)


class _Drains(list):
    """The timings list handed to serve_objects: each (frames, seconds) pair
    it appends as a chunk's records are drained calls on_drain(frames)."""

    def __init__(self, on_drain):
        super().__init__()
        self.on_drain = on_drain

    def append(self, item) -> None:
        super().append(item)
        self.on_drain(int(item[0]))


class Driver:
    shared_frame = True

    def __init__(self, cell, device: torch.device, seed: int, program=None):
        self.config, self.mix, self.device, self.seed = cell.config, cell.mix, device, seed
        self.p = ref.Params.from_config(cell.config)
        self.chunk, self.period = self.mix["chunk"], self.mix["period"]
        self.in_flight = self.mix["in_flight_frames"]
        # The serving loop fills its pipeline (the default depth of 2, plus
        # the chunk being staged) before it drains a chunk.
        if self.in_flight < 3 * self.chunk:
            raise ValueError("in_flight_frames must hold three chunks")
        self.program = program or PortObjects(cell.config, self.chunk, device)

    # -- inputs ---------------------------------------------------------------
    def setup(self, warm_profiler) -> None:
        per = self.period
        clip, truth = scene.make_clip(self.config, self.mix, self.seed, 0, 0, self.device)
        self.truth = truth  # (period, K, 4)
        self.n_lanes = truth.shape[1]
        self.init_lanes = [ref.initial_lane(clip[per - 1], b) for b in truth[per - 1]]
        self.host = clip.cpu().numpy()  # the pre-decoded frames, in host memory
        del clip
        self.clip = None
        self.state = self.program.init(torch.stack([ln.template for ln in self.init_lanes]),
                                       truth[per - 1])
        self.recs, self.units, self.t = [], [], 0
        self._serve_plain(2 * self.chunk)  # the warm-up: every shape of the window once
        if warm_profiler is not None:
            warm_profiler(lambda: self._serve_plain(self.chunk))
        self.first_timed = len(self.units)

    def _unit(self, n: int) -> None:
        self.units.append((self.t, n))
        self.t += n

    def _serve_plain(self, n: int) -> None:
        frames = [self.host[(self.t + i) % self.period] for i in range(n)]
        with record_function("pvbench.serve"):
            self.state, rec = self.program.serve(iter(frames), self.state,
                                                 _Drains(self._unit))
        self.recs.append(rec)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> dict:
        self.launch0 = self.program.launches()
        start = self.t
        handed: list = []
        drained: list = []  # (frames, time)
        cv = threading.Condition()
        done = [0]
        opened = [None]

        def on_drain(n: int) -> None:
            now = time.perf_counter()
            drained.append((n, now))
            self._unit(n)
            with cv:
                done[0] += n
                cv.notify_all()
            if tracer is not None:
                tracer.tick(now, opened[0])

        def over() -> bool:
            return opened[0] is not None and time.perf_counter() - opened[0] >= seconds

        def feed():
            i = start
            while True:
                with cv:
                    while len(handed) - done[0] >= self.in_flight and not over():
                        cv.wait(0.1)
                if over():
                    return
                now = time.perf_counter()
                if opened[0] is None:
                    opened[0] = now
                handed.append(now)
                yield self.host[i % self.period]
                i += 1

        with record_function("pvbench.serve"):
            self.state, rec = self.program.serve(feed(), self.state, _Drains(on_drain))
        if tracer is not None:
            tracer.stop()
        self.recs.append(rec)
        done_at = np.repeat([t for _, t in drained], [n for n, _ in drained])
        n_done = min(len(done_at), len(handed), rec.shape[0])
        lat = (done_at[:n_done] - np.array(handed[:n_done])) * 1e3
        return {"opened": opened[0], "closed": drained[-1][1],
                "attempted": len(handed) * self.n_lanes,
                "completed": n_done * self.n_lanes,
                "latencies_ms": np.repeat(lat, self.n_lanes)}

    # -- what the check reads ---------------------------------------------------
    def records(self) -> np.ndarray:
        return np.concatenate(self.recs)  # (T, K, 7)

    def truth_of(self, n_frames: int) -> np.ndarray:
        return self.truth[np.arange(n_frames) % self.period]

    def _device_clip(self) -> torch.Tensor:
        if self.clip is None:
            self.clip = torch.from_numpy(self.host).to(self.device)
        return self.clip

    def frames_at(self, t: int) -> torch.Tensor:
        return self._device_clip()[t % self.period].expand(self.n_lanes, -1, -1)

    def patches(self, ts: np.ndarray, xy: np.ndarray) -> torch.Tensor:
        dev = self.device
        f = torch.as_tensor(ts % self.period, device=dev)[:, None, None, None]
        xy = torch.as_tensor(xy, device=dev)
        ys = xy[:, :, 1, None, None] + torch.arange(self.p.th, device=dev)[None, None, :, None]
        xs = xy[:, :, 0, None, None] + torch.arange(self.p.tw, device=dev)[None, None, None, :]
        return self._device_clip()[f, ys, xs]

    def final(self):
        out = self.program.final(self.state)
        self.state = None
        return out
