"""One run of one cell, driven by data.

Everything a cell needs is found by name: the cell's entry in BENCHMARK.json
(its configuration, traffic mix and chips), its file pvbench/workloads/
<cell>.json (the check's sample and limits), the configuration
pvbench/configs/<config>.json, the traffic mix pvbench/traffic/<traffic>.json,
whose `driver` names pvbench/drivers/<driver>.py, and one reader a metric,
pvbench/metrics/<metric>.py, for each metric BENCHMARK.json gives the cell.

A run: set-up (the inputs from the seed, the program's state, a warm-up that
runs every shape of the window), the measured window, the device's peak
memory, the traced span's record (`--trace 1`), the program's state freed,
then the check against the reference, the metrics and the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pvbench import check, roofline
from pvbench import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names the measured process may never hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "pvot")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """pvbench/<kind>/<name>.py as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"pvbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # its entry of BENCHMARK.json's workloads
    spec: dict  # pvbench/workloads/<name>.json
    config: dict
    mix: dict


def load_cell(name: str, bench: dict) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell named {name!r}")
    entry = entries[0]
    spec = load_json(HERE / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"pvbench/workloads/{name}.json and BENCHMARK.json name another "
                         "configuration or traffic for the cell")
    return Cell(name, entry, spec, load_json(HERE / "configs" / f"{entry['config']}.json"),
                load_json(HERE / "traffic" / f"{entry['traffic']}.json"))


def metric_entries(bench: dict, cell: str, trace: bool) -> list:
    """BENCHMARK.json's metrics of the cell: its end-to-end ones, or with
    trace its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def gpu_identity() -> str:
    """nvidia-smi's "name, power.limit" line of the first card (a copy of
    pvot_torch/bench.py's `gpu_identity`), or why there is none."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    return out[0] if out else "unknown"


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    tracker_frames: int  # records completed in the window
    latencies_ms: np.ndarray  # one a tracker-frame completed in the window
    trace: Optional[dict]  # the traced span (--trace 1), with its roofline bound


def _roofline(drv, records: np.ndarray, traced: dict, tier: dict) -> dict:
    """The bound of the chunk kernels the traced span launched: the units
    launched between the counter's two readings."""
    c0, c1 = traced["launches"]
    first = drv.first_timed + (c0 - drv.launch0)
    units = drv.units[first : first + (c1 - c0)]
    th, tw = drv.p.th, drv.p.tw
    frame, radii = (drv.p.frame_h, drv.p.frame_w), (drv.p.radius_x, drv.p.radius_y)
    init = np.array([ln.bbox for ln in drv.init_lanes])
    fma = n_bytes = steps = 0
    for t0, n in units:
        start = records[t0 - 1, :, :4] if t0 else init
        windows = [roofline.scored_windows(start[l], records[t0 : t0 + n, l, :4],
                                           records[t0 : t0 + n, l, 6], frame, (th, tw), radii)
                   for l in range(records.shape[1])]
        f, b = roofline.chunk_work(windows, (th, tw), drv.shared_frame)
        fma, n_bytes, steps = fma + f, n_bytes + b, steps + n
    bound, by = roofline.bound_ms(fma, n_bytes, 0 if tier["highest"] else tier["score_passes"])
    return {"steps": steps, "fma": fma, "bytes": n_bytes, "bound_ms": bound, "bound_by": by}


def run_cell(cell: Cell, bench: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, program=None, out=print) -> dict:
    """One run; returns the result object (the last line's keys, `checks`
    last).  t0: the process's start on the perf_counter clock.  program: the
    program under test (default: the port); the control and the tests put
    others in its place.  out: where the earlier lines go."""
    name = cell.name
    drv = load_module("drivers", cell.mix["driver"]).Driver(cell, device, seed, program)
    cuda = device.type == "cuda"
    drv.setup(tracing.warm if trace and cuda else None)
    if cuda:
        from pvot_torch.ops import _build

        info = {k: v for k, v in _build.build_info.items() if k in ("seconds", "path", "units")}
        out(f"pvbench: kernel library {json.dumps(info)}")
    tracer = tracing.Tracer(seconds, drv.program.launches) if trace and cuda else None
    win = drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    records = drv.records()
    traced = tracing.read(tracer) if tracer is not None else None
    if traced is not None:
        traced.update(_roofline(drv, records, traced, cell.config["tier"]))
        out(f"pvbench: traced span: {traced['kernel_records']} chunk kernels, "
            f"{traced['steps']} frame steps, bound {traced['bound_ms']:.6f} ms by "
            f"{traced['bound_by']} ({traced['fma']} FMA, {traced['bytes']} bytes)")
    final = drv.final()
    n_t = records.shape[0]
    t_check = time.perf_counter()
    judged = check.judge(drv.p, drv.frames_at, drv.patches, drv.truth_of(n_t), drv.init_lanes,
                         records, drv.units, drv.first_timed, final,
                         cell.spec["check"]["units"], seed,
                         win["attempted"] - win["completed"])
    correct, checks = check.verdict(judged["numbers"], cell.spec["limits"])
    judged["info"]["seconds"] = time.perf_counter() - t_check
    out(f"pvbench: check {json.dumps(judged['info'])}")
    if cuda:
        out(f"pvbench: card {gpu_identity()}")
    run = Run(win["opened"] - t0, win["closed"] - win["opened"], win["completed"],
              win["latencies_ms"], traced)
    metrics = {}
    for m in metric_entries(bench, name, trace):
        reader = load_module("metrics", m["name"])
        for key in ("unit", "layer", "moves"):
            if m.get(key) != getattr(reader, key.upper(), None):
                raise ValueError(f"metric {m['name']}: its reader and BENCHMARK.json give "
                                 f"another {key}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["attempted"] - win["completed"], "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_us"] * 1e-6, window_s=traced["span_us"] * 1e-6)
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result
