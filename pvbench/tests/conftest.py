"""Shared fixtures of pvbench's tests: small copies of the cells that run on
the CPU (the port's plain versions), and the card when there is one."""

import copy

import pytest
import torch

from pvbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name: str) -> harness.Cell:
    """The cell with its frames, template, radii, lanes and period cut down
    so that the plain versions run it on the CPU in a second or two; its
    checks and limits as they are."""
    cell = harness.load_cell(name, BENCH)
    config, mix, spec = (copy.deepcopy(x) for x in (cell.config, cell.mix, cell.spec))
    config["tracker"].update(search_radius_x=8, search_radius_y=8)
    config["template"] = [16, 16]
    if mix["driver"] == "streams_ondevice":
        config["frame"] = [96, 128]
        mix.update(streams=3, period=32, segment=8, phase_step=10, amplitude_px=[10, 5])
    else:
        config["frame"] = [96, 160]
        mix.update(period=32, chunk=4, in_flight_frames=16, grid=[1, 2],
                   amplitude_px=[4, 4], cycles=[1, 1])
    spec["check"]["units"] = 4
    return harness.Cell(name, cell.entry, spec, config, mix)


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests run the kernels, which have no CPU form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels and the cell's own size)")
    return torch.device("cuda", 0)
