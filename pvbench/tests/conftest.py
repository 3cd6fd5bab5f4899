"""Shared fixtures of pvbench's tests: small copies of the cells that run on
the CPU (the port's plain versions), and the card when there is one."""

import copy
import hashlib
import os

import pytest
import torch

from pvbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name: str) -> harness.Cell:
    """The cell cut down by its driver's `small` (frames, template, radii,
    lanes, period) so that the plain versions run it on the CPU in a second
    or two, with 4 units checked; its limits as they are."""
    cell = harness.load_cell(name, BENCH)
    config, mix = harness.load_module("drivers", cell.mix["driver"]).small(cell.config,
                                                                            cell.mix)
    spec = copy.deepcopy(cell.spec)
    spec["check"]["units"] = 4
    return harness.Cell(name, cell.entry, spec, config, mix)


def digest(root) -> dict:
    """sha256 of every file under root (bytecode caches aside), by path."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests run the kernels, which have no CPU form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels and the cell's own size)")
    return torch.device("cuda", 0)
