"""The comparison that decides `correct` fails the control and every planted
fault, and passes the sound programs: on the CPU at a small size, and (on
the card) the control at each cell's own size."""

import subprocess
import sys
import json
import time

import pytest
import torch

from pvbench import control, harness
from pvbench.reference import programs
from pvbench.tests.conftest import BENCH, CELLS, small_cell

SEED = 4_000_000_123


def _run(cell, program):
    return harness.run_cell(cell, BENCH, SEED, 0.6, False, torch.device("cpu"),
                            time.perf_counter(), program=program, out=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_port_cpu_path_is_correct(cell):
    r = _run(small_cell(cell), None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_the_programs_place_is_correct(cell):
    c = small_cell(cell)
    r = _run(c, control.reference_program(c, torch.device("cpu"), tf32=False))
    assert r["correct"], r["checks"]
    assert r["checks"]["score_gap"]["value"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = small_cell(cell)
    r = _run(c, control.reference_program(c, torch.device("cpu"), tf32=True))
    assert not r["correct"]
    assert r["checks"]["score_gap"]["value"] > r["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("fault", programs.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    c = small_cell(cell)
    r = _run(c, control.reference_program(c, torch.device("cpu"), tf32=False, fault=fault))
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size(cell, cuda_device):
    """The control on the card, at the cell's own size, on three seeds."""
    res = subprocess.run([sys.executable, "-m", "pvbench.control", "--workload", cell,
                          "--seconds", "2", "--seeds", "101", "202", "303"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)
