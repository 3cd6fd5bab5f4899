"""Hidden targets: the scene leaves them out of their intervals and expects
the box a correct tracker holds there; an occluded cell and a cell on a new
driver run through the harness, the control and the CPU-size copy from new
files alone."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pvbench import harness
from pvbench.reference import programs
from pvbench.traffic import scene
from pvbench.tests.conftest import BENCH, digest

CPU = torch.device("cpu")
OCCLUSION = {"first": 20, "step": 30, "hidden": 100}


def _small_streams():
    """The streams cell's CPU-size copy with an occlusion (the driver cuts it)."""
    cell = harness.load_cell("streams16-720p-ondevice", BENCH)
    return harness.load_module("drivers", "streams_ondevice").small(
        cell.config, dict(cell.mix, occlusion=OCCLUSION))


def test_occluded_clip_hides_its_targets_and_expects_the_held_box():
    config, mix = _small_streams()
    plain = {k: v for k, v in mix.items() if k != "occlusion"}
    (th, tw), occ = config["template"], mix["occlusion"]
    for index in range(mix["streams"]):
        phase = index * mix["phase_step"]
        a, want = scene.make_clip(config, plain, 987654321012, index, phase, CPU)
        b, got = scene.make_clip(config, mix, 987654321012, index, phase, CPU)
        paths = scene.boxes(config, mix, phase)
        assert np.array_equal(want, paths)  # no occlusion: the paths themselves
        first = occ["first"] + index * occ["step"]
        hide = np.zeros(mix["period"], bool)
        hide[first : first + occ["hidden"]] = True
        assert np.array_equal(scene.hidden(config, mix, index), hide)
        vis = torch.as_tensor(~hide)
        assert torch.equal(a[vis], b[vis])  # the same random numbers
        for t in np.flatnonzero(hide):
            x, y = paths[t, 0, :2]
            texture = a[t, y : y + th, x : x + tw].float()
            assert (b[t, y : y + th, x : x + tw].float() - texture).abs().mean() > 40
        # The box holds through the interval and is the path's again after it.
        assert (got[hide] == paths[first - 1]).all()
        assert np.array_equal(got[~hide], paths[~hide])


@pytest.mark.parametrize("occlusion,why", [
    ({"first": 26, "step": 0, "hidden": 6}, "outside frames 0-30"),
    ({"first": 20, "step": 4, "hidden": 6}, "outside frames 0-30"),
    ({"first": 4, "step": 8, "hidden": 3}, "outlast lost_frame_threshold"),
])
def test_make_clip_refuses_an_undefined_expected_box(occlusion, why):
    config, mix = _small_streams()
    mix = dict(mix, occlusion=occlusion)
    with pytest.raises(ValueError, match=why):
        scene.make_clip(config, mix, 5, 2, 0, CPU)


# Cells added below as new files in a copy of the benchmark: the occlusion
# cell that the harness now has room for, an occluded objects cell, and a
# streams cell on a driver under a new name.
OCCL_CELLS = ("streams16-720p-occl", "objects8-1080p-occl")
RENAMED = "streams16-720p-renamed"
LIMITS = {"missing": 0, "off_truth": 0, "records_differ": 0, "state_differ": 0,
          "score_gap": 1e-5}
PROGRAMS = ("port", "float32", "control") + programs.FAULTS

_RUN = textwrap.dedent('''
    import json, sys, time, torch
    from pvbench import control, harness
    from pvbench.tests.conftest import BENCH, small_cell

    cpu = torch.device("cpu")
    for name, kind in json.loads(sys.argv[1]):
        cell = small_cell(name)
        if kind == "port":
            prog = None
        else:
            prog = control.reference_program(cell, cpu, tf32=kind == "control",
                                              fault=None if kind in ("float32", "control")
                                              else kind)
        lines = []
        r = harness.run_cell(cell, BENCH, 4_000_000_321, 0.6, False, cpu,
                             time.perf_counter(), program=prog, out=lines.append)
        info = [s for s in lines if s.startswith("pvbench: check ")][0]
        print(json.dumps({"cell": name, "kind": kind, "correct": r["correct"],
                          "checks": r["checks"], "program": type(prog).__name__,
                          "frame": cell.config["frame"],
                          "info": json.loads(info[len("pvbench: check "):])}))
''')


def _add(root, name, config, traffic, mix):
    for rel, data in ((f"traffic/{traffic}.json", mix),
                      (f"workloads/{name}.json", {"config": config, "traffic": traffic,
                                                  "check": {"units": 16}, "limits": LIMITS})):
        (root / "pvbench" / rel).write_text(json.dumps(data))
    return {"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "a test"}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """Run every (cell, program) of the added cells in a copy of the
    benchmark; returns ({(cell, program): result}, digests before, after)."""
    root = tmp_path_factory.mktemp("added")
    shutil.copytree(harness.HERE, root / "pvbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root / "pvbench")
    load = lambda t: harness.load_json(harness.HERE / "traffic" / f"{t}.json")  # noqa: E731
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] += [
        _add(root, "streams16-720p-occl", "uav123-720p-t80-r60", "streams16_ondevice_occl100",
             dict(load("streams16_ondevice_seg64"), occlusion=OCCLUSION)),
        _add(root, "objects8-1080p-occl", "hd1080-t160-r160", "objects8_serve_occl100",
             dict(load("objects8_serve_chunk16"), occlusion=OCCLUSION)),
        _add(root, RENAMED, "uav123-720p-t80-r60", "streams16_renamed",
             dict(load("streams16_ondevice_seg64"), driver="streams_renamed")),
    ]
    shutil.copy(harness.HERE / "drivers" / "streams_ondevice.py",
                root / "pvbench" / "drivers" / "streams_renamed.py")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    todo = [(c, k) for c in OCCL_CELLS for k in PROGRAMS] + [(RENAMED, "port"),
                                                              (RENAMED, "float32")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(harness.ROOT)]))
    res = subprocess.run([sys.executable, "-c", _RUN, json.dumps(todo)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = [json.loads(s) for s in res.stdout.splitlines() if s.startswith("{")]
    return {(r["cell"], r["kind"]): r for r in out}, before, digest(root / "pvbench")


@pytest.mark.parametrize("cell", OCCL_CELLS)
def test_occluded_cell_goes_global_and_the_reference_meets_the_expected_box(added, cell):
    """Every program's records hold global frames; the reference, replayed
    along a sound program's records, reports the expected boxes."""
    for kind in PROGRAMS:
        r = added[0][(cell, kind)]
        assert r["info"]["used_global"] > 0, (kind, r["info"])
        if kind in ("port", "float32"):
            assert r["info"]["reference_off_truth"] == 0, (kind, r["info"])


@pytest.mark.parametrize("cell", OCCL_CELLS)
def test_occluded_cell_port_and_float32_reference_are_correct(added, cell):
    port, f32 = added[0][(cell, "port")], added[0][(cell, "float32")]
    assert port["correct"], port["checks"]
    assert f32["correct"] and f32["checks"]["score_gap"]["value"] == 0.0, f32["checks"]


@pytest.mark.parametrize("kind", PROGRAMS[2:])
@pytest.mark.parametrize("cell", OCCL_CELLS)
def test_occluded_cell_control_and_faults_are_not_correct(added, cell, kind):
    r = added[0][(cell, kind)]
    assert not r["correct"], r["checks"]


def test_new_driver_is_taken_by_name(added):
    """A driver under a new name gives the control its reference and the tests
    their CPU-size copy, and its cell runs correct."""
    port, f32 = added[0][(RENAMED, "port")], added[0][(RENAMED, "float32")]
    assert port["correct"] and f32["correct"], (port["checks"], f32["checks"])
    assert f32["program"] == "ReferenceStreams" and port["frame"] == [96, 128]


def test_added_cells_edit_no_file(added):
    _, before, after = added
    assert {k: v for k, v in after.items() if k in before} == before
    assert "drivers/streams_renamed.py" in after
