"""The harness finds everything by name, from data alone, and BENCHMARK.json
keeps to the benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from pvbench import harness
from pvbench.tests.conftest import BENCH, CELLS, digest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pvbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(x["name"] for x in BENCH["workloads"])) == len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pvbench/") and os.path.isfile(harness.ROOT / c["file"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.config["name"] == c.entry["config"]
    harness.load_module("drivers", c.mix["driver"]).Driver
    for trace in (False, True):
        entries = harness.metric_entries(BENCH, cell, trace)
        assert entries
        for m in entries:
            reader = harness.load_module("metrics", m["name"])
            assert reader.UNIT == m["unit"]
            assert getattr(reader, "LAYER", None) == m.get("layer")
            assert getattr(reader, "MOVES", None) == m.get("moves")


def test_new_cell_config_and_metric_are_new_files(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new files
    and BENCHMARK.json entries run through the harness with no file of the
    benchmark edited."""
    shutil.copytree(harness.HERE, tmp_path / "pvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "pvbench")
    bench = json.loads(json.dumps(BENCH))
    config = harness.load_json(harness.HERE / "configs" / "uav123-720p-t80-r60.json")
    config.update(name="tiny-96p-t16-r8", frame=[96, 128], template=[16, 16])
    config["tracker"].update(search_radius_x=8, search_radius_y=8)
    mix = dict(harness.load_json(harness.HERE / "traffic" / "streams16_ondevice_seg64.json"),
               streams=2, period=32, segment=8, phase_step=16, amplitude_px=[10, 5])
    files = {
        "configs/tiny-96p-t16-r8.json": config,
        "traffic/streams2_tiny.json": mix,
        "workloads/tiny-streams.json": {
            "config": "tiny-96p-t16-r8", "traffic": "streams2_tiny", "check": {"units": 3},
            "limits": {"missing": 0, "off_truth": 0, "records_differ": 0,
                       "state_differ": 0, "score_gap": 1e-4}},
    }
    for rel, data in files.items():
        (tmp_path / "pvbench" / rel).write_text(json.dumps(data))
    (tmp_path / "pvbench" / "metrics" / "frames_done.py").write_text(textwrap.dedent('''
        UNIT = "frames"

        def read(run):
            return run.tracker_frames
    '''))
    bench["configs"].append({"name": "tiny-96p-t16-r8", "source": "a test", "reduced": [],
                             "file": "pvbench/configs/tiny-96p-t16-r8.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-streams", "config": "tiny-96p-t16-r8",
                               "traffic": "streams2_tiny", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-streams"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent('''
        import json, time, torch
        from pvbench import harness
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        cell = harness.load_cell("tiny-streams", bench)
        r = harness.run_cell(cell, bench, 77, 0.5, False, torch.device("cpu"),
                             time.perf_counter(), out=lambda s: None)
        print(json.dumps({"correct": r["correct"], "metrics": sorted(r["metrics"])}))
    ''')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(harness.ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"] == ["frames_done", "result_latency_p95_ms", "setup_s", "track_fps"]
    after = digest(tmp_path / "pvbench")
    assert {k: v for k, v in after.items() if k in before} == before
