"""What the benchmark imports: no JAX, no JAX package, and a reference that
imports nothing of the port."""

import json
import subprocess
import sys
import textwrap

from pvbench import harness

BAD = ("jax", "jaxlib", "flax", "pvot")


def _modules(code: str) -> list:
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_harness_and_drivers_import_no_jax():
    mods = _modules('''
        import json, sys
        import torch
        import pvbench.run, pvbench.control, pvbench.check, pvbench.harness
        from pvbench import harness
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        for w in bench["workloads"]:
            cell = harness.load_cell(w["name"], bench)
            drv = harness.load_module("drivers", cell.mix["driver"])
            drv.Driver(cell, torch.device("cpu"), 1)  # builds the port's program
        for m in bench["end_to_end"] + bench["per_layer"]:
            harness.load_module("metrics", m["name"])
        import pvot_torch.io.serving, pvot_torch.tracker.mega
        print(json.dumps(sorted(sys.modules)))
    ''')
    assert "pvot_torch.tracker.mega" in mods
    assert not [m for m in mods if m.split(".")[0] in BAD]


def test_reference_imports_nothing_of_the_port():
    mods = _modules('''
        import json, sys
        import pvbench.reference.tracker, pvbench.reference.programs, pvbench.check
        import pvbench.roofline, pvbench.traffic.scene
        print(json.dumps(sorted(sys.modules)))
    ''')
    assert not [m for m in mods if m.split(".")[0] in BAD + ("pvot_torch",)]


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    """No result line without a CUDA device; and in a directory that holds
    only BENCHMARK.json and the benchmark's files, none either."""
    import shutil

    res = subprocess.run([sys.executable, "-m", "pvbench.run", "--workload",
                          "streams16-720p-ondevice", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    if res.returncode == 0:  # a card here: the run printed its result
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] in (True, False)
    else:
        assert res.stdout.strip() == ""
    shutil.copytree(harness.HERE, tmp_path / "pvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "-m", "pvbench.run", "--workload",
                          "objects8-1080p-serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "correct" not in res.stdout
