"""pvot_torch imports without JAX, and its copies of pvot's numpy-only code
(TrackerConfig, the synthetic clip generator) stay equal to the originals."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import pvot.config
import pvot.io.synthetic as jsyn
import pvot_torch.config
import pvot_torch.io.synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import pvot_torch
names = [m.name for m in pkgutil.walk_packages(pvot_torch.__path__, "pvot_torch.")]
for name in names:
    importlib.import_module(name)
from pvot_torch.ops import _build
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "pvot" or m.startswith("pvot."))
print(json.dumps({"n": len(names), "bad": bad, "unbuilt": _build._lib is None}))
"""


def test_port_imports_without_jax_or_pvot():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] >= 12  # every module of the package was imported
    assert got["bad"] == [], f"pvot_torch pulled in {got['bad']}"
    assert got["unbuilt"], "importing pvot_torch loaded the kernel library"


def test_tracker_config_matches_pvot():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(pvot_torch.config.TrackerConfig) == fields(pvot.config.TrackerConfig)
    assert dataclasses.asdict(pvot_torch.config.WINDOWS_TREE_CONFIG) == dataclasses.asdict(
        pvot.config.WINDOWS_TREE_CONFIG
    )
    cfg = pvot_torch.config.TrackerConfig(template_update_lr=2.0)
    with pytest.raises(ValueError):
        cfg.validate()


SPECS = {
    "plain": dict(width=96, height=64, num_frames=9, target_w=16, target_h=12, seed=4),
    "exit_and_reenter": dict(width=96, height=64, num_frames=12, target_w=16,
                             target_h=16, seed=5, exit_and_reenter=True,
                             background_scroll=1.5),
    "occlusion": dict(width=80, height=60, num_frames=14, target_w=12, target_h=12,
                      seed=6, occlusion_period=5, occlusion_len=2, occlusion_phase=1,
                      noise_std=0.0),
}


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_synthetic_clip_byte_equal(kind):
    kw = SPECS[kind]
    want_spec, got_spec = jsyn.SyntheticSpec(**kw), tsyn.SyntheticSpec(**kw)
    want = jsyn.generate_gray_video(want_spec)
    got = tsyn.generate_gray_video(got_spec)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    for i in range(kw["num_frames"]):
        assert tsyn.target_bbox(got_spec, i) == jsyn.target_bbox(want_spec, i)
    bgr = next(tsyn.generate_bgr_frames(got_spec))
    assert bgr.tobytes() == next(jsyn.generate_bgr_frames(want_spec)).tobytes()
