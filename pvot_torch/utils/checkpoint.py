"""Tracker checkpoint / resume (pvot/utils/checkpoint.py), in the same .npz
format and FORMAT_VERSION, so a state saved by either package resumes in the
other.

The whole carry {bbox, adaptive template, stats, lost counter, global flag}
round-trips through the file, single-stream or stacked (leading S axis), so
a live stream can stop and resume mid-video with the same trajectory.
"""

from __future__ import annotations

import os

import numpy as np

from pvot_torch.convert import state_from_numpy, state_to_numpy
from pvot_torch.tracker.state import TrackerState

_FIELDS = TrackerState._fields
FORMAT_VERSION = 1


def normalize_path(path: str) -> str:
    """np.savez silently appends '.npz' to suffix-less paths; normalize up
    front so the name we save, report, and later load all agree."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: TrackerState) -> str:
    """Serialize a TrackerState (single or stacked) to an .npz file.

    Returns the (normalized) path actually written."""
    path = normalize_path(path)
    np.savez(path, __version__=FORMAT_VERSION, **state_to_numpy(state))
    return path


def load_state(path: str, device=None) -> TrackerState:
    """Load a TrackerState saved by save_state (of either package) onto
    `device` (default: the current CUDA device)."""
    if not os.path.exists(path):
        path = normalize_path(path)
    with np.load(path) as data:
        version = int(data["__version__"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        return state_from_numpy({name: data[name] for name in _FIELDS}, device)
