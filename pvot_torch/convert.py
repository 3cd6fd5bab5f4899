"""Tracker state to and from dicts of numpy arrays.

The state is the whole of what carries across frames (there are no learned
weights): bbox, template, cached template stats, lost counter and the
sticky global flag.  A JAX TrackerState converts with
`{k: np.asarray(v) for k, v in jax_state._asdict().items()}`, so both
packages can start from bit-identical state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pvot_torch.tracker.state import TrackerState

_DTYPES = {
    "bbox_x": torch.int32, "bbox_y": torch.int32, "bbox_w": torch.int32,
    "bbox_h": torch.int32, "template": torch.float32, "t_mean": torch.float32,
    "t_std": torch.float32, "lost_count": torch.int32, "use_global": torch.bool,
}


def state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> TrackerState:
    """Dict of numpy arrays (TrackerState field names) -> TrackerState on
    `device`; values keep their bits (ints and bools convert exactly)."""
    return TrackerState(
        **{
            k: torch.as_tensor(np.array(d[k]), device=device).to(dt)
            for k, dt in _DTYPES.items()
        }
    )


def state_to_numpy(state: TrackerState) -> Dict[str, np.ndarray]:
    """TrackerState -> dict of host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
